// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, as in the reference, so no output is summed across blocks and
// the gradients are deterministic.
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/attention.py:
//   K2 (dK, dV) <- _flash_bwd_dkv_kernel: flash_bwd_dkv_mma_kernel for
//                  bfloat16, flash_bwd_dkv_kernel for float32
//   K3 (dQ)     <- _flash_bwd_dq_kernel:  flash_bwd_dq_mma_kernel for
//                  bfloat16, flash_bwd_dq_kernel for float32
// Both recompute, tile by tile, the forward's scores from the residuals
// (q, k, v, lse) and take di = rowsum(dO * O) - dlse from the caller:
//   s  = (q . k) * scale                     f32, rounded
//   p  = exp(s - lse), 0 where masked         f32
//   dp = dO . v                              f32
//   ds = p * (dp - di) * scale, rounded to q's dtype
//   dV += p (rounded to dO's dtype)^T . dO,  dK += ds^T . q,  dQ += ds . k
// with every product summed in f32, as the reference's dot_generals with
// preferred_element_type=f32.  Masked and ragged (row >= Sq, key >= Sk)
// entries get p = 0, hence ds = 0.
//
// What bounds them on this card: at the training shape (causal bf16
// [16, 12, 512, 512, 64]) K2 does 8 d FLOPs and K3 6 d FLOPs per unmasked
// (q, k) pair, about 170 and 150 FLOPs per byte of q/k/v/dO/lse/di/outputs,
// below the H100's ~295 FLOPs/byte bf16 ridge, so the ideal kernels are
// memory-bound.
//
// K2 in bfloat16 (the model's dtype) runs on the tensor cores (mma.sync
// m16n8k16, bf16 inputs, f32 sums): one block of 4 warps per 64-key tile,
// each warp owning 16 keys, looping over the q tiles from the first the
// causal mask lets through.  It computes the scores transposed, keys as
// the M dimension: S^T = K Q^T and dP^T = V dO^T, so their f32
// accumulators, once p and ds are formed and rounded, are already the A
// fragments of dV += P^T dO and dK += dS^T Q; P and dS never touch shared
// memory.  K and V are copied once (16-byte cp.async) and stay in shared
// memory, each warp reading its keys' A fragments with ldmatrix for each
// q tile (registers hold the dK and dV accumulators).  Q and dO
// stream as bf16 through a two-stage cp.async ring (tile i + 1 in flight
// while tile i computes), rows padded by 8 elements for conflict-free
// ldmatrix, with lse and di beside them; a thread reads those by its
// fragment's query index.  dK and dV leave through shared memory as
// 16-byte stores.  The tensor cores sum s and dp in their own order; an
// entry whose p or |ds| is at least 2^-3 (rare) takes them again as an
// in-order f32 chain, the plain version's order, so that its bf16
// rounding, which one ulp of moves dK or dV by more than an output ulp,
// is the plain version's (REDO_MIN).
//
// K3 in bfloat16 is the same design turned around, FlashAttention-2's
// dQ pass: one block of 4 warps per 64-row q tile, each warp owning 16
// query rows, looping over the key tiles up to the causal diagonal.  Q
// and dO are copied once and stay in shared memory, each warp reading
// its rows' A fragments with ldmatrix for each key tile (the registers
// they would hold buy a third block per SM at D <= 64); K and V stream
// through the two-stage cp.async ring.  S = Q K^T and dP = dO V^T
// come out with queries as M, so once ds is formed (and its large
// entries re-formed as in K2) two n8 tiles of it, rounded to bf16, are
// one k16 A fragment of dQ += dS K, with K read by ldmatrix.trans.  dQ
// is summed in f32 registers over the key tiles in order (no atomics)
// and leaves through shared memory as 16-byte stores.
//
// In float32 both run their products on the CUDA cores in f32 FMA: each
// block reads its fixed tile (K2: K, V; K3: Q, dO) once and streams the
// other side through shared memory as f32; the causal loop starts (K2)
// or stops (K3) at the diagonal.  f32 stays off the tensor cores: the
// card has no full-precision f32 product there, and TF32 would not hold
// the plain version's limits.
//
// Layout: q/dO [B, H, Sq, D], k/v [B, H, Sk, D], contiguous, one dtype
// (bf16: 16-byte aligned); lse/di [B, H, Sq] f32; dq like q, dk/dv like
// k.  K2: grid (ceil(Sk / 64), H, B); K3: grid (ceil(Sq / 64), H, B);
// 128 threads (bf16) or 256 (f32, four per row of a 64-row tile).  Any
// Sq, Sk >= 1; q_offset >= 0 is the global position of q's row 0 in the
// causal mask; D a multiple of 16 up to 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // four per tile row
constexpr int NS = BK / 4;    // scores per thread per tile row
// padded row strides (floats): 16-byte rows for float4 access, and the
// eight rows a warp reads at once land on distinct banks
constexpr int KS = BK + 4;    // K^T, V^T rows
constexpr int PS = BK + 16;   // K2's P and dS rows (float4 writes)
constexpr int SS = BK + 4;    // K3's dS rows (column reads)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// x rounded to T and back, as the reference's astype before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Stage rows [r0, r0 + 64) of a [S, D] matrix as f32 into dst[64][stride]
// (rows past S are 0).
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const T* src, int r0, int S) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int rr = i / D, c = i % D;
    const int gi = r0 + rr;
    dst[rr * stride + c] = gi < S ? to_f32(src[(size_t)gi * D + c]) : 0.f;
  }
}

// Stage keys [k0, k0 + 64) of k and v transposed as f32: Kt/Vt [D][KS]
// (keys past Sk are 0).
template <typename T, int D>
__device__ __forceinline__ void load_kv_t(float* Kt, float* Vt, const T* kb,
                                          const T* vb, int k0, int Sk) {
  for (int i = threadIdx.x; i < BK * D; i += THREADS) {
    const int j = i / D, c = i % D;
    const int kj = k0 + j;
    float kx = 0.f, vx = 0.f;
    if (kj < Sk) {
      kx = to_f32(kb[(size_t)kj * D + c]);
      vx = to_f32(vb[(size_t)kj * D + c]);
    }
    Kt[c * KS + j] = kx;
    Vt[c * KS + j] = vx;
  }
}

// The recomputation shared by both kernels.  Thread (r, qtr) takes q row r
// of the tile and the 16 keys j = 16 c + 4 qtr + e (c, e in 0..3) of the
// key tile, so the four threads of a row read one contiguous 64-byte span
// of K^T / V^T.  Returns p (f32, 0 where masked) and ds (f32, before its
// rounding) for those 16 entries.
template <int D>
__device__ __forceinline__ void p_and_ds(
    const float* Qs, const float* Os, int qstride, const float* Kt,
    const float* Vt, float lse, float di, int r, int qtr, int qi, int Sq,
    int k0, int Sk, int causal, int q_offset, float scale, float (&p)[NS],
    float (&ds)[NS]) {
  float s[NS], dp[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n] = dp[n] = 0.f;
  const float* qr = Qs + r * qstride;
  const float* orow = Os + r * qstride;
  for (int d = 0; d < D; ++d) {
    const float qv = qr[d], ov = orow[d];
    const float4* kr = reinterpret_cast<const float4*>(Kt + d * KS + 4 * qtr);
    const float4* vr = reinterpret_cast<const float4*>(Vt + d * KS + 4 * qtr);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 kx = kr[4 * c];  // keys 16 c + 4 qtr + (0..3)
      const float4 vx = vr[4 * c];
      s[4 * c + 0] = fmaf(qv, kx.x, s[4 * c + 0]);
      s[4 * c + 1] = fmaf(qv, kx.y, s[4 * c + 1]);
      s[4 * c + 2] = fmaf(qv, kx.z, s[4 * c + 2]);
      s[4 * c + 3] = fmaf(qv, kx.w, s[4 * c + 3]);
      dp[4 * c + 0] = fmaf(ov, vx.x, dp[4 * c + 0]);
      dp[4 * c + 1] = fmaf(ov, vx.y, dp[4 * c + 1]);
      dp[4 * c + 2] = fmaf(ov, vx.z, dp[4 * c + 2]);
      dp[4 * c + 3] = fmaf(ov, vx.w, dp[4 * c + 3]);
    }
  }
  const int gpos = q_offset + qi;  // the row's position in the mask
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int col = k0 + 16 * (n / 4) + 4 * qtr + (n % 4);
    const bool keep = qi < Sq && col < Sk && (!causal || gpos >= col);
    // s is rounded before lse is taken off (no fused multiply-add), as
    // the reference computes s = dot * scale, then exp(s - lse)
    p[n] = keep ? expf(__fmul_rn(s[n], scale) - lse) : 0.f;
    ds[n] = p[n] * (dp[n] - di) * scale;
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (2 * D * KS + 2 * BQ * (D + 4) + 2 * BQ * PS + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (2 * BQ * (D + 4) + 2 * D * KS + BK * D + BQ * SS + 2 * BQ);
}

// K2 in float32: dK, dV for one 64-key tile, summed over the q tiles that
// reach it.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int causal,
                     int q_offset, float scale) {
  constexpr int QS = D + 4;
  constexpr int NC = D / 16;  // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;            // [D][KS]
  float* Vt = Kt + D * KS;     // [D][KS]
  float* Qs = Vt + D * KS;     // [BQ][QS]
  float* Os = Qs + BQ * QS;    // [BQ][QS]  dO
  float* Ps = Os + BQ * QS;    // [BQ][PS]  p rounded to dO's dtype
  float* Ss = Ps + BQ * PS;    // [BQ][PS]  ds rounded to q's dtype
  float* Ls = Ss + BQ * PS;    // [BQ]      lse
  float* Ds = Ls + BQ;         // [BQ]      di

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int qtr = tid & 3;
  const int k0 = blockIdx.x * BK;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const T* qb = q + bh * (size_t)Sq * D;
  const T* ob = dout + bh * (size_t)Sq * D;
  const float* lb = lse + bh * (size_t)Sq;
  const float* db = di + bh * (size_t)Sq;

  load_kv_t<T, D>(Kt, Vt, k + bh * (size_t)Sk * D, v + bh * (size_t)Sk * D,
                  k0, Sk);

  // accumulator of key row r, columns 16 c + 4 qtr + e
  float acc_k[4 * NC], acc_v[4 * NC];
#pragma unroll
  for (int n = 0; n < 4 * NC; ++n) acc_k[n] = acc_v[n] = 0.f;

  // causal: q tiles before the one holding row max(0, k0 - q_offset) see
  // none of these keys (the reference's `run` condition)
  const int qstart = causal ? (max(0, k0 - q_offset) / BQ) * BQ : 0;
  for (int q0 = qstart; q0 < Sq; q0 += BQ) {
    __syncthreads();  // the previous tile's Q, dO, P, dS are no longer read
    load_rows<T, D>(Qs, QS, qb, q0, Sq);
    load_rows<T, D>(Os, QS, ob, q0, Sq);
    if (tid < BQ) {
      const int qi = q0 + tid;
      Ls[tid] = qi < Sq ? lb[qi] : 0.f;
      Ds[tid] = qi < Sq ? db[qi] : 0.f;
    }
    __syncthreads();

    // scores: thread (r, qtr) takes q row r
    float p[NS], ds[NS];
    p_and_ds<D>(Qs, Os, QS, Kt, Vt, Ls[r], Ds[r], r, qtr, q0 + r, Sq, k0,
                Sk, causal, q_offset, scale, p, ds);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int off = r * PS + 16 * c + 4 * qtr;
      *reinterpret_cast<float4*>(Ps + off) =
          make_float4(round_to<T>(p[4 * c]), round_to<T>(p[4 * c + 1]),
                      round_to<T>(p[4 * c + 2]), round_to<T>(p[4 * c + 3]));
      *reinterpret_cast<float4*>(Ss + off) =
          make_float4(round_to<T>(ds[4 * c]), round_to<T>(ds[4 * c + 1]),
                      round_to<T>(ds[4 * c + 2]), round_to<T>(ds[4 * c + 3]));
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q: thread (r, qtr) takes key row r
    for (int i = 0; i < BQ; ++i) {
      const float pv = Ps[i * PS + r];
      const float sv = Ss[i * PS + r];
      const float4* o4 = reinterpret_cast<const float4*>(Os + i * QS + 4 * qtr);
      const float4* q4 = reinterpret_cast<const float4*>(Qs + i * QS + 4 * qtr);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 ox = o4[4 * c];  // columns 16 c + 4 qtr + (0..3)
        const float4 qx = q4[4 * c];
        acc_v[4 * c + 0] = fmaf(pv, ox.x, acc_v[4 * c + 0]);
        acc_v[4 * c + 1] = fmaf(pv, ox.y, acc_v[4 * c + 1]);
        acc_v[4 * c + 2] = fmaf(pv, ox.z, acc_v[4 * c + 2]);
        acc_v[4 * c + 3] = fmaf(pv, ox.w, acc_v[4 * c + 3]);
        acc_k[4 * c + 0] = fmaf(sv, qx.x, acc_k[4 * c + 0]);
        acc_k[4 * c + 1] = fmaf(sv, qx.y, acc_k[4 * c + 1]);
        acc_k[4 * c + 2] = fmaf(sv, qx.z, acc_k[4 * c + 2]);
        acc_k[4 * c + 3] = fmaf(sv, qx.w, acc_k[4 * c + 3]);
      }
    }
  }

  const int kj = k0 + r;
  if (kj < Sk) {
    T* dkr = dk + (bh * (size_t)Sk + kj) * D;
    T* dvr = dv + (bh * (size_t)Sk + kj) * D;
#pragma unroll
    for (int n = 0; n < 4 * NC; ++n) {
      const int col = 16 * (n / 4) + 4 * qtr + (n % 4);
      dkr[col] = from_f32<T>(acc_k[n]);
      dvr[col] = from_f32<T>(acc_v[n]);
    }
  }
}

// K3 in float32: dQ for one 64-row q tile, summed over the key tiles it
// reaches.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int Sq,
                    int Sk, int causal, int q_offset, float scale) {
  constexpr int QS = D + 4;
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [BQ][QS]
  float* Os = Qs + BQ * QS;    // [BQ][QS]  dO
  float* Kt = Os + BQ * QS;    // [D][KS]
  float* Vt = Kt + D * KS;     // [D][KS]
  float* Ks = Vt + D * KS;     // [BK][D]   K rows, for dS . K
  float* Ss = Ks + BK * D;     // [BQ][SS]  ds rounded to q's dtype
  float* Ls = Ss + BQ * SS;    // [BQ]
  float* Ds = Ls + BQ;         // [BQ]

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int qtr = tid & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const T* kb = k + bh * (size_t)Sk * D;
  const T* vb = v + bh * (size_t)Sk * D;

  load_rows<T, D>(Qs, QS, q + bh * (size_t)Sq * D, q0, Sq);
  load_rows<T, D>(Os, QS, dout + bh * (size_t)Sq * D, q0, Sq);
  if (tid < BQ) {
    const int qi = q0 + tid;
    Ls[tid] = qi < Sq ? lse[bh * (size_t)Sq + qi] : 0.f;
    Ds[tid] = qi < Sq ? di[bh * (size_t)Sq + qi] : 0.f;
  }

  // accumulator of q row r, columns 16 c + 4 qtr + e
  float acc[4 * NC];
#pragma unroll
  for (int n = 0; n < 4 * NC; ++n) acc[n] = 0.f;

  // causal: keys past the tile's last row are masked for every row
  const int kend = causal ? min(Sk, q_offset + q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K, V, dS are no longer read
    load_kv_t<T, D>(Kt, Vt, kb, vb, k0, Sk);
    load_rows<T, D>(Ks, D, kb, k0, Sk);
    __syncthreads();

    float p[NS], ds[NS];
    p_and_ds<D>(Qs, Os, QS, Kt, Vt, Ls[r], Ds[r], r, qtr, q0 + r, Sq, k0,
                Sk, causal, q_offset, scale, p, ds);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Ss + r * SS + 16 * c + 4 * qtr) =
          make_float4(round_to<T>(ds[4 * c]), round_to<T>(ds[4 * c + 1]),
                      round_to<T>(ds[4 * c + 2]), round_to<T>(ds[4 * c + 3]));
    __syncwarp();  // row r's dS was written by this thread's warp

    // dQ += dS K: thread (r, qtr) keeps q row r
    const float* srow = Ss + r * SS;
    for (int j = 0; j < BK; ++j) {
      const float sv = srow[j];
      const float4* k4 = reinterpret_cast<const float4*>(Ks + j * D + 4 * qtr);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kx = k4[4 * c];
        acc[4 * c + 0] = fmaf(sv, kx.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(sv, kx.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(sv, kx.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(sv, kx.w, acc[4 * c + 3]);
      }
    }
  }

  const int qi = q0 + r;
  if (qi < Sq) {
    T* dqr = dq + (bh * (size_t)Sq + qi) * D;
#pragma unroll
    for (int n = 0; n < 4 * NC; ++n)
      dqr[16 * (n / 4) + 4 * qtr + (n % 4)] = from_f32<T>(acc[n]);
  }
}

// --- K2 in bfloat16: tensor cores ---------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps, 16 keys each
// p and |ds| at or above this are formed again from s and dp summed in
// the plain version's order.  The tensor cores sum in another order, so
// an f32 p or ds near a bf16 rounding boundary can round the other way
// than the plain version's; one bf16 ulp of it, times |dO| or |q|, then
// moves dV or dK.  Below 2^-3 that ulp is at most 2^-11, a move under an
// output's 4e-3 floor for |dO|, |q| < 8; above it, it can exceed an
// output's own ulp.
constexpr float REDO_MIN = 0.125f;

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // K, V, Q x 2, dO x 2 as bf16 [64][D + 8]; lse, di x 2 as f32 [64]
  return sizeof(tc::bf16) * 6 * 64 * (D + 8) + sizeof(float) * 4 * BQ;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const tc::bf16* __restrict__ q,
                         const tc::bf16* __restrict__ k,
                         const tc::bf16* __restrict__ v,
                         const tc::bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         tc::bf16* __restrict__ dk, tc::bf16* __restrict__ dv,
                         int Sq, int Sk, int causal, int q_offset,
                         float scale) {
  using tc::bf16;
  constexpr int RS = D + 8;        // padded row stride (elements)
  constexpr int KD = D / 16;       // k16 steps over D
  constexpr int ND = D / 8;        // n8 tiles over D
  constexpr int NQ = BQ / 8;       // n8 tiles of queries per q tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][RS]
  bf16* Vs = Ks + BK * RS;                       // [BK][RS]
  bf16* Qs = Vs + BK * RS;                       // [2][BQ][RS]
  bf16* Os = Qs + 2 * BQ * RS;                   // [2][BQ][RS]  dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * BQ * RS);  // [2][BQ]
  float* Ds = Ls + 2 * BQ;                                  // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const bf16* qb = q + bh * (size_t)Sq * D;
  const bf16* ob = dout + bh * (size_t)Sq * D;
  const float* lb = lse + bh * (size_t)Sq;
  const float* db = di + bh * (size_t)Sq;

  // q tile at q0 into ring stage st: Q, dO, and lse / di one f32 a thread
  auto load_q = [&](int st, int q0) {
    tc::load_tile<BQ, D, MMA_THREADS>(Qs + st * BQ * RS, qb, q0, Sq);
    tc::load_tile<BQ, D, MMA_THREADS>(Os + st * BQ * RS, ob, q0, Sq);
    const int r = tid & (BQ - 1), qi = q0 + r;
    tc::cp_async4((tid < BQ ? Ls : Ds) + st * BQ + r,
                  (tid < BQ ? lb : db) + min(qi, Sq - 1), qi < Sq ? 4 : 0);
  };

  tc::load_tile<BK, D, MMA_THREADS>(Ks, k + bh * (size_t)Sk * D, k0, Sk);
  tc::load_tile<BK, D, MMA_THREADS>(Vs, v + bh * (size_t)Sk * D, k0, Sk);
  // causal: q tiles before the one holding row max(0, k0 - q_offset) see
  // none of these keys (the reference's `run` condition)
  const int qstart = causal ? (max(0, k0 - q_offset) / BQ) * BQ : 0;
  const int nq = qstart < Sq ? (Sq - qstart + BQ - 1) / BQ : 0;
  if (nq > 0) load_q(0, qstart);
  tc::cp_async_commit();

  // this warp's 16 keys: rows of Ks / Vs read by no other warp
  const bf16* Kw = Ks + warp * 16 * RS;
  const bf16* Vw = Vs + warp * 16 * RS;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, +8
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = 0; i < nq; ++i) {
    const int st = i & 1, q0 = qstart + i * BQ;
    if (i + 1 < nq) {  // the next q tile loads while this one computes
      load_q(st ^ 1, q0 + BQ);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * BQ * RS;
    const bf16* Ot = Os + st * BQ * RS;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];  // this warp's keys, d 16 kk + (0..15)
      const int koff = (lane & 15) * RS + kk * 16 + (lane >> 4) * 8;
      tc::ldmatrix_x4(ka, Kw + koff);
      tc::ldmatrix_x4(va, Vw + koff);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        // queries 16 np + (0..7 | 8..15), d 16 kk + (0..7 | 8..15)
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        tc::ldmatrix_x4(b, Qt + off);
        tc::mma_bf16(s[2 * np], ka, b[0], b[1]);
        tc::mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
        tc::ldmatrix_x4(b, Ot + off);
        tc::mma_bf16(dp[2 * np], va, b[0], b[1]);
        tc::mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
      }
    }

    // p = exp(s - lse) (0 where masked), ds = p (dp - di) scale, in place
    const bool edge = q0 + BQ > Sq || k0 + BK > Sk ||
                      (causal && k0 + BK - 1 > q_offset + q0);
    uint32_t redo = 0;  // bit 4 n + e: entry (n, e) is formed again
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + 2 * t + (e & 1);  // query within the tile
        // s is rounded before lse is taken off (no fused multiply-add)
        float p = expf(__fmul_rn(s[n][e], scale) - Lt[qc]);
        if (edge) {
          const int qi = q0 + qc, key = key0 + (e >> 1) * 8;
          p = (qi < Sq && key < Sk && (!causal || q_offset + qi >= key))
                  ? p : 0.f;
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Dt[qc]) * scale;
        if (p >= REDO_MIN || fabsf(dp[n][e]) >= REDO_MIN)
          redo |= 1u << (4 * n + e);
      }
    }
    // Large p and ds are taken again from s and dp summed in the plain
    // version's order (see REDO_MIN).  Rare, so the warp branches only
    // when one of its lanes holds such an entry, and the recomputation is
    // one rolled loop over the set bits, its results merged after.
    if (__any_sync(0xffffffffu, redo)) {
      float redo_p[4 * NQ], redo_ds[4 * NQ];
      for (uint32_t bits = redo; bits; bits &= bits - 1) {
        const int i = __ffs(bits) - 1;
        const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
        const int kr = warp * 16 + g + ((i >> 1) & 1) * 8;
        float sc, dc;
        tc::dot_chains<D>(Qt + qc * RS, Ks + kr * RS, Ot + qc * RS,
                          Vs + kr * RS, sc, dc);
        redo_p[i] = expf(__fmul_rn(sc, scale) - Lt[qc]);
        redo_ds[i] = redo_p[i] * (dc - Dt[qc]) * scale;
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (redo >> (4 * n + e) & 1) {
            s[n][e] = redo_p[4 * n + e];
            dp[n][e] = redo_ds[4 * n + e];
          }
        }
      }
    }

    // dV += P^T dO, dK += dS^T Q, P and dS rounded to bf16 in registers
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
      uint32_t pa[4], sa[4];
      tc::c_to_a(pa, s[2 * c], s[2 * c + 1]);
      tc::c_to_a(sa, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        // queries 16 c + (0..15), d 16 dn + (0..7 | 8..15)
        const int off = (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                        dn * 16 + (lane >> 4) * 8;
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, Ot + off);
        tc::mma_bf16(dva[2 * dn], pa, b[0], b[1]);
        tc::mma_bf16(dva[2 * dn + 1], pa, b[2], b[3]);
        tc::ldmatrix_x4_trans(b, Qt + off);
        tc::mma_bf16(dka[2 * dn], sa, b[0], b[1]);
        tc::mma_bf16(dka[2 * dn + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // dK, dV through this warp's own rows of Ks / Vs (with no q tile the
  // K / V copies must land first); keys no row sees leave as zeros
  tc::cp_async_wait<0>();
  __syncthreads();
  bf16* dKw = Ks + warp * 16 * RS;
  bf16* dVw = Vs + warp * 16 * RS;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int lo = g * RS + 8 * n + 2 * t, hi = lo + 8 * RS;
    *reinterpret_cast<__nv_bfloat162*>(dKw + lo) =
        __floats2bfloat162_rn(dka[n][0], dka[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dKw + hi) =
        __floats2bfloat162_rn(dka[n][2], dka[n][3]);
    *reinterpret_cast<__nv_bfloat162*>(dVw + lo) =
        __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dVw + hi) =
        __floats2bfloat162_rn(dva[n][2], dva[n][3]);
  }
  __syncwarp();
  tc::store_rows16<D>(dk + bh * (size_t)Sk * D, dKw, k0 + warp * 16, Sk,
                      lane);
  tc::store_rows16<D>(dv + bh * (size_t)Sk * D, dVw, k0 + warp * 16, Sk,
                      lane);
}

// --- K3 in bfloat16: tensor cores ---------------------------------------

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q, dO, K x 2, V x 2 as bf16 [64][D + 8]; lse, di as f32 [64]
  return sizeof(tc::bf16) * 6 * 64 * (D + 8) + sizeof(float) * 2 * BQ;
}

// Three blocks per SM where D <= 64: at most 168 registers, so the main
// path's head dim runs 12 warps per SM instead of 8 and more of them
// hide each warp's ldmatrix / mma / expf latency (7-11% faster on the
// H100 than two blocks holding Q and dO fragments in registers).  From
// D = 80 on that cap spills, so those take the registers they need.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, (D <= 64 ? 3 : 1))
flash_bwd_dq_mma_kernel(const tc::bf16* __restrict__ q,
                        const tc::bf16* __restrict__ k,
                        const tc::bf16* __restrict__ v,
                        const tc::bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di,
                        tc::bf16* __restrict__ dq, int Sq, int Sk, int causal,
                        int q_offset, float scale) {
  using tc::bf16;
  constexpr int RS = D + 8;   // padded row stride (elements)
  constexpr int KD = D / 16;  // k16 steps over D
  constexpr int ND = D / 8;   // n8 tiles over D
  constexpr int NK = BK / 8;  // n8 tiles of keys per key tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][RS]
  bf16* Os = Qs + BQ * RS;                       // [BQ][RS]  dO
  bf16* Ks = Os + BQ * RS;                       // [2][BK][RS]
  bf16* Vs = Ks + 2 * BK * RS;                   // [2][BK][RS]
  float* Ls = reinterpret_cast<float*>(Vs + 2 * BK * RS);  // [BQ]
  float* Ds = Ls + BQ;                                      // [BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const bf16* kb = k + bh * (size_t)Sk * D;
  const bf16* vb = v + bh * (size_t)Sk * D;

  // causal: keys past the tile's last row are masked for every row
  const int kend = causal ? min(Sk, q_offset + q0 + BQ) : Sk;
  const int nk = (kend + BK - 1) / BK;

  // Q, dO, lse, di (one f32 a thread) and the first K / V tile
  tc::load_tile<BQ, D, MMA_THREADS>(Qs, q + bh * (size_t)Sq * D, q0, Sq);
  tc::load_tile<BQ, D, MMA_THREADS>(Os, dout + bh * (size_t)Sq * D, q0, Sq);
  {
    const int r = tid & (BQ - 1), qi = q0 + r;
    tc::cp_async4((tid < BQ ? Ls : Ds) + r,
                  (tid < BQ ? lse : di) + bh * (size_t)Sq + min(qi, Sq - 1),
                  qi < Sq ? 4 : 0);
  }
  tc::load_tile<BK, D, MMA_THREADS>(Ks, kb, 0, Sk);
  tc::load_tile<BK, D, MMA_THREADS>(Vs, vb, 0, Sk);
  tc::cp_async_commit();

  const int qr = warp * 16 + g;  // this thread's rows in the tile: qr, +8
  float lr[2], dr[2];  // lse and di of the two rows
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int st = j & 1, k0 = j * BK;
    if (j + 1 < nk) {  // the next key tile loads while this one computes
      tc::load_tile<BK, D, MMA_THREADS>(Ks + (st ^ 1) * BK * RS, kb, k0 + BK,
                                        Sk);
      tc::load_tile<BK, D, MMA_THREADS>(Vs + (st ^ 1) * BK * RS, vb, k0 + BK,
                                        Sk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      lr[0] = Ls[qr];
      lr[1] = Ls[qr + 8];
      dr[0] = Ds[qr];
      dr[1] = Ds[qr + 8];
    }
    const bf16* Kt = Ks + st * BK * RS;
    const bf16* Vt = Vs + st * BK * RS;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];  // this warp's rows of Q and dO, d 16 kk + ..
      const int aoff = (warp * 16 + (lane & 15)) * RS + kk * 16 +
                       (lane >> 4) * 8;
      tc::ldmatrix_x4(qa, Qs + aoff);
      tc::ldmatrix_x4(oa, Os + aoff);
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        // keys 16 np + (0..7 | 8..15), d 16 kk + (0..7 | 8..15)
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                        kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        tc::ldmatrix_x4(b, Kt + off);
        tc::mma_bf16(s[2 * np], qa, b[0], b[1]);
        tc::mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        tc::ldmatrix_x4(b, Vt + off);
        tc::mma_bf16(dp[2 * np], oa, b[0], b[1]);
        tc::mma_bf16(dp[2 * np + 1], oa, b[2], b[3]);
      }
    }

    // ds = p (dp - di) scale in place of dp, p = exp(s - lse) (0 where
    // masked); K2's test for the tiles that reach a mask or an edge
    const bool edge = q0 + BQ > Sq || k0 + BK > Sk ||
                      (causal && k0 + BK - 1 > q_offset + q0);
    uint32_t redo = 0;  // bit 4 n + e: entry (n, e) is formed again
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;  // row qr + 8 h
        // s is rounded before lse is taken off (no fused multiply-add)
        float p = expf(__fmul_rn(s[n][e], scale) - lr[h]);
        if (edge) {
          const int qi = q0 + qr + 8 * h, key = k0 + 8 * n + 2 * t + (e & 1);
          p = (qi < Sq && key < Sk && (!causal || q_offset + qi >= key))
                  ? p : 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dr[h]) * scale;
        if (p >= REDO_MIN || fabsf(dp[n][e]) >= REDO_MIN)
          redo |= 1u << (4 * n + e);
      }
    }
    // Large p and ds are taken again from s and dp summed in the plain
    // version's order (see REDO_MIN), by K2's rule, so dS rounds as the
    // plain version's where one ulp of it moves dQ by more than an output
    // ulp.  Rare: the warp branches only when one of its lanes holds such
    // an entry, and the recomputation is one rolled loop over the set
    // bits, its results merged after.
    if (__any_sync(0xffffffffu, redo)) {
      float redo_ds[4 * NK];
      for (uint32_t bits = redo; bits; bits &= bits - 1) {
        const int i = __ffs(bits) - 1;
        const int h = (i >> 1) & 1;
        const int qc = qr + 8 * h;
        const int kc = 8 * (i >> 2) + 2 * t + (i & 1);
        float sc, dc;
        tc::dot_chains<D>(Qs + qc * RS, Kt + kc * RS, Os + qc * RS,
                          Vt + kc * RS, sc, dc);
        const float l = h ? lr[1] : lr[0], d = h ? dr[1] : dr[0];
        const float p = expf(__fmul_rn(sc, scale) - l);
        redo_ds[i] = p * (dc - d) * scale;
      }
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (redo >> (4 * n + e) & 1) dp[n][e] = redo_ds[4 * n + e];
        }
      }
    }

    // dQ += dS K, dS rounded to bf16 in registers, K read transposed
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t sa[4];
      tc::c_to_a(sa, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
      for (int dn = 0; dn < ND / 2; ++dn) {
        // keys 16 c + (0..15), d 16 dn + (0..7 | 8..15)
        const int off = (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                        dn * 16 + (lane >> 4) * 8;
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, Kt + off);
        tc::mma_bf16(acc[2 * dn], sa, b[0], b[1]);
        tc::mma_bf16(acc[2 * dn + 1], sa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // dQ through this warp's own rows of Qs (read only by this warp)
  bf16* Qw = Qs + warp * 16 * RS;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Qw + g * RS + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(Qw + (g + 8) * RS + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  tc::store_rows16<D>(dq + bh * (size_t)Sq * D, Qw, q0 + warp * 16, Sq,
                      lane);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *di;
  void *g0, *g1;  // K2: dk, dv; K3: dq, unused
  int B, H, Sq, Sk, causal, q_offset;
  float scale;
  cudaStream_t stream;
};

// K2: the tensor-core kernel for bfloat16, the CUDA-core one for float32
template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  constexpr size_t smem = bf ? dkv_mma_smem_bytes<D>() : dkv_smem_bytes<D>();
  void (*kernel)(const T*, const T*, const T*, const T*, const float*,
                 const float*, T*, T*, int, int, int, int, float);
  if constexpr (bf) kernel = flash_bwd_dkv_mma_kernel<D>;
  else kernel = flash_bwd_dkv_kernel<T, D>;
  // set on every launch: the attribute is per device, and the caller
  // makes the inputs' device current (a host-side call of ~1 us)
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sk + BK - 1) / BK, a.H, a.B);
  kernel<<<grid, bf ? MMA_THREADS : THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.Sq, a.Sk, a.causal,
      a.q_offset, a.scale);
  return cudaGetLastError();
}

// K3: the tensor-core kernel for bfloat16, the CUDA-core one for float32
template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  constexpr size_t smem = bf ? dq_mma_smem_bytes<D>() : dq_smem_bytes<D>();
  void (*kernel)(const T*, const T*, const T*, const T*, const float*,
                 const float*, T*, int, int, int, int, float);
  if constexpr (bf) kernel = flash_bwd_dq_mma_kernel<D>;
  else kernel = flash_bwd_dq_kernel<T, D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, bf ? MMA_THREADS : THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di),
      static_cast<T*>(a.g0), a.Sq, a.Sk, a.causal, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, int D, const Args& a) {
#define RTT_CASE(d) \
  case d:           \
    return dkv ? launch_dkv<T, d>(a) : launch_dq<T, d>(a);
  switch (D) {
    RTT_CASE(16)
    RTT_CASE(32)
    RTT_CASE(48)
    RTT_CASE(64)
    RTT_CASE(80)
    RTT_CASE(96)
    RTT_CASE(112)
    RTT_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RTT_CASE
}

int run(bool dkv, int D, int dtype, const Args& a) {
  if (dtype == 0) return (int)dispatch<float>(dkv, D, a);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(dkv, D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Each returns the cudaError_t of its
// launch (0 on success).
int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dk, void* dv, int B, int H, int Sq, int Sk,
                      int D, int dtype, int causal, int q_offset,
                      float scale, void* stream) {
  const Args a{q, k, v, dout, lse, di, dk, dv, B, H, Sq, Sk, causal,
               q_offset, scale, static_cast<cudaStream_t>(stream)};
  return run(true, D, dtype, a);
}

int rtt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* di,
                     void* dq, int B, int H, int Sq, int Sk, int D,
                     int dtype, int causal, int q_offset, float scale,
                     void* stream) {
  const Args a{q, k, v, dout, lse, di, dq, nullptr, B, H, Sq, Sk, causal,
               q_offset, scale, static_cast<cudaStream_t>(stream)};
  return run(false, D, dtype, a);
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
