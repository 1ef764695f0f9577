// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/attention.py::_flash_kernel
// (launched by _flash_forward).  It computes the same function: for every
// (batch, head, query row) an online softmax over the keys, f32 running
// max / sum / accumulator, P rounded to the input dtype before P.V,
// masked scores set to DEFAULT_MASK_VALUE (-0.7 * FLT_MAX), l clamped at
// 1e-30, and optionally lse = m + log(max(l, 1e-30)) as [B, H, Sq] f32.
//
// What bounds it on this card: at the model's shapes (d = 64, S = 1024)
// causal bf16 attention does ~256 FLOPs per byte of q/k/v/o, below the
// H100's ~295 FLOPs/byte bf16 ridge, so the ideal kernel is memory-bound
// (non-causal, ~512 FLOPs/byte, is bound by the tensor cores).
//
// bfloat16 (the model's dtype): flash_fwd_mma_kernel, FlashAttention-2
// style on the tensor cores.  One block of 4 warps per 64 query rows,
// each warp owning 16 rows; both products are mma.sync m16n8k16 with bf16
// inputs and f32 sums, as the reference runs them on the MXU.
//   - Q is copied once to shared memory (16-byte cp.async) and held in
//     registers as A fragments (ldmatrix) for the whole key loop.
//   - K and V stay bf16 in a two-stage cp.async ring of 64-key tiles, so
//     tile j + 1 is in flight while tile j computes; rows are padded by 8
//     elements so ldmatrix reads are free of bank conflicts; rows past Sk
//     are zero-filled.  S = Q K^T reads K with ldmatrix, P V reads V with
//     ldmatrix.trans.
//   - The softmax runs on the accumulator fragments: a thread holds 16
//     scores of 2 rows; the row max and sum take two shuffles over the
//     quad that shares a row.  The reference's rounding points are kept:
//     s = acc * scale rounded, then max, alpha = exp(m - m_new),
//     p = exp(s - m_new) summed into l in f32, and only P V takes p
//     rounded to bf16.  P never leaves registers: two n8 tiles of S are
//     one k16 A fragment of P V.
//   - Causal blocks stop at the diagonal tile; only tiles that cross the
//     diagonal or the ragged Sk edge are masked.
//   - O = acc / max(l, 1e-30) goes out through shared memory as 16-byte
//     stores.
//
// float32 keeps flash_fwd_kernel on the CUDA cores (f32 FMA): the card
// has no full-precision f32 tensor-core product, and TF32 would not hold
// the f32 results to the plain version's summation-order limits.  Q/K/V
// are staged in shared memory, K transposed, two threads per query row.
//
// Layout: q [B, H, Sq, D], k/v [B, H, Sk, D], contiguous (bf16: 16-byte
// aligned); o like q.  Grid (ceil(Sq / 64), H, B), 128 threads.  Any
// Sq, Sk >= 1 (ragged edges are masked); D a multiple of 16 up to 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

#include "tc.cuh"

namespace {

using tc::bf16;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // f32: two per query row; bf16: 4 warps
// rounded from the double product, as DEFAULT_MASK_VALUE is in Python
constexpr float MASK_VALUE = (float)(-0.7 * 3.40282346638528859812e+38);

// --- bfloat16: tensor cores ---------------------------------------------

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (BQ + 4 * BK) * (D + 8);  // Q, K x 2, V x 2
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int causal,
                     int q_offset, float scale) {
  constexpr int RS = D + 8;   // padded row stride (elements)
  constexpr int KD = D / 16;  // k16 steps over D
  constexpr int ND = D / 8;   // n8 tiles over D
  constexpr int NS = BK / 8;  // n8 tiles of scores per key tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][RS]
  bf16* Ks = Qs + BQ * RS;                       // [2][BK][RS]
  bf16* Vs = Ks + 2 * BK * RS;                   // [2][BK][RS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const bf16* qb = q + bh * (size_t)Sq * D;
  const bf16* kb = k + bh * (size_t)Sk * D;
  const bf16* vb = v + bh * (size_t)Sk * D;

  // keys past the block's last row are masked for every row: skip them
  const int kend = causal ? min(Sk, q_offset + q0 + BQ) : Sk;
  const int ntiles = (kend + BK - 1) / BK;

  tc::load_tile<BQ, D, THREADS>(Qs, qb, q0, Sq);
  tc::load_tile<BK, D, THREADS>(Ks, kb, 0, Sk);
  tc::load_tile<BK, D, THREADS>(Vs, vb, 0, Sk);
  tc::cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, +8
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {  // the next tile loads while this one computes
      tc::load_tile<BK, D, THREADS>(Ks + (st ^ 1) * BK * RS, kb,
                                    (j + 1) * BK, Sk);
      tc::load_tile<BK, D, THREADS>(Vs + (st ^ 1) * BK * RS, vb,
                                    (j + 1) * BK, Sk);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        tc::ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * RS +
                                    kk * 16 + (lane >> 4) * 8);
    }
    const bf16* Kt = Ks + st * BK * RS;
    const bf16* Vt = Vs + st * BK * RS;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];  // keys 16 np + (0..7 | 8..15), d 16 kk + (0..7 | 8..15)
        tc::ldmatrix_x4(b, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                    RS + kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // s = dot * scale (rounded, as the reference), masked where needed
    const int k0 = j * BK;
    const bool edge =
        k0 + BK > Sk || (causal && k0 + BK - 1 > q_offset + q0);
    float mx[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[n][e], scale);
        if (edge) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const int grow = q_offset + row0 + (e >> 1) * 8;
          x = (col < Sk && (!causal || grow >= col)) ? x : MASK_VALUE;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        psum[e >> 1] += p;  // l sums p in f32, before its rounding
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = __fadd_rn(__fmul_rn(alpha[r], l[r]), psum[r]);
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V, P rounded to bf16 straight from the S fragments
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t pa[4];
      tc::c_to_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];  // keys 16 c + (0..15), d 16 dp + (0..7 | 8..15)
        tc::ldmatrix_x4_trans(
            b, Vt + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS +
                   dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        tc::mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // O through this warp's own rows of Qs (read only by this warp)
  const float lc[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  bf16* Ow = Qs + warp * 16 * RS;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(Ow + g * RS + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][0] / lc[0], acc[n][1] / lc[0]);
    *reinterpret_cast<__nv_bfloat162*>(Ow + (g + 8) * RS + 8 * n + 2 * t) =
        __floats2bfloat162_rn(acc[n][2] / lc[1], acc[n][3] / lc[1]);
  }
  __syncwarp();
  tc::store_rows16<D>(o + bh * (size_t)Sq * D, Ow, q0 + warp * 16, Sq, lane);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < Sq)
        lse[bh * (size_t)Sq + row0 + 8 * r] = m[r] + logf(lc[r]);
  }
}

// --- float32: CUDA cores ------------------------------------------------

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + D * (BK + 4) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int causal,
                 int q_offset, float scale) {
  constexpr int QS = D + 1;   // padded strides: no bank conflicts on
  constexpr int KS = BK + 4;  // the per-row reads, 16-byte rows for K^T
  constexpr int PS = BK + 1;
  constexpr int DH = D / 2;   // accumulator columns per thread
  constexpr int SC = BK / 2;  // scores per thread per tile

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;             // [BQ][QS]
  float* Kt = Qs + BQ * QS;     // [D][KS]  (K transposed)
  float* Vs = Kt + D * KS;      // [BK][D]
  float* Ps = Vs + BK * D;      // [BQ][PS]

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const float* qb = q + bh * (size_t)Sq * D;
  const float* kb = k + bh * (size_t)Sk * D;
  const float* vb = v + bh * (size_t)Sk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, cc = i % D;
    const int qi = q0 + rr;
    Qs[rr * QS + cc] = qi < Sq ? qb[(size_t)qi * D + cc] : 0.f;
  }

  const int row = q0 + r;
  const int grow = q_offset + row;  // the row's position in the mask
  // keys past the tile's last row are masked for every row: skip them
  const int kend = causal ? min(Sk, q_offset + q0 + BQ) : Sk;

  float m = MASK_VALUE, l = 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K^T / V are no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, cc = i % D;
      const int kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < Sk) {
        kx = kb[(size_t)kj * D + cc];
        vx = vb[(size_t)kj * D + cc];
      }
      Kt[cc * KS + j] = kx;
      Vs[j * D + cc] = vx;
    }
    __syncthreads();

    // scores s = (q . k) * scale for this thread's 32 keys
    float s[SC];
#pragma unroll
    for (int c = 0; c < SC; ++c) s[c] = 0.f;
    const float* qr = Qs + r * QS;
    for (int kk = 0; kk < D; ++kk) {
      const float qv = qr[kk];
      const float4* kr =
          reinterpret_cast<const float4*>(Kt + kk * KS + half * SC);
#pragma unroll
      for (int c4 = 0; c4 < SC / 4; ++c4) {
        const float4 kx = kr[c4];
        s[4 * c4 + 0] = fmaf(qv, kx.x, s[4 * c4 + 0]);
        s[4 * c4 + 1] = fmaf(qv, kx.y, s[4 * c4 + 1]);
        s[4 * c4 + 2] = fmaf(qv, kx.z, s[4 * c4 + 2]);
        s[4 * c4 + 3] = fmaf(qv, kx.w, s[4 * c4 + 3]);
      }
    }

    float mcur = MASK_VALUE;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int col = k0 + half * SC + c;
      const bool keep = col < Sk && (!causal || grow >= col);
      s[c] = keep ? s[c] * scale : MASK_VALUE;
      mcur = fmaxf(mcur, s[c]);
    }
    mcur = fmaxf(mcur, __shfl_xor_sync(0xffffffffu, mcur, 1));
    const float mnew = fmaxf(m, mcur);
    const float alpha = expf(m - mnew);
    float psum = 0.f;
    float* pr = Ps + r * PS + half * SC;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const float p = expf(s[c] - mnew);
      psum += p;
      pr[c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = alpha * l + psum;
    m = mnew;
    __syncwarp();  // row r's P was written by this thread and its pair

    const float* prow = Ps + r * PS;
    const float* vcol = Vs + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float4* vr = reinterpret_cast<const float4*>(vcol + j * D);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 vx = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vx.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vx.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vx.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vx.w, acc[4 * d4 + 3]);
      }
    }
  }

  if (row < Sq) {
    const float lc = fmaxf(l, 1e-30f);
    float* orow = o + (bh * (size_t)Sq + row) * D + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = acc[d] / lc;
    if (lse != nullptr && half == 0) lse[bh * (size_t)Sq + row] = m + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Sq, int Sk, int causal,
                   int q_offset, float scale, cudaStream_t stream) {
  constexpr bool bf = sizeof(T) == 2;
  constexpr size_t smem = bf ? mma_smem_bytes<D>() : f32_smem_bytes<D>();
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int,
                 int, float);
  if constexpr (bf) kernel = flash_fwd_mma_kernel<D>;
  else kernel = flash_fwd_kernel<D>;
  // set on every launch: the attribute is per device, and the caller
  // makes the inputs' device current (a host-side call of ~1 us)
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), Sq, Sk, causal, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, void* lse, int B, int H, int Sq, int Sk,
                     int causal, int q_offset, float scale,
                     cudaStream_t st) {
#define RTT_CASE(d)                                                       \
  case d:                                                                 \
    return launch<T, d>(q, k, v, o, lse, B, H, Sq, Sk, causal, q_offset, \
                        scale, st);
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  lse may be null.  Returns the
// cudaError_t of the launch (0 on success).
int rtt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int H, int Sq, int Sk, int D, int dtype,
                  int causal, int q_offset, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(D, q, k, v, o, lse, B, H, Sq, Sk, causal,
                                q_offset, scale, st);
  if (dtype == 1)
    return (int)dispatch<bf16>(D, q, k, v, o, lse, B, H, Sq, Sk, causal,
                               q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
