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
// H100's ~295 FLOPs/byte ridge, so the ideal kernel is memory-bound
// (non-causal, ~512 FLOPs/byte, is bound by the tensor cores).
// This first kernel runs its products on the CUDA cores in f32 FMA (no
// tensor cores), so in practice it is bound by those operations and by
// shared-memory traffic, well above the memory bound.  What the design
// does about it: each Q/K/V element is read from device memory once per
// tile and staged in shared memory as f32; K is stored transposed so a
// thread's 32 scores read 16-byte vectors; S and P never leave the chip;
// causal tiles above the diagonal are skipped.  wgmma/TMA and warp
// specialisation are later work.
//
// Layout: q [B, H, Sq, D], k/v [B, H, Sk, D], contiguous; o like q.
// Grid (ceil(Sq / 64), H, B); 128 threads, two per query row: thread
// (r, half) owns 32 of the 64 scores of row r in a key tile and half of
// the row's D accumulator columns.  Any Sq, Sk >= 1 (ragged edges are
// masked); D a multiple of 16 up to 128; float32 or bfloat16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // two per query row
// rounded from the double product, as DEFAULT_MASK_VALUE is in Python
constexpr float MASK_VALUE = (float)(-0.7 * 3.40282346638528859812e+38);

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + D * (BK + 4) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + bh * (size_t)Sq * D;
  const T* kb = k + bh * (size_t)Sk * D;
  const T* vb = v + bh * (size_t)Sk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, cc = i % D;
    const int qi = q0 + rr;
    Qs[rr * QS + cc] = qi < Sq ? to_f32(qb[(size_t)qi * D + cc]) : 0.f;
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
        kx = to_f32(kb[(size_t)kj * D + cc]);
        vx = to_f32(vb[(size_t)kj * D + cc]);
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
      pr[c] = to_f32(from_f32<T>(p));  // P in the input dtype for P.V
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
    T* orow = o + (bh * (size_t)Sq + row) * D + half * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = from_f32<T>(acc[d] / lc);
    if (lse != nullptr && half == 0) lse[bh * (size_t)Sq + row] = m + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int H, int Sq, int Sk, int causal,
                   int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // set on every launch: the attribute is per device, and the caller
  // makes the inputs' device current (a host-side call of ~1 us)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
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
    return (int)dispatch<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Sq, Sk,
                                        causal, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
