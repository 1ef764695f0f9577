// Block-wise int8 quantize (K4), dequantize (K5) and dequantize-accumulate
// (K6) for Hopper (sm_90a), plain C interface.
//
// Replace the Pallas TPU kernels of ray_tpu/ops/quantize.py:
//   K4 quantize_kernel        <- _quantize_kernel       (:94)
//   K5 dequantize_kernel      <- _dequantize_kernel     (:116)
//   K6 dequant_accum_kernel   <- _dequant_accum_kernel  (:120)
// and compute the same functions as the reference's XLA path, bit for bit:
//   scale = absmax / 127 (1.0 when absmax > 0 fails: an all-zero block, or
//   a NaN in the block), y = x * (1 / scale), q = clip(round_half_even(y))
//   or clip(floor(y + u)), a NaN y giving code 0 (XLA's float -> int8
//   conversion); deq = float(q) * scale; the accumulate takes
//   the peers in order 0..world-1 as fused multiply-adds onto an f32 zero,
//   acc = fma(q, s, acc) (as XLA compiles the reference's (q * s).sum(0)),
//   then multiplies by an optional f32 factor (the mean's 1/world).  Every
//   step is an explicit IEEE operation (__fdiv_rn, __frcp_rn, __fmul_rn,
//   __fadd_rn, __fmaf_rn, rintf), so nvcc can neither contract a product
//   and a sum the reference rounds separately nor split one it fuses.
//
// Two rules for the scale, both the reference's: an IEEE division by 127
// (its eager calls and its numpy codec), or the product with f32(1/127)
// (what XLA compiles `absmax / 127` to inside a jitted program, as the
// reference's collectives and its Pallas kernel in interpret mode run it:
// XLA rewrites a division by a constant as a product with the constant's
// reciprocal).  The two differ in the last bit of some scales.
//
// What bounds them on this card: all three move bytes and do a few
// operations per byte, so device memory (3.35 TB/s) bounds them.  What the
// design does about it: every input byte is read from device memory once
// (K4 reads its block a second time, from L1/L2, to scale it), each output
// written once; consecutive lanes touch consecutive addresses.  Wider
// vector loads and keeping the block in registers are later work.
//
// Layouts:
//   K4: x is [rows, cols] float32 or bfloat16 with a row stride (a column
//       slice of a contiguous tensor); when rows > 1 every row is a whole
//       number of blocks, when rows == 1 the last block is padded with
//       zeros that are never read from memory.  One warp per block (any
//       block size 1..4096), eight warps per CTA, grid-stride over blocks;
//       the absmax is a warp-shuffle reduction that keeps NaN (fmaxf would
//       drop it).  Writes q int8 [nblocks * block] and scales f32 [nblocks].
//       Stochastic bits: mix32(mix32(i) ^ key) for flat element index i,
//       u = (bits >> 8) * 2^-24, the same hash as the plain version.
//   K5: q int8 [>= n], scales f32 [ceil(n / block)] -> out [n] float32 or
//       bfloat16 (the f32 product rounded once to the output type).
//   K6: q int8 [world, m], scales f32 [world, m / block] -> out f32 [m];
//       one thread per output element; the finished sum times post_scale
//       (1.0, or the mean's f32(1/world), as XLA compiles the reference's
//       `r / world`).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CTAS = 132 * 16;  // grid-stride beyond this
constexpr unsigned FULL = 0xffffffffu;
constexpr float RECIP_127 = 1.0f / 127.0f;  // IEEE-rounded, as XLA folds it

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
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
}

// the plain version's _mix32, on uint32
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x21f0aaadu;
  x ^= x >> 15;
  x *= 0x735a2d97u;
  x ^= x >> 15;
  return x;
}

// max that keeps NaN, as torch.amax / jnp.max do
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

template <typename T, bool STOCHASTIC>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, long long cols, long long row_stride,
                long long blocks_per_row, int block, long long nblocks,
                int reciprocal_scale, uint32_t key, int8_t* __restrict__ q,
                float* __restrict__ scales) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * WARPS;
  for (long long b = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       b < nblocks; b += nwarps) {
    const long long r = b / blocks_per_row;
    const long long col0 = (b - r * blocks_per_row) * block;
    const T* src = x + r * row_stride + col0;
    const long long valid = cols - col0;  // past it: the zero padding
    float m = 0.f;
    for (int j = lane; j < block; j += 32) {
      const float v = j < valid ? to_f32(src[j]) : 0.f;
      m = nan_max(m, fabsf(v));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(FULL, m, off));
    const float scale =
        m > 0.f ? (reciprocal_scale ? __fmul_rn(m, RECIP_127)
                                    : __fdiv_rn(m, 127.f))
                : 1.f;
    const float inv = __frcp_rn(scale);
    const long long base = b * block;
    for (int j = lane; j < block; j += 32) {
      const float v = j < valid ? to_f32(src[j]) : 0.f;
      const float y = __fmul_rn(v, inv);
      float rq;
      if (STOCHASTIC) {
        const uint32_t bits = mix32(mix32((uint32_t)(base + j)) ^ key);
        const float u = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-8f);
        rq = floorf(__fadd_rn(y, u));
      } else {
        rq = rintf(y);  // half to even, as torch.round / jnp.round
      }
      // NaN (a NaN element, or an inf one times 1/inf) -> 0, as XLA
      // converts float to int8; fmaxf alone would make it -127
      rq = (rq != rq) ? 0.f : fminf(fmaxf(rq, -127.f), 127.f);
      q[base + j] = (int8_t)(int)rq;
    }
    if (lane == 0) scales[b] = scale;
  }
}

template <typename OUT>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, OUT* __restrict__ out,
                  int n, int block) {
  const int stride = gridDim.x * THREADS;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    out[i] = from_f32<OUT>(__fmul_rn((float)q[i], scales[i / block]));
}

__global__ void __launch_bounds__(THREADS)
dequant_accum_kernel(const int8_t* __restrict__ q,
                     const float* __restrict__ scales,
                     float* __restrict__ out, int world, int m, int block,
                     float post_scale) {
  const int nblk = m / block;
  const int stride = gridDim.x * THREADS;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < m; i += stride) {
    const int b = i / block;
    float acc = 0.f;
    for (int p = 0; p < world; ++p)
      acc = __fmaf_rn((float)q[(long long)p * m + i],
                      scales[(long long)p * nblk + b], acc);
    out[i] = __fmul_rn(acc, post_scale);  // 1.0 for a sum: exact
  }
}

int ctas_for(long long work, int per_cta) {
  const long long c = (work + per_cta - 1) / per_cta;
  return (int)(c < 1 ? 1 : (c > MAX_CTAS ? MAX_CTAS : c));
}

template <typename T>
cudaError_t launch_quantize(const void* x, long long rows, long long cols,
                            long long row_stride, int block,
                            long long nblocks, int reciprocal_scale,
                            int stochastic, uint32_t key, void* q, void* s,
                            cudaStream_t st) {
  // rows == 1: one row of `cols` valid elements, padded to nblocks blocks
  const long long bpr = rows == 1 ? nblocks : cols / block;
  const int grid = ctas_for(nblocks, WARPS);
  if (stochastic)
    quantize_kernel<T, true><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), cols, row_stride, bpr, block, nblocks,
        reciprocal_scale, key, static_cast<int8_t*>(q),
        static_cast<float*>(s));
  else
    quantize_kernel<T, false><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(x), cols, row_stride, bpr, block, nblocks,
        reciprocal_scale, key, static_cast<int8_t*>(q),
        static_cast<float*>(s));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x is [rows, cols] with row_stride
// elements between rows; rows > 1 needs cols % block == 0.
// reciprocal_scale: 0 = absmax / 127, 1 = absmax * f32(1/127).  Returns
// the cudaError_t of the launch (0 on success).
int rtt_quantize(const void* x, int dtype, long long rows, long long cols,
                 long long row_stride, int block, long long nblocks,
                 int reciprocal_scale, int stochastic, unsigned int key,
                 void* q, void* s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block < 1 || block > 4096 || rows < 1 || (rows > 1 && cols % block))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_quantize<float>(x, rows, cols, row_stride, block,
                                       nblocks, reciprocal_scale, stochastic,
                                       key, q, s, st);
  if (dtype == 1)
    return (int)launch_quantize<__nv_bfloat16>(
        x, rows, cols, row_stride, block, nblocks, reciprocal_scale,
        stochastic, key, q, s, st);
  return (int)cudaErrorInvalidValue;
}

// out_dtype: 0 = float32, 1 = bfloat16; writes out[0..n).
int rtt_dequantize(const void* q, const void* s, void* out, int out_dtype,
                   int n, int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = ctas_for(n, THREADS);
  if (out_dtype == 0)
    dequantize_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), n, block);
  else if (out_dtype == 1)
    dequantize_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<__nv_bfloat16*>(out), n, block);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q [world, m], scales [world, m / block] -> out [m], each sum times
// post_scale (1.0 for a plain sum).
int rtt_dequantize_accumulate(const void* q, const void* s, void* out,
                              int world, int m, int block, float post_scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (world < 1 || world > 16 || block < 1 || m % block)
    return (int)cudaErrorInvalidValue;
  dequant_accum_kernel<<<ctas_for(m, THREADS), THREADS, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), world, m, block, post_scale);
  return (int)cudaGetLastError();
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
