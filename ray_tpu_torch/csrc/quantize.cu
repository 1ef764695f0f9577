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
// operations per byte, so device memory (3.35 TB/s) bounds them.  K4 reads
// each input byte from device memory once (its block a second time, from
// L1/L2, to scale it); consecutive lanes touch consecutive addresses.
//
// K5 and K6 stream: 1 byte of code per peer in, 4 (or 2) bytes out, no
// reuse.  At the dp step's chunks (0.85-4.8M elements, 4-25 MB a launch)
// the HBM bound is 1.3-7.5 us, so beside the bytes the launch ramp and
// the instructions per byte count: the first version loaded one byte per
// thread per peer, divided i / block for every element and reloaded the
// scale for every element and peer.  The design:
//   - a warp takes a tile of 512 consecutive outputs (TILE); lane l loads
//     codes [16 l, 16 l + 16) of it, per peer one 16-byte load (LDG.E.128;
//     the warp's 512 bytes contiguous), and the scale of their block, so
//     the block index is taken once per 16 codes, as a shift when the
//     block is a power of two (block % 16 == 0: 16 codes never straddle
//     blocks);
//   - the codes cross lanes through 512 bytes of shared memory per warp,
//     the scales by shuffle, so that every store instruction writes 512
//     contiguous bytes (four float4 per lane for f32, four 8-byte stores
//     for bf16): stores of a lane's own 16 outputs, 64 bytes apart from
//     lane to lane, fill half sectors and ran at half the rate;
//   - K6 issues every peer's loads (up to 16 x 16 B in flight per lane,
//     unrolled at a compile-time bound of 1, 2, 4, 8 or 16 peers) before
//     its first FMA, then keeps the per-element chain fma(q[p], s[p], acc)
//     in peer order, so the bits are the first version's;
//   - the grid is one wave of resident CTAs at most (Little's law: 3.35
//     TB/s x ~0.6 us is ~2 MB in flight; a wave holds 16 B x every lane
//     x world of loads, and the stores behind them), grid-stride beyond.
// Inputs the vector body cannot take (a block that is not a multiple of 16,
// q or out not 16-byte aligned) run the first version's per-element body in
// the same launch, as does the ragged tail under a tile (n % 512); both
// give the same bits.  The wrappers count the launches that took the
// vector body.

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
//   K6: q int8 [world, m], scales f32 [world, m / block] -> out f32 [m]; the
//       finished sum times post_scale (1.0, or the mean's f32(1/world), as
//       XLA compiles the reference's `r / world`).

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

constexpr int RUN = 16;          // codes per lane per peer: one 16-byte load
constexpr int TILE = 32 * RUN;   // outputs per warp per step of K5 and K6

// Whether K5/K6 take the vector body: a lane's 16 codes lie inside one
// block, and 16-byte accesses of q and out are aligned (ops/_kernels.py's
// vector_body() states the same rule for the launch counts).
bool vector_body(const void* q, const void* out, int block) {
  return block % RUN == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

// log2(block) for a power of two, else -1 (the kernels then divide)
int block_shift(int block) {
  return (block & (block - 1)) ? -1 : __builtin_ctz((unsigned)block);
}

__device__ __forceinline__ int block_of(int i, int block, int shift) {
  return shift >= 0 ? i >> shift : i / block;
}

// code j (0..3) of a 4-byte word, as float (exact)
__device__ __forceinline__ float code_at(uint32_t w, int j) {
  return (float)(int8_t)((w >> (8 * j)) & 0xffu);
}

// A warp's tile: lane l loads codes [16 l, 16 l + 16) of the tile (one
// 16-byte load, the warp's 512 bytes contiguous) and the scale of their
// block.  The stores want lane l to hold outputs [4 (32 k + l), +4) for
// k = 0..3, so that each store instruction writes 32 lanes x 16
// contiguous bytes (lane-strided stores fill half sectors and ran at half
// the rate): the codes cross lanes through 512 bytes of shared memory,
// the scales by shuffle (word 32 k + l is in lane 8 k + l / 4's run).
struct TileWords {
  uint32_t w[4];
  float s[4];
};

__device__ __forceinline__ TileWords transpose(uint32_t* stage, int lane,
                                               int4 c, float s) {
  TileWords t;
  reinterpret_cast<int4*>(stage)[lane] = c;
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t.w[k] = stage[32 * k + lane];
    t.s[k] = __shfl_sync(FULL, s, 8 * k + (lane >> 2));
  }
  __syncwarp();  // every lane has read before the stage is written again
  return t;
}

// four outputs at out[i..i+3] (16 bytes of f32, 8 of bf16 each rounded
// once to nearest even)
__device__ __forceinline__ void store4(float* out, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  const __nv_bfloat162 hi =
      __halves2bfloat162(__float2bfloat16_rn(c), __float2bfloat16_rn(d));
  *reinterpret_cast<uint2*>(out) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
}

template <typename OUT>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, OUT* __restrict__ out,
                  int n, int block, int shift, int vec) {
  __shared__ __align__(16) uint32_t stage[WARPS][TILE / 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int tail = 0;  // the per-element body starts here
  if (vec) {
    const int tiles = n / TILE;
    const int4* q16 = reinterpret_cast<const int4*>(q);
    for (int w = blockIdx.x * WARPS + warp; w < tiles;
         w += gridDim.x * WARPS) {
      const int i0 = w * TILE;
      const int4 c = q16[w * 32 + lane];
      const float s = scales[block_of(i0 + RUN * lane, block, shift)];
      const TileWords t = transpose(stage[warp], lane, c, s);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        store4(out + i0 + 4 * (32 * k + lane),
               __fmul_rn(code_at(t.w[k], 0), t.s[k]),
               __fmul_rn(code_at(t.w[k], 1), t.s[k]),
               __fmul_rn(code_at(t.w[k], 2), t.s[k]),
               __fmul_rn(code_at(t.w[k], 3), t.s[k]));
    }
    tail = tiles * TILE;
  }
  for (int i = tail + blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS)
    out[i] = from_f32<OUT>(__fmul_rn((float)q[i], scales[i / block]));
}

// MAXW: a compile-time bound on world (1, 2, 4, 8 or 16), so that the
// per-peer loads unroll into registers
template <int MAXW>
__global__ void __launch_bounds__(THREADS)
dequant_accum_kernel(const int8_t* __restrict__ q,
                     const float* __restrict__ scales,
                     float* __restrict__ out, int world, int m, int block,
                     int shift, int vec, float post_scale) {
  __shared__ __align__(16) uint32_t stage[WARPS][TILE / 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblk = m / block;
  int tail = 0;  // the per-element body starts here
  if (vec) {
    const int tiles = m / TILE;
    for (int w = blockIdx.x * WARPS + warp; w < tiles;
         w += gridDim.x * WARPS) {
      const int i0 = w * TILE;
      const int b = block_of(i0 + RUN * lane, block, shift);
      // every peer's loads first: up to MAXW x 16 B in flight per lane
      int4 c[MAXW];
      float s[MAXW];
#pragma unroll
      for (int p = 0; p < MAXW; ++p) {
        c[p] = make_int4(0, 0, 0, 0);
        s[p] = 0.f;
        if (p < world) {
          c[p] = reinterpret_cast<const int4*>(q + (long long)p * m)
              [w * 32 + lane];
          s[p] = scales[(long long)p * nblk + b];
        }
      }
      // then the chain fma(q[p], s[p], acc) per output, peers in order
      float acc[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
#pragma unroll
      for (int p = 0; p < MAXW; ++p) {
        if (p < world) {  // uniform over the warp
          const TileWords t = transpose(stage[warp], lane, c[p], s[p]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[k][j] = __fmaf_rn(code_at(t.w[k], j), t.s[k], acc[k][j]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)  // post_scale 1.0 for a sum: exact
        store4(out + i0 + 4 * (32 * k + lane),
               __fmul_rn(acc[k][0], post_scale),
               __fmul_rn(acc[k][1], post_scale),
               __fmul_rn(acc[k][2], post_scale),
               __fmul_rn(acc[k][3], post_scale));
    }
    tail = tiles * TILE;
  }
  for (int i = tail + blockIdx.x * THREADS + threadIdx.x; i < m;
       i += gridDim.x * THREADS) {
    const int b = i / block;
    float acc = 0.f;
    for (int p = 0; p < world; ++p)
      acc = __fmaf_rn((float)q[(long long)p * m + i],
                      scales[(long long)p * nblk + b], acc);
    out[i] = __fmul_rn(acc, post_scale);
  }
}

// CTAs of one wave of `kernel` on the current device (computed once per
// kernel: every card of a process is the same kind)
template <typename K>
int wave_ctas(K kernel) {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// a warp per tile of the vector body (its tail, under a tile, takes any
// thread) or a thread per element, at most one wave of CTAs
int stream_ctas(int n, int vec, int wave) {
  const long long c = vec ? (n / TILE + WARPS - 1) / WARPS
                          : ((long long)n + THREADS - 1) / THREADS;
  return (int)(c < 1 ? 1 : (c > wave ? wave : c));
}

template <typename OUT>
cudaError_t launch_dequantize(const void* q, const void* s, void* out, int n,
                              int block, cudaStream_t st) {
  static const int wave = wave_ctas(dequantize_kernel<OUT>);
  const int vec = vector_body(q, out, block);
  dequantize_kernel<OUT><<<stream_ctas(n, vec, wave), THREADS, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<OUT*>(out), n, block, block_shift(block), vec);
  return cudaGetLastError();
}

template <int MAXW>
cudaError_t launch_dequant_accum(const void* q, const void* s, void* out,
                                 int world, int m, int block,
                                 float post_scale, cudaStream_t st) {
  static const int wave = wave_ctas(dequant_accum_kernel<MAXW>);
  const int vec = vector_body(q, out, block);
  dequant_accum_kernel<MAXW><<<stream_ctas(m, vec, wave), THREADS, 0,
                               st>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), world, m, block, block_shift(block), vec,
      post_scale);
  return cudaGetLastError();
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
  if (block < 1) return (int)cudaErrorInvalidValue;
  if (out_dtype == 0)
    return (int)launch_dequantize<float>(q, s, out, n, block, st);
  if (out_dtype == 1)
    return (int)launch_dequantize<__nv_bfloat16>(q, s, out, n, block, st);
  return (int)cudaErrorInvalidValue;
}

// q [world, m], scales [world, m / block] -> out [m], each sum times
// post_scale (1.0 for a plain sum).
int rtt_dequantize_accumulate(const void* q, const void* s, void* out,
                              int world, int m, int block, float post_scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (world < 1 || world > 16 || block < 1 || m % block)
    return (int)cudaErrorInvalidValue;
  cudaError_t (*launch)(const void*, const void*, void*, int, int, int,
                        float, cudaStream_t) =
      world == 1   ? &launch_dequant_accum<1>
      : world <= 2 ? &launch_dequant_accum<2>
      : world <= 4 ? &launch_dequant_accum<4>
      : world <= 8 ? &launch_dequant_accum<8>
                   : &launch_dequant_accum<16>;
  return (int)launch(q, s, out, world, m, block, post_scale, st);
}

const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
