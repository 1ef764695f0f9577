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
//   then multiplies by an optional f32 factor (the mean's 1/world).  The
//   arithmetic is in csrc/quant_tile.cuh, shared with K7 (csrc/fused_rs.cu).
//
// Two rules for the scale, both the reference's: an IEEE division by 127
// (its eager calls and its numpy codec), or the product with f32(1/127)
// (what XLA compiles `absmax / 127` to inside a jitted program, as the
// reference's collectives and its Pallas kernel in interpret mode run it:
// XLA rewrites a division by a constant as a product with the constant's
// reciprocal).  The two differ in the last bit of some scales.
//
// What bounds them on this card: all three move bytes and do a few
// operations per byte, so device memory (3.35 TB/s) bounds them.  At the
// dp step's chunks (0.85-4.8M elements, 5-25 MB a launch) the HBM bound is
// 1.3-7.5 us, so the launch ramp and the instructions per byte count too.
//
// K4 (4 or 2 bytes in, 1 out per element, 4 out per block).  The first
// version ran one warp per block, one element per lane per step, read each
// block twice, divided the block index by the blocks per row (64-bit) for
// every block and capped its grid at 132 x 16 CTAs: one 4-byte load per
// lane in flight, then a dependent chain.  At the sync's result block of
// 32 that is one 128-byte chain per warp.  The design:
//   - a warp takes a quantize tile (quant_tile.cuh): 512 f32 or 1024 bf16
//     consecutive elements, four 16-byte loads per lane (each instruction
//     32 x 16 contiguous bytes) issued before any arithmetic and held in
//     registers: each input byte is read from device memory once;
//   - the block absmax is a segmented xor-shuffle inside the lanes of its
//     block (B <= 128 f32) or a fold of whole slices, then the warp; the
//     tile body is a template on B (16 ... 512), so the shuffles unroll
//     and the profiler names each block size's launches;
//   - codes leave as one 4-byte (f32) or 8-byte (bf16) store per lane and
//     slice, 128 or 256 contiguous bytes an instruction; the tile's scales
//     as one coalesced store per 32 blocks;
//   - the block index is a shift; a row-strided chunk finds its row once
//     per tile (rows a multiple of the tile) or once per 16-byte vector
//     (a vector never crosses a row: every row is whole blocks);
//   - the grid is one wave of resident CTAs (occupancy API), grid-stride
//     beyond: a wave holds 2 KB of loads in flight per warp.
//
// K5 and K6 stream: 1 byte of code per peer in, 4 (or 2) bytes out, no
// reuse.  The first version loaded one byte per thread per peer, divided
// i / block for every element and reloaded the scale for every element
// and peer.  The design:
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
// Inputs a vector body cannot take run the first version's per-element
// body in the same launch, as does the ragged tail under a tile; both give
// the same bits.  K4: a block that is not a power of two from 16 to 512,
// x or a row start not 16-byte aligned, q not 16-byte aligned.  K5/K6: a
// block that is not a multiple of 16, q or out not 16-byte aligned.  The
// wrappers count the launches that took the vector body.

// Layouts:
//   K4: x is [rows, cols] float32 or bfloat16 with a row stride (a column
//       slice of a contiguous tensor); when rows > 1 every row is a whole
//       number of blocks, when rows == 1 the last block is padded with
//       zeros that are never read from memory.  Writes q int8 [nblocks *
//       block] and scales f32 [nblocks].  Stochastic bits: mix32(mix32(i)
//       ^ key) for flat element index i, u = (bits >> 8) * 2^-24, the same
//       hash as the plain version.
//   K5: q int8 [>= n], scales f32 [ceil(n / block)] -> out [n] float32 or
//       bfloat16 (the f32 product rounded once to the output type).
//   K6: q int8 [world, m], scales f32 [world, m / block] -> out f32 [m]; the
//       finished sum times post_scale (1.0, or the mean's f32(1/world), as
//       XLA compiles the reference's `r / world`).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quant_tile.cuh"

namespace {

using namespace qtile;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
}

// Where element e (0 <= e < rows * cols, the packed order of q) of a K4
// input lies: row e / cols at row_stride per row.  row_mode 0: one row
// (x is flat); 1: rows a whole number of tiles (the row taken from the
// tile's first element); 2: rows of whole blocks (the row taken per
// element run, which never crosses one).
__device__ __forceinline__ long long row_offset(int e, int i0, int cols,
                                                long long row_stride,
                                                int row_mode) {
  if (row_mode == 0) return e;
  const int r = (row_mode == 1 ? i0 : e) / cols;
  return (long long)r * row_stride + (e - r * cols);
}

// K4.  B: the block of the vector body (a power of two, 16..512), or 0 for
// the per-element body alone.  Work items of a warp: quantize tiles
// 0..tiles-1, then blocks tail_block..nblocks-1 one at a time (the ragged
// tail, or every block when B == 0).
template <typename T, bool STOCHASTIC, int B>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, long long cols, long long row_stride,
                long long blocks_per_row, int block, long long nblocks,
                int reciprocal_scale, uint32_t key, int8_t* __restrict__ q,
                float* __restrict__ scales, int tiles, int row_mode) {
  constexpr int V = 16 / sizeof(T), S = 32 * V, QT = 4 * S;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * WARPS;
  if (B != 0) {
    // tiles gw, gw + nwarps, ...
    for (int t = gw; t < tiles; t += nwarps) {
      const int i0 = t * QT;
      float v[4][V];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = i0 + S * k + V * lane;
        load16(x + row_offset(e, i0, (int)cols, row_stride, row_mode), v[k]);
      }
      float s[4];
      uint32_t w[4][V / 4];
      quantize_tile<V, STOCHASTIC>(v, B, reciprocal_scale,
                                   (uint32_t)(i0 + V * lane), key, s, w);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int8_t* dst = q + i0 + S * k + V * lane;
        if constexpr (V == 4)
          *reinterpret_cast<uint32_t*>(dst) = w[k][0];
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[k][0], w[k][1]);
      }
      store_tile_scales<V>(scales + i0 / (B ? B : 1), s, B, lane);
    }
  }
  // the first version's body, a warp per block from tail_block (the
  // ragged tail, or every block when B == 0): one element per lane per
  // step, the block read twice (the second pass from L1/L2)
  const long long tail_block = B ? (long long)tiles * (QT / (B ? B : 1)) : 0;
  for (long long b = tail_block + gw; b < nblocks; b += nwarps) {
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
    const float scale = scale_of(m, reciprocal_scale);
    const float inv = __frcp_rn(scale);
    const long long base = b * block;
    for (int j = lane; j < block; j += 32) {
      const float v = j < valid ? to_f32(src[j]) : 0.f;
      q[base + j] = (int8_t)code_of<STOCHASTIC>(v, inv, (uint32_t)(base + j),
                                                key);
    }
    if (lane == 0) scales[b] = scale;
  }
}

// Whether K4 takes its vector body: a power-of-two block from 16 to 512
// and 16-byte aligned accesses of x, of every row start and of q
// (ops/_kernels.py's quantize_vector_body states the same rule).
bool quantize_vector_body(const void* x, long long rows, long long row_stride,
                          int esize, int block, const void* q) {
  return block >= 16 && block <= 512 && block_shift(block) >= 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         (rows == 1 || (row_stride * esize) % 16 == 0) &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// Whether K5/K6 take the vector body: a lane's 16 codes lie inside one
// block, and 16-byte accesses of q and out are aligned (ops/_kernels.py's
// vector_body() states the same rule for the launch counts).
bool vector_body(const void* q, const void* out, int block) {
  return block % RUN == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
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
         w += gridDim.x * WARPS)
      accum_tile<MAXW, false, false>(q, m, scales, nblk, world, w * TILE,
                                     block,
                              shift, post_scale, stage[warp], lane, out);
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

// CTAs for `warps` warp-sized work items, at most one wave
int warp_ctas(long long warps, int wave) {
  const long long c = (warps + WARPS - 1) / WARPS;
  return (int)(c < 1 ? 1 : (c > wave ? wave : c));
}

// a warp per tile of the vector body (its tail, under a tile, takes any
// thread) or a thread per element, at most one wave of CTAs
int stream_ctas(int n, int vec, int wave) {
  return vec ? warp_ctas(n / TILE, wave)
             : warp_ctas(((long long)n + 31) / 32, wave);
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

struct QuantizeArgs {
  const void* x;
  long long rows, cols, row_stride;
  int block;
  long long nblocks;
  int reciprocal_scale;
  uint32_t key;
  void* q;
  void* s;
};

template <typename T, bool STOCHASTIC, int B>
cudaError_t launch_quantize(const QuantizeArgs& a, cudaStream_t st) {
  constexpr int QT = 4 * 32 * (16 / sizeof(T));  // elements of a tile
  static const int wave = wave_ctas(quantize_kernel<T, STOCHASTIC, B>);
  // rows == 1: one row of `cols` valid elements, padded to nblocks blocks
  const long long bpr = a.rows == 1 ? a.nblocks : a.cols / a.block;
  const long long valid = a.rows * a.cols;
  const int tiles = B ? (int)(valid / QT) : 0;
  const int row_mode = a.rows == 1 ? 0 : (a.cols % QT == 0 ? 1 : 2);
  const long long tail_blocks =
      a.nblocks - (B ? (long long)tiles * (QT / (B ? B : 1)) : 0);
  const long long work = tiles > tail_blocks ? tiles : tail_blocks;
  quantize_kernel<T, STOCHASTIC, B>
      <<<warp_ctas(work, wave), THREADS, 0, st>>>(
          static_cast<const T*>(a.x), a.cols, a.row_stride, bpr, a.block,
          a.nblocks, a.reciprocal_scale, a.key, static_cast<int8_t*>(a.q),
          static_cast<float*>(a.s), tiles, row_mode);
  return cudaGetLastError();
}

template <typename T, bool STOCHASTIC>
cudaError_t quantize_by_block(const QuantizeArgs& a, bool vec,
                              cudaStream_t st) {
  switch (vec ? a.block : 0) {
    case 16: return launch_quantize<T, STOCHASTIC, 16>(a, st);
    case 32: return launch_quantize<T, STOCHASTIC, 32>(a, st);
    case 64: return launch_quantize<T, STOCHASTIC, 64>(a, st);
    case 128: return launch_quantize<T, STOCHASTIC, 128>(a, st);
    case 256: return launch_quantize<T, STOCHASTIC, 256>(a, st);
    case 512: return launch_quantize<T, STOCHASTIC, 512>(a, st);
    default: return launch_quantize<T, STOCHASTIC, 0>(a, st);
  }
}

template <typename T>
cudaError_t quantize_typed(const QuantizeArgs& a, int stochastic,
                           cudaStream_t st) {
  const bool vec = quantize_vector_body(a.x, a.rows, a.row_stride,
                                        (int)sizeof(T), a.block, a.q);
  return stochastic ? quantize_by_block<T, true>(a, vec, st)
                    : quantize_by_block<T, false>(a, vec, st);
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
  if (block < 1 || block > 4096 || rows < 1 || (rows > 1 && cols % block) ||
      nblocks < 1 || nblocks * block > 0x7fffffffLL ||
      rows * cols > nblocks * block)
    return (int)cudaErrorInvalidValue;
  const QuantizeArgs a{x,     rows,
                       cols,  row_stride,
                       block, nblocks,
                       reciprocal_scale, key,
                       q,     s};
  if (dtype == 0) return (int)quantize_typed<float>(a, stochastic, st);
  if (dtype == 1) return (int)quantize_typed<__nv_bfloat16>(a, stochastic, st);
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
