// Warp-tile device functions shared by the int8 kernels for Hopper
// (sm_90a): K4 quantize_kernel and K6 dequant_accum_kernel
// (csrc/quantize.cu) and K7 fused_rs_kernel (csrc/fused_rs.cu).  K7's
// arithmetic is K4's with the reciprocal scale followed by K6's in-order
// FMA chain; both stages call the functions here, so K7 equals the staged
// hop K4 -> all_to_all -> K6 by construction.
//
// Every step is an explicit IEEE operation (__fdiv_rn, __frcp_rn,
// __fmul_rn, __fadd_rn, __fmaf_rn, rintf), so nvcc can neither contract a
// product and a sum the reference rounds separately nor split one it fuses.
//
// The quantize tile.  A warp takes 4 slices of S = 32 V consecutive
// elements (V = 16 / sizeof(T): 4 f32 or 8 bf16, one 16-byte load); lane l
// holds elements [S k + V l, +V) of slice k = 0..3, all four loads issued
// before any arithmetic and kept in registers, so each input byte is read
// from device memory once and every load instruction covers 32 x 16
// contiguous bytes.  A block B (a power of two, V <= B <= 4 S) is B / V
// consecutive lanes of one slice (B <= S: a segmented xor-shuffle over
// offsets below B / V, so a NaN stays inside its own block) or B / S whole
// slices (folded in registers, then the whole warp).
//
// The dequantize-accumulate tile.  A warp takes TILE = 512 consecutive
// outputs; lane l loads codes [16 l, 16 l + 16) of each peer (one 16-byte
// load, every peer's before the first FMA) and the scale of their block;
// the codes cross lanes through 512 bytes of shared memory and the scales
// by shuffle, so that every store instruction writes 512 contiguous bytes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace qtile {

constexpr unsigned FULL = 0xffffffffu;
constexpr float RECIP_127 = 1.0f / 127.0f;  // IEEE-rounded, as XLA folds it
constexpr int RUN = 16;         // codes per lane per peer: one 16-byte load
constexpr int TILE = 32 * RUN;  // outputs of an accumulate tile; f32 inputs
                                // of a quantize tile

// max that keeps NaN, as torch.amax / jnp.max do (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

// absmax / 127 by either rule (reciprocal: absmax * f32(1/127), as XLA
// compiles the division inside a jitted program); 1.0 when absmax > 0
// fails (an all-zero block, or a NaN in the block)
__device__ __forceinline__ float scale_of(float absmax, int reciprocal) {
  return absmax > 0.f ? (reciprocal ? __fmul_rn(absmax, RECIP_127)
                                    : __fdiv_rn(absmax, 127.f))
                      : 1.f;
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

// The code of v: clip(rint(v * inv)) or, stochastic, clip(floor(v * inv +
// u)) with u = (mix32(mix32(i) ^ key) >> 8) * 2^-24 for flat index i; a
// NaN (a NaN element, or an inf one times 1/inf) is 0, as XLA converts
// float to int8 (fmaxf alone would make it -127).
template <bool STOCHASTIC>
__device__ __forceinline__ int code_of(float v, float inv, uint32_t i,
                                       uint32_t key) {
  const float y = __fmul_rn(v, inv);
  float r;
  if (STOCHASTIC) {
    const uint32_t bits = mix32(mix32(i) ^ key);
    const float u = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-8f);
    r = floorf(__fadd_rn(y, u));
  } else {
    r = rintf(y);  // half to even, as torch.round / jnp.round
  }
  r = (r != r) ? 0.f : fminf(fmaxf(r, -127.f), 127.f);
  return (int)r;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one 16-byte load of V elements, as f32 (bf16 widens exactly)
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Each slice's block absmax (m[k] for the block holding lane's slice k).
// `block` is a compile-time constant where K4 calls this (the shuffle
// loops unroll), a run-time one in K7.
template <int V>
__device__ __forceinline__ void tile_absmax(const float (&v)[4][V],
                                            int block, float (&m)[4]) {
  constexpr int S = 32 * V;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) m[k] = nan_max(m[k], fabsf(v[k][j]));
  }
  if (block <= S) {
    // B / V lanes of one slice: offsets below B / V stay in the block
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int off = block / (2 * V); off > 0; off >>= 1)
        m[k] = nan_max(m[k], __shfl_xor_sync(FULL, m[k], off));
  } else if (block == 2 * S) {
    // slices 0-1 and 2-3 are two blocks: fold, then the whole warp
    float a = nan_max(m[0], m[1]), b = nan_max(m[2], m[3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a = nan_max(a, __shfl_xor_sync(FULL, a, off));
      b = nan_max(b, __shfl_xor_sync(FULL, b, off));
    }
    m[0] = m[1] = a;
    m[2] = m[3] = b;
  } else {
    // block == 4 S: the tile is one block
    float a = nan_max(nan_max(m[0], m[1]), nan_max(m[2], m[3]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a = nan_max(a, __shfl_xor_sync(FULL, a, off));
    m[0] = m[1] = m[2] = m[3] = a;
  }
}

// The codes of the lane's elements, four to a 32-bit word in element
// order; `first` is the flat index of the lane's first element of slice 0
// (the stochastic bits hash it).
template <int V, bool STOCHASTIC>
__device__ __forceinline__ void tile_codes(const float (&v)[4][V],
                                           const float (&inv)[4],
                                           uint32_t first, uint32_t key,
                                           uint32_t (&w)[4][V / 4]) {
  constexpr int S = 32 * V;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int g = 0; g < V / 4; ++g) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = code_of<STOCHASTIC>(
            v[k][4 * g + j], inv[k], first + S * k + 4 * g + j, key);
        word |= ((uint32_t)c & 0xffu) << (8 * j);
      }
      w[k][g] = word;
    }
}

// A quantize tile, scales and codes: s[k] the scale of the block holding
// slice k's elements of this lane, w[k] their codes.
template <int V, bool STOCHASTIC>
__device__ __forceinline__ void quantize_tile(const float (&v)[4][V],
                                              int block, int reciprocal,
                                              uint32_t first, uint32_t key,
                                              float (&s)[4],
                                              uint32_t (&w)[4][V / 4]) {
  float m[4], inv[4];
  tile_absmax<V>(v, block, m);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = scale_of(m[k], reciprocal);
    inv[k] = __frcp_rn(s[k]);
  }
  tile_codes<V, STOCHASTIC>(v, inv, first, key, w);
}

// Stores the tile's 4 S / block scales from scales[0]: block j of the tile
// from lane j % 32 (of round j / 32), one coalesced store per 32 blocks.
template <int V>
__device__ __forceinline__ void store_tile_scales(float* scales,
                                                  const float (&s)[4],
                                                  int block, int lane) {
  constexpr int S = 32 * V;
  const int nb = 4 * S / block;
  for (int j = lane; j - lane < nb; j += 32) {  // uniform over the warp
    float t = 0.f;
    if (block <= S) {
      // block j is in slice j / pk, from its first lane (j % pk) (B / V)
      const int pk = S / block;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float u = __shfl_sync(FULL, s[k], (j % pk) * (block / V));
        if (j / pk == k) t = u;
      }
    } else {
      // every lane holds every slice's scale; block j starts at slice
      // j (B / S)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j * (block / S) == k) t = s[k];
    }
    if (j < nb) scales[j] = t;
  }
}

// The codes of an f32 quantize tile (V = 4) as lane l's 16 consecutive
// codes [16 l, 16 l + 16), through 512 bytes of shared memory, so that a
// warp's codes leave as 16-byte stores.
__device__ __forceinline__ int4 codes_to_runs(uint32_t* stage, int lane,
                                              const uint32_t (&w)[4][1]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) stage[32 * k + lane] = w[k][0];
  __syncwarp();
  const int4 c = reinterpret_cast<const int4*>(stage)[lane];
  __syncwarp();  // every lane has read before the stage is written again
  return c;
}

// log2(block) for a power of two, else -1 (the kernels then divide)
__host__ __device__ __forceinline__ int block_shift(int block) {
  if (block < 1 || (block & (block - 1))) return -1;
  int s = 0;
  while ((1 << s) < block) ++s;
  return s;
}

__device__ __forceinline__ int block_of(int i, int block, int shift) {
  return shift >= 0 ? i >> shift : i / block;
}

// code j (0..3) of a 4-byte word, as float (exact)
__device__ __forceinline__ float code_at(uint32_t w, int j) {
  return (float)(int8_t)((w >> (8 * j)) & 0xffu);
}

// A warp's accumulate tile after the loads: lane l holds codes [16 l, 16 l
// + 16) and their scale.  The stores want lane l to hold outputs [4 (32 k
// + l), +4) for k = 0..3, so that each store instruction writes 32 lanes x
// 16 contiguous bytes (lane-strided stores fill half sectors and ran at
// half the rate): the codes cross lanes through 512 bytes of shared
// memory, the scales by shuffle (word 32 k + l is in lane 8 k + l / 4's
// run).
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

// The dequantize-accumulate tile of outputs [i0, i0 + 512): over peers
// p = 0..world-1 (codes at q + p * q_peer, scales at scales + p * s_peer),
// acc = fma(q[p], s[p], acc) per output from an f32 zero, in peer order,
// then times post_scale, stored at out + i0.  MAXW peers' loads are issued
// before their FMAs (up to MAXW x 16 B in flight per lane).  GROUPS: world
// may exceed MAXW, and the peers are taken MAXW at a time, the chain still
// in order (otherwise world <= MAXW).  CG: the codes and scales were
// written during this launch by other SMs or cards, so they are loaded
// with __ldcg (L2, not a stale L1 line); otherwise through the read-only
// path (__ldg).
template <int MAXW, bool CG, bool GROUPS>
__device__ __forceinline__ void accum_tile(
    const int8_t* __restrict__ q, long long q_peer,
    const float* __restrict__ scales, long long s_peer, int world, int i0,
    int block, int shift, float post_scale, uint32_t* stage, int lane,
    float* __restrict__ out) {
  const int b = block_of(i0 + RUN * lane, block, shift);
  float acc[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
  for (int p0 = 0; p0 < world; p0 += MAXW) {
    // every peer's loads first
    int4 c[MAXW];
    float s[MAXW];
#pragma unroll
    for (int p = 0; p < MAXW; ++p) {
      c[p] = make_int4(0, 0, 0, 0);
      s[p] = 0.f;
      if (p0 + p < world) {
        const int4* src = reinterpret_cast<const int4*>(
                              q + (long long)(p0 + p) * q_peer + i0) +
                          lane;
        const float* sp = scales + (long long)(p0 + p) * s_peer + b;
        c[p] = CG ? __ldcg(src) : __ldg(src);
        s[p] = CG ? __ldcg(sp) : __ldg(sp);
      }
    }
    // then the chain fma(q[p], s[p], acc) per output, peers in order
#pragma unroll
    for (int p = 0; p < MAXW; ++p) {
      if (p0 + p < world) {  // uniform over the warp
        const TileWords t = transpose(stage, lane, c[p], s[p]);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[k][j] = __fmaf_rn(code_at(t.w[k], j), t.s[k], acc[k][j]);
      }
    }
    if (!GROUPS) break;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)  // post_scale 1.0 for a sum: exact
    store4(out + i0 + 4 * (32 * k + lane), __fmul_rn(acc[k][0], post_scale),
           __fmul_rn(acc[k][1], post_scale),
           __fmul_rn(acc[k][2], post_scale),
           __fmul_rn(acc[k][3], post_scale));
}

}  // namespace qtile
