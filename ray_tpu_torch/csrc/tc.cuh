// Tensor-core building blocks shared by the bf16 attention kernels
// (flash_fwd.cu, flash_bwd.cu): 16-byte and 4-byte cp.async with zero
// fill, ldmatrix (plain and transposed) and the m16n8k16 bf16 mma.sync
// with f32 accumulation.
//
// Fragment layout of mma.m16n8k16 (lane = 4 g + t, g in 0..7, t in 0..3):
//   A 16x16, four b32 registers of two bf16 each:
//     a0 (row g,   cols 2t, 2t+1)   a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g,   cols 2t+8, +9)   a3 (row g+8, cols 2t+8, +9)
//   B 16x8 (k x n), two registers: b0 (k 2t, 2t+1; n g), b1 (k 2t+8, +9)
//   C 16x8 f32: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same)
// So the C fragments of two neighbouring n8 tiles are, once rounded to
// bf16 and packed in pairs, exactly the A fragment of one k16 step: a
// product's f32 result feeds the next product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i receives matrix i (row g, cols 2t, 2t+1)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// the same, each matrix transposed: register i receives (rows 2t, 2t+1;
// col g) of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// c += a . b, bf16 inputs, f32 accumulation (in the tensor cores' own
// order and rounding: not bit for bit an f32 chain of rounded adds)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two dot products of bf16 rows of length D (a . b and c . e), each as
// an in-order f32 chain (0 + a0 b0, then + a1 b1, ...: each product is
// exact in f32, each add rounded), the order torch's f32 matmul takes for
// the plain versions' 64-wide tiles on this card.  Rows are 16-byte
// aligned; the two chains interleave.
template <int D>
__device__ __forceinline__ void dot_chains(const bf16* a, const bf16* b,
                                           const bf16* c, const bf16* e,
                                           float& ab, float& ce) {
  ab = ce = 0.f;
#pragma unroll 2
  for (int k = 0; k < D; k += 8) {
    const uint4 va = *reinterpret_cast<const uint4*>(a + k);
    const uint4 vb = *reinterpret_cast<const uint4*>(b + k);
    const uint4 vc = *reinterpret_cast<const uint4*>(c + k);
    const uint4 ve = *reinterpret_cast<const uint4*>(e + k);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&va);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&vb);
    const __nv_bfloat162* pc = reinterpret_cast<const __nv_bfloat162*>(&vc);
    const __nv_bfloat162* pe = reinterpret_cast<const __nv_bfloat162*>(&ve);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(pa[i]);
      const float2 fb = __bfloat1622float2(pb[i]);
      const float2 fc = __bfloat1622float2(pc[i]);
      const float2 fe = __bfloat1622float2(pe[i]);
      ab = __fadd_rn(ab, __fmul_rn(fa.x, fb.x));
      ce = __fadd_rn(ce, __fmul_rn(fc.x, fe.x));
      ab = __fadd_rn(ab, __fmul_rn(fa.y, fb.y));
      ce = __fadd_rn(ce, __fmul_rn(fc.y, fe.y));
    }
  }
}

// (lo, hi) rounded to nearest even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k16 step c from the f32 C fragments of n8 tiles 2c
// and 2c + 1, rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy rows [r0, r0 + ROWS) of a row-major [S, D] bf16 matrix into
// dst[ROWS][D + 8] with 16-byte cp.async (rows past S are zeros; the
// source address stays in bounds).  The 8-element pad puts the eight
// rows an ldmatrix reads at once on distinct bank groups.  The caller
// commits the group.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const int gi = r0 + r;
    cp_async16(dst + r * (D + 8) + c * 8,
               src + (size_t)min(gi, S - 1) * D + c * 8, gi < S ? 16 : 0);
  }
}

// Store this warp's 16 rows of a [16][D + 8] bf16 tile in shared memory
// to rows [r0, r0 + 16) of a row-major [S, D] matrix, 16 bytes a lane
// (rows past S are not written).
template <int D>
__device__ __forceinline__ void store_rows16(bf16* dst, const bf16* tile,
                                             int r0, int S, int lane) {
  constexpr int CH = D / 8;
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    if (r0 + r < S)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * (D + 8) + c * 8);
  }
}

}  // namespace tc
