// bf16 tensor-core building blocks for the sm_90a attention kernels:
// 16- and 4-byte cp.async copies (zero-filled past the array's end),
// ldmatrix (plain and transposed) from padded shared-memory tiles, and
// mma.sync m16n8k16 with f32 accumulators.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + t, g = lane / 4,
// t = lane % 4), which the kernels index by hand:
//   A (16 x 16, row-major), 4 regs of 2 bf16: a0 (row g, cols 2t, 2t+1),
//     a1 (row g + 8, cols 2t..), a2 (row g, cols 2t + 8..), a3 (row g + 8,
//     cols 2t + 8..);
//   B (16 x 8, k by n), 2 regs: b0 (k 2t, 2t+1; col n = g), b1 (k 2t + 8..);
//   C (16 x 8 f32), 4 floats: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row
//     g + 8, the same cols).
// An accumulator pair of n-blocks (2j, 2j+1), packed to bf16 pairs, is
// exactly the A fragment of k-step j: P and dS never leave registers.
//
// Tiles are 64 rows of D bf16 with a row stride of D + 8 elements: 16
// bytes of padding move each row's start by one 16-byte bank group, so the
// 8 row addresses of an ldmatrix 8 x 8 matrix hit 8 distinct groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

constexpr int PAD = 8;  // bf16 elements of padding at the end of a tile row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; when !valid nothing is read and dst is zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows x D bf16 of a (b, h, s, d) slice into a padded tile, rows at
// or past n zero-filled; every thread of the block takes a share of the
// 16-byte chunks. src points at the slice's row 0; rows are stride
// elements apart.
template <int D, int NTHREADS, int ROWS = 64>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride, int r0, int n) {
  constexpr int CH = D / 8, RS = D + PAD;
  static_assert(ROWS * CH % NTHREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / NTHREADS; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int r = idx / CH, c = idx % CH;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * RS + c * 8, ok ? src + (long long)(r0 + r) * stride + c * 8 : src,
               ok);
  }
}

// four 8 x 8 b16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// Lane addresses for ldmatrix_x4 over a padded tile (row stride RS):
// - a16x16: the A fragment of rows r0..r0+15, cols c0..c0+15;
// - b_rows: the B fragments of two n-blocks whose n index runs along the
//   tile's rows (K for Q.K^T): regs {b0, b1} of rows r0..r0+7, then of
//   r0+8..r0+15, over cols (k) c0..c0+15;
// - b_trans (with ldmatrix_x4_trans): the B fragments of two n-blocks
//   whose n index runs along the tile's cols (V for P.V): k along rows
//   r0..r0+15, regs {b0, b1} of cols c0..c0+7, then of c0+8..c0+15.
template <int RS>
__device__ __forceinline__ const __nv_bfloat16* a16x16(const __nv_bfloat16* tile, int r0,
                                                       int c0, int lane) {
  return tile + (r0 + (lane & 15)) * RS + c0 + (lane >> 4) * 8;
}
template <int RS>
__device__ __forceinline__ const __nv_bfloat16* b_rows(const __nv_bfloat16* tile, int r0,
                                                       int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * RS + c0 + ((lane >> 3) & 1) * 8;
}
template <int RS>
__device__ __forceinline__ const __nv_bfloat16* b_trans(const __nv_bfloat16* tile, int r0,
                                                        int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + c0 + (lane >> 4) * 8;
}

// c += a . b (16 x 16 by 16 x 8, bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a warp's 16 x D f32 accumulator (D / 8 n-blocks) written as bf16 into
// rows r0..r0+15 of a padded tile, each value divided by its row's div
// (rows g and g + 8 of the lane)
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile, int r0, const float (&acc)[D / 8][4],
                                           float div_lo, float div_hi, int lane) {
  constexpr int RS = D + PAD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int c = nb * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + (r0 + g) * RS + c) =
        pack_bf16(acc[nb][0] / div_lo, acc[nb][1] / div_lo);
    *reinterpret_cast<uint32_t*>(tile + (r0 + g + 8) * RS + c) =
        pack_bf16(acc[nb][2] / div_hi, acc[nb][3] / div_hi);
  }
}

// rows r0..r0+15 of a padded tile to global memory in 16-byte stores by
// one warp, rows at or past n (global index grow + r) skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long stride,
                                           const __nv_bfloat16* tile, int r0, int grow, int n,
                                           int lane) {
  constexpr int CH = D / 8, RS = D + PAD;
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / CH, c = idx % CH;
    if (grow + r < n)
      *reinterpret_cast<uint4*>(dst + (long long)(grow + r) * stride + c * 8) =
          *reinterpret_cast<const uint4*>(tile + (r0 + r) * RS + c * 8);
  }
}

}  // namespace tc
