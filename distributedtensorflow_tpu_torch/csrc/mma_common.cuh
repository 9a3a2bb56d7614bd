// Tensor-core building blocks shared by the fused LM-head kernels
// (xent_common.cuh) and the flash-attention kernels (flash_common.cuh):
// asynchronous copies into shared memory (cp.async), fragment loads
// (ldmatrix) and the bf16 product mma.sync.m16n8k16 with fp32 sums.
//
// Fragments of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), four registers of two bf16 each:
//     a0 = (row g,     cols 2t, 2t + 1)      a1 = (row g + 8, cols 2t, 2t + 1)
//     a2 = (row g,     cols 2t + 8, 2t + 9)  a3 = (row g + 8, cols 2t + 8, 2t + 9)
//   B (16 x 8), two registers:
//     b0 = (k 2t, 2t + 1; n g)               b1 = (k 2t + 8, 2t + 9; n g)
//   C (16 x 8, fp32), four registers:
//     c0, c1 = (row g, cols 2t, 2t + 1)      c2, c3 = (row g + 8, cols 2t, 2t + 1)
// So two neighbouring C tiles (16 columns), rounded to bf16, are exactly
// one A fragment: a product's result feeds the next product from
// registers (pack_a).
//
// Shared-memory rows are padded by 16 bytes, which puts the 8 rows that
// one ldmatrix phase touches on distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
// The same for 4 bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  union { __nv_bfloat162 h; uint32_t u; } pack;
  pack.h = __floats2bfloat162_rn(lo, hi);
  return pack.u;
}

// A fragments of 16 rows by 16 KS columns, row-major in shared memory
// (A points at the first row, stride ld): lanes 0-15 address rows 0-15 at
// column 16 kk, lanes 16-31 the same rows 8 columns on.
template <int KS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const __nv_bfloat16* A, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(a[kk], A + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
}

// A fragments of 16 rows by 16 KS columns of a matrix that shared memory
// holds transposed: A(m, k) = T[k * ld + m], T pointing at column m = 0.
template <int KS>
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[KS][4], const __nv_bfloat16* T, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4_trans(a[kk], T + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                                 ((lane >> 3) & 1) * 8);
}

// The C tiles of a (16, 8 NT) result as the A fragments of the next
// product over those 8 NT columns, rounded to bf16.
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// acc (16, 8 NT) += A . B^T: A (16, 16 KS) in register fragments, B
// (8 NT rows, 16 KS columns) row-major in shared memory, B^T(k, n) =
// B[n * ld + k].  NT is even.
template <int NT, int KS>
__device__ __forceinline__ void mma_a_bt(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                         const __nv_bfloat16* B, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int ni = 0; ni < NT; ni += 2) {
      // rows n of two n-tiles at columns 16 kk and 16 kk + 8
      uint32_t r[4];
      ldmatrix_x4(r, B + (ni * 8 + (lane & 7) + ((lane >> 4) << 3)) * ld + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(acc[ni], a[kk], r);
      mma_bf16(acc[ni + 1], a[kk], r + 2);
    }
  }
}

// acc (16, 8 NT) += A . B: A (16, 16 KS) in register fragments, B (16 KS
// rows, 8 NT columns) row-major in shared memory, B(k, n) = B[k * ld + n].
template <int NT, int KS>
__device__ __forceinline__ void mma_a_b(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                        const __nv_bfloat16* B, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int ni = 0; ni < NT; ni += 2) {
      // rows 16 kk .. 16 kk + 15 of two n-tiles, transposed into
      // col-major B fragments
      uint32_t r[4];
      ldmatrix_x4_trans(r, B + (kk * 16 + (lane & 15)) * ld + ni * 8 + (lane >> 4) * 8);
      mma_bf16(acc[ni], a[kk], r);
      mma_bf16(acc[ni + 1], a[kk], r + 2);
    }
  }
}

}  // namespace mma
