// Shared pieces of the fused LM-head kernels' fp32 paths (the CUDA-core
// kernels of fused_xent_fwd.cu and fused_xent_bwd.cu; in bf16 both files
// run wgmma and TMA, sm90_common.cuh).
//
// Every kernel of the head computes tiles of logits = x . w^T, x (N, D)
// the tokens' hidden states and w (V, D) the tied table, with fp32
// products and sums.  A block owns OWN rows of one operand (tokens in the
// forward and dx, vocab rows in dw) and streams the other in tiles of
// kStream rows.  The logits of one (OWN, kStream) tile are the product of
// the two row sets over D, taken in chunks of kKC columns staged in shared
// memory by cp.async, two buffers deep: the copy of chunk c + 1 is in
// flight while chunk c is multiplied.
//
// Warp tiles follow the fragments of mma.sync.m16n8k16 (mma_common.cuh):
// a warp holds m-tiles of 16 rows by n-tiles of 8 columns, and lane l
// holds, in acc[0..3], rows g and g + 8 (g = l / 4) by columns 2t and
// 2t + 1 (t = l % 4) of each, summed with FMAs on the CUDA cores.
// Shared-memory rows are padded by 16 bytes, which puts the 8 rows that
// one fragment load touches on distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace xent {

using namespace mma;  // cp.async (shared with the flash kernels)

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStream = 128;  // streamed rows per tile: 8 warps x 16
constexpr int kKC = 64;       // depth of a staged chunk of the logits product
constexpr float kInit = -1e30f;  // running max before the first valid logit

template <typename T>
__host__ __device__ constexpr int pad() { return 16 / static_cast<int>(sizeof(T)); }

// Start copying rows [row0, row0 + R) and columns [col0, col0 + C) of
// the row-major (nrows, ld) matrix g into shared memory (row stride
// sld), rows at or past nrows as zeros.  16-byte pieces: ld and col0 are
// multiples of 8 elements.  The caller commits and waits.
template <typename T, int R, int C>
__device__ __forceinline__ void load_rows(const T* g, int ld, int row0, int nrows, int col0,
                                          T* s, int sld) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = C / kVec;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool valid = row0 + r < nrows;
    const T* src = valid ? g + static_cast<long long>(row0 + r) * ld + col0 + c : g;
    cp_async16(s + r * sld + c, src, valid);
  }
}

// acc[MT][NT] += A . B over K columns, A (16 MT rows, K) row-major in
// shared memory (stride lda), B given as "nt": (8 NT rows, K) row-major,
// B(k, n) = B[n * ldb + k]; or "nn": (K, 8 NT) row-major, B(k, n) =
// B[k * ldb + n] (fp32 only: K4b's CUDA-core kernel).  NT is even.
template <typename T, int MT, int NT, int K, bool NN>
struct WarpMma;

template <int MT, int NT, int K, bool NN>
struct WarpMma<float, MT, NT, K, NN> {
  static __device__ __forceinline__ void run(const float* A, int lda, const float* B, int ldb,
                                             float (&acc)[MT][NT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[MT][2], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        a[mi][0] = A[(mi * 16 + g) * lda + k];
        a[mi][1] = A[(mi * 16 + g + 8) * lda + k];
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int n = ni * 8 + 2 * t;
        b[ni][0] = NN ? B[k * ldb + n] : B[n * ldb + k];
        b[ni][1] = NN ? B[k * ldb + n + 1] : B[(n + 1) * ldb + k];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          acc[mi][ni][0] = fmaf(a[mi][0], b[ni][0], acc[mi][ni][0]);
          acc[mi][ni][1] = fmaf(a[mi][0], b[ni][1], acc[mi][ni][1]);
          acc[mi][ni][2] = fmaf(a[mi][1], b[ni][0], acc[mi][ni][2]);
          acc[mi][ni][3] = fmaf(a[mi][1], b[ni][1], acc[mi][ni][3]);
        }
    }
  }
};

// Shared-memory elements of the staged chunks of one logits tile (two
// buffers).
template <typename T, int OWN>
__host__ __device__ constexpr int logits_smem_elems() {
  return 2 * (OWN + kStream) * (kKC + pad<T>());
}

// The (OWN, kStream) fp32 logits tile of owned rows [own0, own0 + OWN)
// of `own` (n_own, d) against streamed rows [str0, str0 + kStream) of
// `str` (n_str, d).  Warp w gets columns [16 w, 16 w + 16) of the tile:
// acc[mi][ni] covers rows mi * 16 + {g, g + 8} and columns
// 16 w + ni * 8 + {2t, 2t + 1}.  Rows past either end give logits of 0
// (the callers mask them).  `smem` holds logits_smem_elems<T, OWN>().
template <typename T, int OWN>
__device__ __forceinline__ void logits_tile(const T* own, int n_own, int own0, const T* str,
                                            int n_str, int str0, int d, T* smem,
                                            float (&acc)[OWN / 16][2][4]) {
  constexpr int ld = kKC + pad<T>();
  constexpr int buf = (OWN + kStream) * ld;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int mi = 0; mi < OWN / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  auto prefetch = [&](int c) {
    T* sA = smem + (c & 1) * buf;
    load_rows<T, OWN, kKC>(own, d, own0, n_own, c * kKC, sA, ld);
    load_rows<T, kStream, kKC>(str, d, str0, n_str, c * kKC, sA + OWN * ld, ld);
    cp_async_commit();
  };
  const int chunks = d / kKC;
  __syncthreads();  // the previous users of the buffers are done
  prefetch(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      prefetch(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sA = smem + (c & 1) * buf;
    WarpMma<T, OWN / 16, 2, kKC, false>::run(sA, ld, sA + (OWN + warp * 16) * ld, ld, acc);
    __syncthreads();  // chunk c + 2 goes into this buffer next
  }
}

}  // namespace xent
