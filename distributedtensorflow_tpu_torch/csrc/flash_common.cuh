// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_fused.cu).
//
// Tiles are kBQ query rows by kBK key rows; a block of kThreads threads
// computes one (kBQ, kBK) score tile at a time, each thread a 4 x 8
// patch of it: rows 4*rg .. 4*rg+3 (rg = thread / 8) and the eight
// columns col_of(cg, 0..7) (cg = thread % 8).  The columns of a thread
// are interleaved in groups of four, so that the eight threads sharing
// rows read one 128-byte line of shared memory in one float4 load.
// Operands are widened to fp32 when they are staged into shared memory;
// every product and sum is fp32.
//
// Masking follows `_masked_scores` (distributedtensorflow_tpu/ops/
// flash_attention.py:225): a key beyond the sequence, after the query
// (causal) or at or below `q - window` is left out (-inf: it weighs 0);
// a key that the padding mask drops, or of another packed segment, gets
// the finite NEG_INF = -1e9 of the JAX package, so a row that only such
// keys reach averages V over its causal band instead of giving NaN.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kPad = 4;            // floats added to a transposed tile's row
constexpr float kNegInf = -1e9f;   // NEG_INF of ops/attention.py

// Strides in elements of one BSHD operand (the head dim is contiguous).
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  union { uint4 u; __nv_bfloat162 h[4]; } pack;
  pack.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pack.h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  union { uint2 u; __nv_bfloat162 h[2]; } pack;
  pack.h[0] = __floats2bfloat162_rn(v[0], v[1]);
  pack.h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = pack.u;
}

// x rounded to T and widened back: where the TPU kernels cast a tile to
// an operand's dtype before a product.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int col_of(int cg, int j) { return (j >> 2) * 32 + cg * 4 + (j & 3); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Rows [row0, row0 + ROWS) of one (batch, head) of a BSHD operand into
// shared memory as fp32, rows at or past `s` as zeros: row-major
// (rm[r * D + c]) and/or transposed (tr[c * (ROWS + kPad) + r]).
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(const T* base, long long row_stride, int row0,
                                          int s, float* rm, float* tr) {
  constexpr int kParts = D / 8;
  for (int c = threadIdx.x; c < ROWS * kParts; c += kThreads) {
    const int r = c / kParts, part = c % kParts;
    float v[8];
    if (row0 + r < s) {
      load8(base + static_cast<long long>(row0 + r) * row_stride + part * 8, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    if (rm) {
      *reinterpret_cast<float4*>(rm + r * D + part * 8) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(rm + r * D + part * 8 + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
    if (tr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) tr[(part * 8 + e) * (ROWS + kPad) + r] = v[e];
    }
  }
}

// Key state of one position: 0 past the sequence, 1 attended, 2 dropped
// by the padding mask.
__device__ __forceinline__ int key_state(const unsigned char* mask, int b, int s, int pos) {
  if (pos >= s) return 0;
  return (!mask || mask[static_cast<long long>(b) * s + pos]) ? 1 : 2;
}

__device__ __forceinline__ int segment(const int* seg, int b, int s, int pos) {
  return (seg && pos < s) ? seg[static_cast<long long>(b) * s + pos] : 0;
}

// The masked, scaled score of query qpos against key kpos (see the top
// of this file).  `dot` is the fp32 q.k product.
__device__ __forceinline__ float masked_score(float dot, float scale, int qpos, int kpos,
                                              int kstate, int qseg, int kseg, int causal,
                                              int window) {
  if (kstate == 0 || (causal && kpos > qpos) || (window > 0 && kpos <= qpos - window))
    return -INFINITY;
  if (kstate == 2 || qseg != kseg) return kNegInf;
  return dot * scale;
}

// First and last key tile that a query tile starting at q0 reaches (the
// band of `_band_run`, ops/flash_attention.py:278).
__device__ __forceinline__ void key_band(int q0, int s, int causal, int window, int* lo, int* hi) {
  *hi = (s + kBK - 1) / kBK - 1;
  if (causal) *hi = min(*hi, (q0 + kBQ - 1) / kBK);
  *lo = 0;
  if (window > 0 && q0 - window + 1 > 0) *lo = (q0 - window + 1) / kBK;
}

// First and last query tile that reaches the key tile starting at k0.
__device__ __forceinline__ void query_band(int k0, int s, int causal, int window, int* lo,
                                           int* hi) {
  *lo = causal ? k0 / kBQ : 0;
  *hi = (s + kBQ - 1) / kBQ - 1;
  if (window > 0) *hi = min(*hi, (k0 + kBK - 1 + window - 1) / kBQ);
}

}  // namespace flash
