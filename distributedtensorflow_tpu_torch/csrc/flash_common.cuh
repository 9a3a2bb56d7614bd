// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_fused.cu).
//
// Tiles are kBQ query rows by kBK key rows, and a block of kThreads
// threads (four warps) computes one (kBQ, kBK) score tile at a time.
// There are two sets of pieces:
//
// - fp32 on the CUDA cores (every kernel in fp32): operands are widened to fp32 when they are
//   staged into shared memory (load_tile) and every product is an FMA
//   loop.  A thread holds a 4 x 8 patch of the score tile: rows
//   4*rg .. 4*rg+3 (rg = thread / 8) and the eight columns
//   col_of(cg, 0..7) (cg = thread % 8), interleaved in groups of four so
//   that the eight threads sharing rows read one 128-byte line of shared
//   memory in one float4 load.
//
// - bf16 on the tensor cores (every kernel in bf16; the bottom of this
//   file): tiles stay bf16 in shared memory,
//   copied there by cp.async (load_tile_async) into rows padded by 16
//   bytes, and every product is mma.sync.m16n8k16 with fp32 sums
//   (mma_common.cuh).  A warp owns 16 rows of the score tile in the
//   accumulator layout (lane l: rows g and g + 8, columns 8 ni + 2t and
//   2t + 1, g = l / 4, t = l % 4); the masks are applied on those
//   fragments (mask_fragments), or not at all where a tile pair lies
//   wholly inside the band and no key mask is given (pair_kind).  The
//   dk/dv sweep of the backward (dkv_prefetch, dkv_keys, dkv_pair,
//   dkv_store) is one code for both backward files.
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

#include "mma_common.cuh"

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

// ---------------------------------------------------------------------
// bf16 on the tensor cores

using bf16_t = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (ex2.approx: 2 ulp); 2^-inf is 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Elements of a bf16 tile's row in shared memory: D and 16 bytes of
// padding, so that the 8 rows of one ldmatrix phase lie on distinct banks
// and every row starts 16-byte aligned.
template <int D>
__host__ __device__ constexpr int tile_ld() { return D + 8; }

// Start copying rows [row0, row0 + ROWS) of one (batch, head) of a bf16
// BSHD operand into shared memory (sm[r * tile_ld<D>() + c]) by cp.async,
// rows at or past `s` as zeros.  The caller commits and waits.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(const bf16_t* base, long long row_stride, int row0,
                                                int s, bf16_t* sm) {
  constexpr int kParts = D / 8;
  for (int c = threadIdx.x; c < ROWS * kParts; c += kThreads) {
    const int r = c / kParts, part = c % kParts;
    const bool valid = row0 + r < s;
    const bf16_t* src = valid ? base + static_cast<long long>(row0 + r) * row_stride + part * 8 : base;
    mma::cp_async16(sm + r * tile_ld<D>() + part * 8, src, valid);
  }
}

// What the tile pair (queries from q0, keys from k0) needs of the masks.
// kPlain: nothing (no key mask or segment ids, both tiles inside the
// sequence, no key after a query of the tile and none at or below a
// query's window): its scores are the scaled products.  kDiagonal: the
// same but for keys after their query under the causal mask
// (causal_fragments).  kMasked: everything (mask_fragments).
enum PairKind { kPlain, kDiagonal, kMasked };

__device__ __forceinline__ PairKind pair_kind(int q0, int k0, int s, int causal, int window,
                                              bool key_masks) {
  if (key_masks || q0 + kBQ > s || k0 + kBK > s || (window > 0 && k0 <= q0 + kBQ - 1 - window))
    return kMasked;
  return causal && k0 + kBK - 1 > q0 ? kDiagonal : kPlain;
}

// The causal mask alone on a warp's (16, 64) accumulator fragments of raw
// products, rows and columns as in mask_fragments: a key after its query
// becomes -inf, which weighs 0 through a plain pair's arithmetic.
template <bool kKeyRows>
__device__ __forceinline__ void causal_fragments(float (&sc)[8][4], int row0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rpos = row0 + g + 8 * (e >> 1), cpos = col0 + ni * 8 + 2 * t + (e & 1);
      if (kKeyRows ? rpos > cpos : cpos > rpos) sc[ni][e] = -INFINITY;
    }
}

// The masked, scaled scores of a warp's (16, 64) accumulator fragments,
// in place (`sc` holds the raw products).  kKeyRows = false: rows are
// queries (the forward), transposed otherwise (the backward's S^T).  The
// rows g and g + 8 of this lane lie at positions row0 + g and row0 + g + 8
// and carry their key state (kKeyRows only) and segment in registers;
// column c lies at col0 + c and reads its key state (queries as rows
// only) and segment from shared memory (`col_seg` may be null: all 0).
template <bool kKeyRows>
__device__ __forceinline__ void mask_fragments(float (&sc)[8][4], float scale, int row0,
                                               const int (&row_state)[2], const int (&row_seg)[2],
                                               int col0, const int* col_state, const int* col_seg,
                                               int s, int causal, int window) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, c = ni * 8 + 2 * t + (e & 1);
      const int rpos = row0 + g + 8 * r, cpos = col0 + c;
      const int cseg = col_seg ? col_seg[c] : 0;
      if constexpr (kKeyRows)
        sc[ni][e] = cpos < s ? masked_score(sc[ni][e], scale, cpos, rpos, row_state[r], cseg,
                                            row_seg[r], causal, window)
                             : -INFINITY;
      else
        sc[ni][e] = masked_score(sc[ni][e], scale, rpos, cpos, col_state[c], row_seg[r], cseg,
                                 causal, window);
    }
}

// ---------------------------------------------------------------------
// The dk/dv sweep in bf16, one code for the single sweep K3f
// (flash_bwd_fused.cu) and the split pair's dk/dv kernel (flash_bwd.cu), so
// that their dk and dv are the same products in the same order.  A warp
// owns 16 keys of the key tile at k0 (positions krow .. krow + 15): K and
// V are its A fragments, dk and dv its accumulators, and the query tiles
// with the LSE, delta and segment of their rows come two buffers deep.
// `A` is the kernel's argument struct (q, g, lse, delta, mask, seg, kseg,
// qs, gs, h, hkv, s, causal, window, scale): the queries read seg, the
// keys kseg.

// Start the copies of query tile q0 of head h (batch b) into one buffer:
// the Q and dO tiles and the LSE, delta and segment of the rows.  Commits.
template <int D, typename A>
__device__ __forceinline__ void dkv_prefetch(const A& a, int b, int h, int q0, bf16_t* Qs,
                                             bf16_t* Gs, float* lse, float* dl, int* sg) {
  const bf16_t* qb = static_cast<const bf16_t*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16_t* gb = static_cast<const bf16_t*>(a.g) + b * a.gs.b + h * a.gs.h;
  load_tile_async<D, kBQ>(qb, a.qs.s, q0, a.s, Qs);
  load_tile_async<D, kBQ>(gb, a.gs.s, q0, a.s, Gs);
  const int tid = threadIdx.x;
  if (tid < kBQ) {
    const int qp = q0 + tid;
    const bool in = qp < a.s;
    const long long row = (static_cast<long long>(b) * a.h + h) * a.s + (in ? qp : 0);
    mma::cp_async4(&lse[tid], a.lse + row, in);
    mma::cp_async4(&dl[tid], a.delta + row, in);
    sg[tid] = segment(a.seg, b, a.s, qp);
  }
  mma::cp_async_commit();
}

// The warp's keys: its K and V rows (Kw, Vw in shared memory) as A
// fragments, the key state and segment of the lane's rows, dk = dv = 0.
template <int D, typename A>
__device__ __forceinline__ void dkv_keys(const A& a, int b, int krow, const bf16_t* Kw,
                                         const bf16_t* Vw, uint32_t (&kf)[D / 16][4],
                                         uint32_t (&vf)[D / 16][4], int (&kst)[2], int (&ksg)[2],
                                         float (&dk)[D / 8][4], float (&dv)[D / 8][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  mma::load_a<D / 16>(kf, Kw, tile_ld<D>());
  mma::load_a<D / 16>(vf, Vw, tile_ld<D>());
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kst[r] = key_state(a.mask, b, a.s, krow + g + 8 * r);
    ksg[r] = segment(a.kseg, b, a.s, krow + g + 8 * r);
  }
#pragma unroll
  for (int ni = 0; ni < D / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[ni][e] = dv[ni][e] = 0.f;
}

// One (query tile at q0, key tile at k0) pair for the warp's keys.  S^T =
// K.Q^T and dP^T = V.dO^T have the keys as rows, and the masks are applied
// transposed.  A plain pair keeps the raw products (a pair on the causal
// diagonal with -inf for the keys after their query): its p = exp(s -
// lse) is one FMA (scale log2(e) folded in) and one ex2 per element.  A
// masked pair holds the scaled, masked scores, and NEG_INF cancels exactly
// against an LSE of NEG_INF.  Then ds = p (dp - delta) scale; rounded to
// bf16, P^T and dS^T are the A fragments (k = the queries) of dv += P^T.dO
// and dk += dS^T.Q, with dO and Q read by ldmatrix.trans.  dS^T's
// fragments are left in `sf` for a caller that forms the dq partial too.
template <int D, typename A>
__device__ __forceinline__ void dkv_pair(const A& a, int krow, int k0, int q0, bool key_masks,
                                         const uint32_t (&kf)[D / 16][4],
                                         const uint32_t (&vf)[D / 16][4], const int (&kst)[2],
                                         const int (&ksg)[2], const bf16_t* Qb, const bf16_t* Gb,
                                         const float* qlse, const float* qdl, const int* qsg,
                                         float (&dk)[D / 8][4], float (&dv)[D / 8][4],
                                         uint32_t (&sf)[4][4]) {
  constexpr int LD = tile_ld<D>(), KS = D / 16, NT = D / 8;
  const int t = threadIdx.x & 3;
  float st[8][4], dpt[8][4];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[ni][e] = dpt[ni][e] = 0.f;
  mma::mma_a_bt<8, KS>(st, kf, Qb, LD);
  mma::mma_a_bt<8, KS>(dpt, vf, Gb, LD);
  const PairKind kind = pair_kind(q0, k0, a.s, a.causal, a.window, key_masks);
  if (kind == kMasked)
    mask_fragments<true>(st, a.scale, krow, kst, ksg, q0, nullptr, a.seg ? qsg : nullptr, a.s,
                         a.causal, a.window);
  else if (kind == kDiagonal)
    causal_fragments<true>(st, krow, q0);
  // p into st
  if (kind != kMasked) {
    const float c2 = a.scale * kLog2e;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float2 lse = *reinterpret_cast<const float2*>(&qlse[ni * 8 + 2 * t]);
      const float lx = lse.x * kLog2e, ly = lse.y * kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) st[ni][e] = fast_exp2(fmaf(st[ni][e], c2, -((e & 1) ? ly : lx)));
    }
  } else {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float2 lse = *reinterpret_cast<const float2*>(&qlse[ni * 8 + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e) st[ni][e] = __expf(st[ni][e] - ((e & 1) ? lse.y : lse.x));
    }
  }
  // ds into dpt
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const float2 dl = *reinterpret_cast<const float2*>(&qdl[ni * 8 + 2 * t]);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[ni][e] = (st[ni][e] * (dpt[ni][e] - ((e & 1) ? dl.y : dl.x))) * a.scale;
  }
  uint32_t pf[4][4];
  mma::pack_a<8>(pf, st);
  mma::pack_a<8>(sf, dpt);
  mma::mma_a_b<NT, 4>(dv, pf, Gb, LD);
  mma::mma_a_b<NT, 4>(dk, sf, Qb, LD);
}

// dk and dv of the warp's keys, rounded to bf16, into their contiguous
// (B, S, Hkv, D) rows.
template <int D, typename A>
__device__ __forceinline__ void dkv_store(const A& a, int b, int hk, int krow,
                                          const float (&dk)[D / 8][4],
                                          const float (&dv)[D / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16_t* dkb = static_cast<bf16_t*>(a.dk);
  bf16_t* dvb = static_cast<bf16_t*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = krow + g + 8 * r;
    if (kp >= a.s) continue;
    const long long off =
        (static_cast<long long>(b) * a.s + kp) * a.hkv * D + static_cast<long long>(hk) * D;
#pragma unroll
    for (int ni = 0; ni < D / 8; ++ni) {
      *reinterpret_cast<uint32_t*>(dkb + off + ni * 8 + 2 * t) =
          mma::pack_bf16(dk[ni][2 * r], dk[ni][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvb + off + ni * 8 + 2 * t) =
          mma::pack_bf16(dv[ni][2 * r], dv[ni][2 * r + 1]);
    }
  }
}

}  // namespace flash
