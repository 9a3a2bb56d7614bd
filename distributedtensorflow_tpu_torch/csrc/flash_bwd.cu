// Flash-attention backward for Hopper (sm_90a): a dq kernel and a dk/dv kernel.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (distributedtensorflow_tpu/ops/flash_attention.py:671 and :724,
// launched by `_flash_backward_pallas_bhsd` at :945 and :984), which the
// TPU takes when its dq scratch does not fit VMEM or the caller forces
// the split pair; the single sweep `_bwd_fused_kernel` (:586) is
// flash_bwd_fused.cu.  Same function: from q, k, v, dO, the
// forward's LSE and delta = rowsum(dO * O) (both (B, H, S) fp32, passed
// in, so ring attention can drive the same kernels with global rows),
//   p  = exp(s - lse),  dv = sum_q p^T dO,  dp = dO v^T,
//   ds = p * (dp - delta) * scale,  dq = ds k,  dk = ds^T q,
// with s the masked, scaled scores of the forward (flash_common.cuh).
// Rounding points of the TPU kernels: p is rounded to dO's type before
// the dv product (:760), ds to q's type before the dk product (:770) and
// to k's type before the dq product (:712; the port's operands share one
// type); sums are fp32.  Under GQA, dk and dv of a kv head sum the query
// heads of its group in fp32 before one rounding (the JAX path rounds
// each head's share, then sums).
//
// What bounds it on the H100: operations.  The split form recomputes s
// and dp in both kernels: dq takes three products (s, dp, dq) and dk/dv
// four (s, dp, dv, dk) of 2 * B * H * S^2 * D flops each, half under the
// causal mask, where the single sweep needs five in all.
//
// Design: the split pair, deterministic, no atomics.  The dq kernel runs
// one block per (query tile, head, batch), heaviest causal tiles first,
// and loops over the key tiles of the band; the dk/dv kernel runs one
// block per (key tile, kv head, batch) and loops over the query tiles of
// the band of every query head of its group, so the GQA sum needs no
// atomics either.
//
// bf16 (flash_bwd_dq_mma_kernel, flash_bwd_dkv_mma_kernel): every product
// runs on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32 sums), from
// the tile code of the forward and of K3f (mma_common.cuh and the bf16
// half of flash_common.cuh).  Both keep their own tile in registers as A
// fragments for the whole sweep and stream the other side's tiles two
// buffers deep by cp.async; the tile they keep is staged through the
// second buffer before its first use, so a block needs 36 KB of shared
// memory at D 64.
// - dq: each of the four warps owns 16 query rows; Q and dO are its A
//   fragments.  S = Q.K^T and dP = dO.V^T have the queries as rows, the
//   forward's layout, so the masks are the forward's (mask_fragments with
//   key columns, the causal one alone on the diagonal).  p and ds are
//   formed on the accumulator fragments with the row's LSE and delta kept
//   in registers; ds rounded to bf16 is the A fragment of dq += dS.K, with
//   K read by ldmatrix.trans.  dq never leaves registers until the end.
// - dk/dv: K3f's kernel without its dq partial, turn and ticket: the same
//   dk/dv sweep (flash_common.cuh, dkv_pair), so its dk and dv equal
//   K3f's bit for bit.  Each warp owns 16 keys, K and V are its A
//   fragments, and the scores are computed transposed (S^T = K.Q^T, dP^T =
//   V.dO^T, keys as rows); P^T and dS^T rounded to bf16 are the A
//   fragments of dv += P^T.dO and dk += dS^T.Q straight from registers,
//   with dO and Q read by ldmatrix.trans.
// fp32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): FMAs on the CUDA cores
// (the tensor cores have no full-precision fp32 product); tiles and thread
// patches as in flash_fwd.cu, the ds and p tiles going through shared
// memory to the products that contract over their other axis.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;       // dO, (B, S, H, D)
  const float* lse;    // (B, H, S)
  const float* delta;  // (B, H, S)
  void* dq;            // (B, S, H, D) contiguous, q's type
  void* dk;            // (B, S, Hkv, D) contiguous
  void* dv;
  const unsigned char* mask;
  const int* seg;   // the queries' segments
  const int* kseg;  // the keys' (seg when no second array)
  Strides qs, ks, vs, gs;
  int b, h, hkv, s, causal, window;
  float scale;
};

template <int D>
constexpr int dq_smem_floats() {
  return 2 * D * (kBQ + kPad) + 2 * D * (kBK + kPad) + kBK * D + kBK * (kBQ + kPad);
}

template <int D>
constexpr int dkv_smem_floats() {
  return 2 * D * (kBK + kPad) + 2 * D * (kBQ + kPad) + 2 * kBQ * D + 2 * kBQ * (kBK + kPad);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int DC = D / 8;
  constexpr int QT = kBQ + kPad, KT = kBK + kPad;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QT]
  float* Gt = Qt + D * QT;                       // [D][QT] dO
  float* Kt = Gt + D * QT;                       // [D][KT]
  float* Vt = Kt + D * KT;                       // [D][KT]
  float* Ks = Vt + D * KT;                       // [kBK][D]
  float* St = Ks + kBK * D;                      // [kBK][QT] ds
  __shared__ int kstate[kBK];
  __shared__ int kseg[kBK];

  const int nq = (a.s + kBQ - 1) / kBQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qi * kBQ;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* gb = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  load_tile<T, D, kBQ>(qb, a.qs.s, q0, a.s, nullptr, Qt);
  load_tile<T, D, kBQ>(gb, a.gs.s, q0, a.s, nullptr, Gt);
  const long long row_base = (static_cast<long long>(b) * a.h + h) * a.s;
  int qpos[4], qseg[4];
  float lse[4], dl[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q0 + rg * 4 + i;
    qseg[i] = segment(a.seg, b, a.s, qpos[i]);
    const bool in = qpos[i] < a.s;
    lse[i] = in ? a.lse[row_base + qpos[i]] : 0.f;
    dl[i] = in ? a.delta[row_base + qpos[i]] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kj_lo, kj_hi;
  key_band(q0, a.s, a.causal, a.window, &kj_lo, &kj_hi);
  for (int kj = kj_lo; kj <= kj_hi; ++kj) {
    const int k0 = kj * kBK;
    __syncthreads();
    load_tile<T, D, kBK>(kb, a.ks.s, k0, a.s, Ks, Kt);
    load_tile<T, D, kBK>(vb, a.vs.s, k0, a.s, nullptr, Vt);
    for (int r = tid; r < kBK; r += kThreads) {
      kstate[r] = key_state(a.mask, b, a.s, k0 + r);
      kseg[r] = segment(a.kseg, b, a.s, k0 + r);
    }
    __syncthreads();

    float sc[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = ld4(Qt + d * QT + rg * 4);
      const float4 gv = ld4(Gt + d * QT + rg * 4);
      const float4 k0v = ld4(Kt + d * KT + cg * 4), k1v = ld4(Kt + d * KT + 32 + cg * 4);
      const float4 v0v = ld4(Vt + d * KT + cg * 4), v1v = ld4(Vt + d * KT + 32 + cg * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w}, ga[4] = {gv.x, gv.y, gv.z, gv.w};
      const float ka[8] = {k0v.x, k0v.y, k0v.z, k0v.w, k1v.x, k1v.y, k1v.z, k1v.w};
      const float va[8] = {v0v.x, v0v.y, v0v.z, v0v.w, v1v.x, v1v.y, v1v.z, v1v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
          dp[i][j] = fmaf(ga[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = col_of(cg, j);
        const float s = masked_score(sc[i][j], a.scale, qpos[i], k0 + kc, kstate[kc], qseg[i],
                                     kseg[kc], a.causal, a.window);
        const float p = expf(s - lse[i]);
        St[kc * QT + rg * 4 + i] = round_to<T>((p * (dp[i][j] - dl[i])) * a.scale);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 sv = ld4(St + kk * QT + rg * 4);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
      float ka[DC];
#pragma unroll
      for (int c4 = 0; c4 < DC / 4; ++c4) {
        const float4 k4 = ld4(Ks + kk * D + c4 * 32 + cg * 4);
        ka[c4 * 4] = k4.x; ka[c4 * 4 + 1] = k4.y; ka[c4 * 4 + 2] = k4.z; ka[c4 * 4 + 3] = k4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(sa[i], ka[c], acc[i][c]);
    }
  }

  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] >= a.s) continue;
    T* row = dqb + (static_cast<long long>(b) * a.s + qpos[i]) * a.h * D + static_cast<long long>(h) * D;
#pragma unroll
    for (int c4 = 0; c4 < DC / 4; ++c4) store4(row + c4 * 32 + cg * 4, &acc[i][c4 * 4]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int DC = D / 8;
  constexpr int QT = kBQ + kPad, KT = kBK + kPad;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][KT]
  float* Vt = Kt + D * KT;                       // [D][KT]
  float* Qt = Vt + D * KT;                       // [D][QT]
  float* Gt = Qt + D * QT;                       // [D][QT] dO
  float* Qs = Gt + D * QT;                       // [kBQ][D]
  float* Gs = Qs + kBQ * D;                      // [kBQ][D] dO
  float* Ps = Gs + kBQ * D;                      // [kBQ][KT] p, rounded
  float* Ss = Ps + kBQ * KT;                     // [kBQ][KT] ds, rounded
  __shared__ float qlse[kBQ];
  __shared__ float qdl[kBQ];
  __shared__ int qseg[kBQ];

  const int kj = blockIdx.x;  // low key tiles have the most causal work
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.h / a.hkv;
  const int k0 = kj * kBK;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  load_tile<T, D, kBK>(kb, a.ks.s, k0, a.s, nullptr, Kt);
  load_tile<T, D, kBK>(vb, a.vs.s, k0, a.s, nullptr, Vt);
  int kpos[4], kst[4], ksg[4];
  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    kpos[i] = k0 + rg * 4 + i;
    kst[i] = key_state(a.mask, b, a.s, kpos[i]);
    ksg[i] = segment(a.kseg, b, a.s, kpos[i]);
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  int qi_lo, qi_hi;
  query_band(k0, a.s, a.causal, a.window, &qi_lo, &qi_hi);
  for (int hg = 0; hg < group; ++hg) {
    const int h = hk * group + hg;
    const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
    const T* gb = static_cast<const T*>(a.g) + b * a.gs.b + h * a.gs.h;
    const long long row_base = (static_cast<long long>(b) * a.h + h) * a.s;
    for (int qi = qi_lo; qi <= qi_hi; ++qi) {
      const int q0 = qi * kBQ;
      __syncthreads();
      load_tile<T, D, kBQ>(qb, a.qs.s, q0, a.s, Qs, Qt);
      load_tile<T, D, kBQ>(gb, a.gs.s, q0, a.s, Gs, Gt);
      for (int r = tid; r < kBQ; r += kThreads) {
        const int qp = q0 + r;
        const bool in = qp < a.s;
        qlse[r] = in ? a.lse[row_base + qp] : 0.f;
        qdl[r] = in ? a.delta[row_base + qp] : 0.f;
        qseg[r] = segment(a.seg, b, a.s, qp);
      }
      __syncthreads();

      // transposed tiles: rows are this thread's 4 keys, columns 8 queries
      float st[4][8], dpt[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kv = ld4(Kt + d * KT + rg * 4);
        const float4 vv = ld4(Vt + d * KT + rg * 4);
        const float4 q0v = ld4(Qt + d * QT + cg * 4), q1v = ld4(Qt + d * QT + 32 + cg * 4);
        const float4 g0v = ld4(Gt + d * QT + cg * 4), g1v = ld4(Gt + d * QT + 32 + cg * 4);
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w}, va[4] = {vv.x, vv.y, vv.z, vv.w};
        const float qa[8] = {q0v.x, q0v.y, q0v.z, q0v.w, q1v.x, q1v.y, q1v.z, q1v.w};
        const float ga[8] = {g0v.x, g0v.y, g0v.z, g0v.w, g1v.x, g1v.y, g1v.z, g1v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            st[i][j] = fmaf(qa[j], ka[i], st[i][j]);
            dpt[i][j] = fmaf(ga[j], va[i], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qc = col_of(cg, j);
          const int qp = q0 + qc;
          const float s = qp < a.s ? masked_score(st[i][j], a.scale, qp, kpos[i], kst[i],
                                                  qseg[qc], ksg[i], a.causal, a.window)
                                   : -INFINITY;
          const float p = expf(s - qlse[qc]);
          Ps[qc * KT + rg * 4 + i] = round_to<T>(p);
          Ss[qc * KT + rg * 4 + i] = round_to<T>((p * (dpt[i][j] - qdl[qc])) * a.scale);
        }
      __syncthreads();

#pragma unroll 2
      for (int qq = 0; qq < kBQ; ++qq) {
        const float4 pv = ld4(Ps + qq * KT + rg * 4);
        const float4 sv = ld4(Ss + qq * KT + rg * 4);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w}, sa[4] = {sv.x, sv.y, sv.z, sv.w};
        float ga[DC], qa[DC];
#pragma unroll
        for (int c4 = 0; c4 < DC / 4; ++c4) {
          const float4 g4 = ld4(Gs + qq * D + c4 * 32 + cg * 4);
          const float4 q4 = ld4(Qs + qq * D + c4 * 32 + cg * 4);
          ga[c4 * 4] = g4.x; ga[c4 * 4 + 1] = g4.y; ga[c4 * 4 + 2] = g4.z; ga[c4 * 4 + 3] = g4.w;
          qa[c4 * 4] = q4.x; qa[c4 * 4 + 1] = q4.y; qa[c4 * 4 + 2] = q4.z; qa[c4 * 4 + 3] = q4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv[i][c] = fmaf(pa[i], ga[c], dv[i][c]);
            dk[i][c] = fmaf(sa[i], qa[c], dk[i][c]);
          }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kpos[i] >= a.s) continue;
    const long long off =
        (static_cast<long long>(b) * a.s + kpos[i]) * a.hkv * D + static_cast<long long>(hk) * D;
#pragma unroll
    for (int c4 = 0; c4 < DC / 4; ++c4) {
      store4(dkb + off + c4 * 32 + cg * 4, &dk[i][c4 * 4]);
      store4(dvb + off + c4 * 32 + cg * 4, &dv[i][c4 * 4]);
    }
  }
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores

template <int D>
constexpr int bwd_mma_smem_bytes() {
  return 4 * kBQ * tile_ld<D>() * static_cast<int>(sizeof(bf16_t));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3) flash_bwd_dq_mma_kernel(const BwdArgs a) {
  using namespace mma;
  constexpr int LD = tile_ld<D>(), KS = D / 16, NT = D / 8;
  static_assert(kBQ == kBK, "Q and dO are staged in the key tiles' second buffers");
  extern __shared__ float4 smem4[];
  bf16_t* Ks = reinterpret_cast<bf16_t*>(smem4);  // [2][kBK][LD]; Q at first in buffer 1
  bf16_t* Vs = Ks + 2 * kBK * LD;                  // [2][kBK][LD]; dO at first in buffer 1
  __shared__ int kstate[2][kBK];
  __shared__ int kseg[2][kBK];

  const int nq = (a.s + kBQ - 1) / kBQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qi * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bf16_t* qb = static_cast<const bf16_t*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16_t* gb = static_cast<const bf16_t*>(a.g) + b * a.gs.b + h * a.gs.h;
  const bf16_t* kb = static_cast<const bf16_t*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16_t* vb = static_cast<const bf16_t*>(a.v) + b * a.vs.b + hk * a.vs.h;
  const bool key_masks = a.mask != nullptr || a.seg != nullptr;

  int kj_lo, kj_hi;
  key_band(q0, a.s, a.causal, a.window, &kj_lo, &kj_hi);
  // start the copy of key tile kj into buffer (kj - kj_lo) % 2
  auto prefetch = [&](int kj) {
    const int buf = (kj - kj_lo) & 1, k0 = kj * kBK;
    load_tile_async<D, kBK>(kb, a.ks.s, k0, a.s, Ks + buf * kBK * LD);
    load_tile_async<D, kBK>(vb, a.vs.s, k0, a.s, Vs + buf * kBK * LD);
    if (tid < kBK) {
      kstate[buf][tid] = key_state(a.mask, b, a.s, k0 + tid);
      kseg[buf][tid] = segment(a.kseg, b, a.s, k0 + tid);
    }
    cp_async_commit();
  };
  load_tile_async<D, kBQ>(qb, a.qs.s, q0, a.s, Ks + kBK * LD);
  load_tile_async<D, kBQ>(gb, a.gs.s, q0, a.s, Vs + kBK * LD);
  prefetch(kj_lo);

  // this lane's rows g and g + 8 of the warp's 16 queries: LSE and delta
  // in registers, scaled by log2(e) for the plain pairs' exp2
  const int qrow = q0 + warp * 16;
  const int no_state[2] = {1, 1};
  const long long row_base = (static_cast<long long>(b) * a.h + h) * a.s;
  int qseg[2];
  float lse[2], lse2[2], dl[2], dq[NT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qrow + g + 8 * r;
    const bool in = qp < a.s;
    qseg[r] = segment(a.seg, b, a.s, qp);
    lse[r] = in ? a.lse[row_base + qp] : 0.f;
    lse2[r] = lse[r] * kLog2e;
    dl[r] = in ? a.delta[row_base + qp] : 0.f;
  }
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[ni][e] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KS][4], gf[KS][4];
  load_a<KS>(qf, Ks + kBK * LD + warp * 16 * LD, LD);
  load_a<KS>(gf, Vs + kBK * LD + warp * 16 * LD, LD);

  for (int kj = kj_lo; kj <= kj_hi; ++kj) {
    const int buf = (kj - kj_lo) & 1, k0 = kj * kBK;
    // tile kj has landed, and every warp is done with tile kj - 1 (at
    // first: with Q's and dO's fragments), whose buffer the next copy
    // overwrites
    cp_async_wait<0>();
    __syncthreads();
    if (kj < kj_hi) prefetch(kj + 1);
    const bf16_t* Kb = Ks + buf * kBK * LD;
    const bf16_t* Vb = Vs + buf * kBK * LD;

    // s and dp: rows are this warp's 16 queries, columns the 64 keys
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[ni][e] = dp[ni][e] = 0.f;
    mma_a_bt<8, KS>(sc, qf, Kb, LD);
    mma_a_bt<8, KS>(dp, gf, Vb, LD);
    // the forward's masks (a plain pair keeps the raw products, the
    // diagonal one with -inf for the keys after their query)
    const PairKind kind = pair_kind(q0, k0, a.s, a.causal, a.window, key_masks);
    if (kind == kMasked)
      mask_fragments<false>(sc, a.scale, qrow, no_state, qseg, k0, kstate[buf], kseg[buf], a.s,
                            a.causal, a.window);
    else if (kind == kDiagonal)
      causal_fragments<false>(sc, qrow, k0);
    // p into sc
    if (kind != kMasked) {
      const float c2 = a.scale * kLog2e;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[ni][e] = fast_exp2(fmaf(sc[ni][e], c2, -lse2[e >> 1]));
    } else {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[ni][e] = __expf(sc[ni][e] - lse[e >> 1]);
    }
    // ds into dp, rounded to bf16: the A fragments of dq += dS.K
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[ni][e] = (sc[ni][e] * (dp[ni][e] - dl[e >> 1])) * a.scale;
    uint32_t sf[4][4];
    pack_a<8>(sf, dp);
    mma_a_b<NT, 4>(dq, sf, Kb, LD);
  }

  bf16_t* dqb = static_cast<bf16_t*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qrow + g + 8 * r;
    if (qp >= a.s) continue;
    bf16_t* row = dqb + (static_cast<long long>(b) * a.s + qp) * a.h * D +
                  static_cast<long long>(h) * D + 2 * t;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      *reinterpret_cast<uint32_t*>(row + ni * 8) = pack_bf16(dq[ni][2 * r], dq[ni][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_mma_kernel(const BwdArgs a) {
  using namespace mma;
  constexpr int LD = tile_ld<D>(), KS = D / 16, NT = D / 8;
  static_assert(kBQ == kBK, "K and V are staged in the query tiles' second buffers");
  extern __shared__ float4 smem4[];
  bf16_t* Qs = reinterpret_cast<bf16_t*>(smem4);  // [2][kBQ][LD]; K at first in buffer 1
  bf16_t* Gs = Qs + 2 * kBQ * LD;                  // [2][kBQ][LD] dO; V at first in buffer 1
  __shared__ float qlse[2][kBQ];
  __shared__ float qdl[2][kBQ];
  __shared__ int qsg[2][kBQ];

  const int warp = threadIdx.x >> 5;
  const int kj = blockIdx.x;  // low key tiles have the most causal work
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.h / a.hkv;
  const int k0 = kj * kBK;
  const bf16_t* kb = static_cast<const bf16_t*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const bf16_t* vb = static_cast<const bf16_t*>(a.v) + b * a.vs.b + hk * a.vs.h;
  const bool key_masks = a.mask != nullptr || a.seg != nullptr;

  int qi_lo, qi_hi;
  query_band(k0, a.s, a.causal, a.window, &qi_lo, &qi_hi);
  const int nqb = qi_hi - qi_lo + 1;
  const int n_it = group * nqb;  // (query head of the group, query tile) pairs
  // start the copies of pair `it` into buffer it % 2
  auto prefetch = [&](int it) {
    const int buf = it & 1;
    dkv_prefetch<D>(a, b, hk * group + it / nqb, (qi_lo + it % nqb) * kBQ, Qs + buf * kBQ * LD,
                    Gs + buf * kBQ * LD, qlse[buf], qdl[buf], qsg[buf]);
  };
  load_tile_async<D, kBK>(kb, a.ks.s, k0, a.s, Qs + kBQ * LD);
  load_tile_async<D, kBK>(vb, a.vs.s, k0, a.s, Gs + kBQ * LD);
  prefetch(0);
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 keys: K and V as A fragments, dk and dv as accumulators
  const int krow = k0 + warp * 16;
  uint32_t kf[KS][4], vf[KS][4];
  int kst[2], ksg[2];
  float dk[NT][4], dv[NT][4];
  dkv_keys<D>(a, b, krow, Qs + kBQ * LD + warp * 16 * LD, Gs + kBQ * LD + warp * 16 * LD, kf, vf,
              kst, ksg, dk, dv);

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1, q0 = (qi_lo + it % nqb) * kBQ;
    // pair `it` has landed, and every warp is done with pair it - 1 (at
    // first: with K's and V's fragments), whose buffers are written next
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) prefetch(it + 1);
    uint32_t sf[4][4];  // dS^T, which only K3f's dq partial reads
    dkv_pair<D>(a, krow, k0, q0, key_masks, kf, vf, kst, ksg, Qs + buf * kBQ * LD,
                Gs + buf * kBQ * LD, qlse[buf], qdl[buf], qsg[buf], dk, dv, sf);
  }
  dkv_store<D>(a, b, hk, krow, dk, dv);
}

// ---------------------------------------------------------------------
// launchers

template <typename K>
cudaError_t launch_kernel(K kernel, int smem, dim3 grid, const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, bool bf16, cudaStream_t stream) {
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.h, a.b);
  if (bf16)
    return launch_kernel(flash_bwd_dq_mma_kernel<D>, bwd_mma_smem_bytes<D>(), grid, a, stream);
  return launch_kernel(flash_bwd_dq_kernel<float, D>,
                       dq_smem_floats<D>() * static_cast<int>(sizeof(float)), grid, a, stream);
}

template <int D>
cudaError_t launch_dkv(const BwdArgs& a, bool bf16, cudaStream_t stream) {
  const dim3 grid((a.s + kBK - 1) / kBK, a.hkv, a.b);
  if (bf16)
    return launch_kernel(flash_bwd_dkv_mma_kernel<D>, bwd_mma_smem_bytes<D>(), grid, a, stream);
  return launch_kernel(flash_bwd_dkv_kernel<float, D>,
                       dkv_smem_floats<D>() * static_cast<int>(sizeof(float)), grid, a, stream);
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* g, const void* lse,
                  const void* delta, void* dq, void* dk, void* dv, const void* mask,
                  const void* seg, const void* kseg, const long long* st, int b, int h,
                  int hkv, int s, int causal, int window, float scale) {
  return BwdArgs{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 dq, dk, dv, static_cast<const unsigned char*>(mask),
                 static_cast<const int*>(seg), static_cast<const int*>(kseg ? kseg : seg),
                 {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
                 {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
                 b, h, hkv, s, causal, window, scale};
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared conventions of both launchers: q and g = dO (B, S, H, D), k and
// v (B, S, Hkv, D), all bf16 or all fp32, with (batch, seq, head) strides
// in `strides` (12 values: q, k, v, g) and a contiguous head dim; lse and
// delta (B, H, S) fp32 contiguous; mask (B, S) bytes and seg (B, S)
// int32, each may be null; kseg (B, S) int32 the keys' segments, null to
// read seg; window <= 0 means none; D is 32 or 64.
// Outputs are contiguous: dq (B, S, H, D), dk and dv (B, S, Hkv, D).
// bf16 runs on the tensor cores, fp32 on the CUDA cores.  Each returns
// the CUDA error of its launch (0 on success).
extern "C" int dtf_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                const void* lse, const void* delta, void* dq,
                                const void* mask, const void* seg, const void* kseg,
                                const long long* strides, int b, int h, int hkv, int s, int d,
                                int causal, int window, float scale, int bf16, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hkv <= 0 || h % hkv) return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, g, lse, delta, dq, nullptr, nullptr, mask, seg, kseg,
                              strides, b, h, hkv, s, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) err = launch_dq<64>(a, bf16, st);
  else if (d == 32) err = launch_dq<32>(a, bf16, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int dtf_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 const void* mask, const void* seg, const void* kseg,
                                 const long long* strides, int b, int h, int hkv, int s, int d,
                                 int causal, int window, float scale, int bf16, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hkv <= 0 || h % hkv) return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, g, lse, delta, nullptr, dk, dv, mask, seg, kseg, strides,
                              b, h, hkv, s, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) err = launch_dkv<64>(a, bf16, st);
  else if (d == 32) err = launch_dkv<32>(a, bf16, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
