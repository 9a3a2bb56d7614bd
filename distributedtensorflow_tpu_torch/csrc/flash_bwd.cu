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
// the dv product (:637) and ds to q's type before the dq and dk products
// (:645); sums are fp32.  Under GQA, dk and dv of a kv head sum the
// query heads of its group in fp32 before one rounding (the JAX path
// rounds each head's share, then sums).
//
// What bounds it on the H100: operations.  Five products of
// 2 * B * H * S^2 * D flops (half under the causal mask) in the fused
// form; this split form recomputes s and dp in both kernels, seven
// products in all.  This first version computes in fp32 on the CUDA
// cores; tensor-core tiles are later work.
//
// Design: the split pair, deterministic, no atomics.  The dq kernel runs
// one block per (query tile, head, batch) and loops over the key tiles
// of the band; the dk/dv kernel runs one block per (key tile, kv head,
// batch) and loops over the query tiles of the band of every query head
// of its group, so the GQA sum needs no atomics either.  Tiles and
// thread patches as in flash_fwd.cu; the ds and p tiles go through
// shared memory to the products that contract over their other axis.

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
  const int* seg;
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
      kseg[r] = segment(a.seg, b, a.s, k0 + r);
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
    ksg[i] = segment(a.seg, b, a.s, kpos[i]);
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

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a, cudaStream_t stream) {
  const int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.h, a.b);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a, cudaStream_t stream) {
  const int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBK - 1) / kBK, a.hkv, a.b);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* g, const void* lse,
                  const void* delta, void* dq, void* dk, void* dv, const void* mask,
                  const void* seg, const long long* st, int b, int h, int hkv, int s,
                  int causal, int window, float scale) {
  return BwdArgs{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 dq, dk, dv, static_cast<const unsigned char*>(mask),
                 static_cast<const int*>(seg), {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
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
// int32, each may be null; window <= 0 means none; D is 32 or 64.
// Outputs are contiguous: dq (B, S, H, D), dk and dv (B, S, Hkv, D).
// Each returns the CUDA error of its launch (0 on success).
extern "C" int dtf_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                const void* lse, const void* delta, void* dq,
                                const void* mask, const void* seg, const long long* strides,
                                int b, int h, int hkv, int s, int d, int causal, int window,
                                float scale, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hkv <= 0 || h % hkv) return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, g, lse, delta, dq, nullptr, nullptr, mask, seg, strides,
                              b, h, hkv, s, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (d == 64) err = bf16 ? launch_dq<bf, 64>(a, st) : launch_dq<float, 64>(a, st);
  else if (d == 32) err = bf16 ? launch_dq<bf, 32>(a, st) : launch_dq<float, 32>(a, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int dtf_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 const void* mask, const void* seg, const long long* strides,
                                 int b, int h, int hkv, int s, int d, int causal, int window,
                                 float scale, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hkv <= 0 || h % hkv) return cudaErrorInvalidValue;
  const BwdArgs a = make_args(q, k, v, g, lse, delta, nullptr, dk, dv, mask, seg, strides, b, h,
                              hkv, s, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (d == 64) err = bf16 ? launch_dkv<bf, 64>(a, st) : launch_dkv<float, 64>(a, st);
  else if (d == 32) err = bf16 ? launch_dkv<bf, 32>(a, st) : launch_dkv<float, 32>(a, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
