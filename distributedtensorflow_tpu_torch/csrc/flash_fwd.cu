// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels `_fwd_kernel` and `_fwd_kernel_1k`
// (distributedtensorflow_tpu/ops/flash_attention.py:333 and :396,
// launched by `_flash_forward_bhsd` at :540).  Same function: for every
// (batch, query head, query) the softmax over the masked, scaled scores
// q.k / sqrt(D) against the keys of kv head h // group (GQA), times V;
// returns O in q's type and LSE = m + log(l) in fp32 for the backward.
// The online-softmax state m, l and the output accumulator stay fp32;
// p is rounded to V's type before P.V, as the TPU kernel does (:374),
// while l sums the unrounded p.  Masks: causal, sliding window, key
// padding (B, S) and packed segment ids (B, S) (flash_common.cuh).
//
// What bounds it on the H100: operations.  4 * B * H * S^2 * D flops
// (half of it under the causal mask) against a few bytes per element of
// q, k, v and o: at GPT-2-small's B=8, H=12, S=2048, D=64 bf16 that is
// 51.5 GFLOP (causal) over 989 TFLOP/s, about 0.05 ms.
//
// Both kernels: one block of 128 threads per (query tile of 64, head,
// batch), heaviest causal tiles first; every key tile of the band is
// visited in ascending order (whole tiles outside the causal/window band
// are skipped, as `_band_run` does).  K and V are read from their kv head
// directly: no broadcast copy.
//
// bf16 (flash_fwd_mma_kernel): both products run on the tensor cores
// (mma.sync.m16n8k16, bf16 in, fp32 sums).  Each of the four warps owns 16
// query rows against the whole key tile.  Q is copied to shared memory
// once and kept as A fragments in registers for the whole sweep.  K and V
// tiles stay bf16 in shared memory (rows padded by 16 bytes: ldmatrix
// without bank conflicts), two buffers deep: cp.async brings key tile
// j + 1 while tile j is multiplied, one barrier per tile.  S = Q.K^T comes
// out in the accumulator layout; the masks (skipped where a tile pair
// needs none, the causal one alone on the diagonal), the running max and
// sum and the rescale of the output accumulator work on those fragments,
// a row's max and sum being shuffles among the four lanes that share it.
// P never touches shared memory: two neighbouring accumulator tiles,
// rounded to bf16, are one A fragment of P.V, and V comes by
// ldmatrix.trans.  bf16 operands are needed exactly where the TPU kernel
// rounds, so only the order of fp32 sums differs from the plain version
// (and exp, where a tile pair needs no key mask, is one FMA that folds
// scale log2(e) in and one ex2 per element).  46 KB of shared memory at
// D 64 and 128 registers a thread: four blocks share an SM.
//
// fp32 (flash_fwd_kernel): FMAs on the CUDA cores, since the tensor cores
// have no full-precision fp32 product.  The query tile is staged once,
// transposed, in shared memory; every key tile is staged transposed (K)
// and row-major (V).  Each thread holds a 4 x 8 patch of the score tile,
// its rows' m and l, and a 4 x D/8 patch of the output; the rounded p
// tile goes through shared memory to the P.V product.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;       // (B, S, H, D), q's type, contiguous
  float* lse;    // (B, H, S)
  const unsigned char* mask;  // (B, S) or null
  const int* seg;             // (B, S) or null: the queries' segments
  const int* kseg;            // the keys' segments (seg when no second array)
  Strides qs, ks, vs;
  int b, h, hkv, s, causal, window;
  float scale;
};

template <int D>
constexpr int fwd_smem_floats() {
  return D * (kBQ + kPad) + D * (kBK + kPad) + kBK * D + kBK * (kBQ + kPad);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FwdArgs a) {
  constexpr int DC = D / 8;  // output columns a thread owns
  constexpr int QT = kBQ + kPad, KT = kBK + kPad;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QT]
  float* Kt = Qt + D * QT;                       // [D][KT]
  float* Vs = Kt + D * KT;                       // [kBK][D]
  float* Pt = Vs + kBK * D;                      // [kBK][QT]
  __shared__ int kstate[kBK];
  __shared__ int kseg[kBK];

  const int nq = (a.s + kBQ - 1) / kBQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qi * kBQ;
  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  load_tile<T, D, kBQ>(qb, a.qs.s, q0, a.s, nullptr, Qt);
  int qpos[4], qseg[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q0 + rg * 4 + i;
    qseg[i] = segment(a.seg, b, a.s, qpos[i]);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kj_lo, kj_hi;
  key_band(q0, a.s, a.causal, a.window, &kj_lo, &kj_hi);
  for (int kj = kj_lo; kj <= kj_hi; ++kj) {
    const int k0 = kj * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, kBK>(kb, a.ks.s, k0, a.s, nullptr, Kt);
    load_tile<T, D, kBK>(vb, a.vs.s, k0, a.s, Vs, nullptr);
    for (int r = tid; r < kBK; r += kThreads) {
      kstate[r] = key_state(a.mask, b, a.s, k0 + r);
      kseg[r] = segment(a.kseg, b, a.s, k0 + r);
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = ld4(Qt + d * QT + rg * 4);
      const float4 k0v = ld4(Kt + d * KT + cg * 4);
      const float4 k1v = ld4(Kt + d * KT + 32 + cg * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[8] = {k0v.x, k0v.y, k0v.z, k0v.w, k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = col_of(cg, j);
        sc[i][j] = masked_score(sc[i][j], a.scale, qpos[i], k0 + kc, kstate[kc], qseg[i],
                                kseg[kc], a.causal, a.window);
        rmax = fmaxf(rmax, sc[i][j]);
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      const float m_new = fmaxf(m[i], rmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key reached yet
      const float alpha = expf(m[i] - m_use);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - m_use);
        rsum += p;
        Pt[col_of(cg, j) * QT + rg * 4 + i] = round_to<T>(p);
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pv = ld4(Pt + kk * QT + rg * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      float va[DC];
#pragma unroll
      for (int c4 = 0; c4 < DC / 4; ++c4) {
        const float4 v4 = ld4(Vs + kk * D + c4 * 32 + cg * 4);
        va[c4 * 4] = v4.x; va[c4 * 4 + 1] = v4.y; va[c4 * 4 + 2] = v4.z; va[c4 * 4 + 3] = v4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], va[c], acc[i][c]);
    }
  }

  T* ob = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] >= a.s) continue;
    T* orow = ob + (static_cast<long long>(b) * a.s + qpos[i]) * a.h * D + static_cast<long long>(h) * D;
#pragma unroll
    for (int c4 = 0; c4 < DC / 4; ++c4) {
      float o4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o4[e] = acc[i][c4 * 4 + e] / l[i];
      store4(orow + c4 * 32 + cg * 4, o4);
    }
    if (cg == 0)
      a.lse[(static_cast<long long>(b) * a.h + h) * a.s + qpos[i]] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  const int smem = fwd_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.h, a.b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
constexpr int fwd_mma_smem_bytes() {
  return (kBQ + 4 * kBK) * tile_ld<D>() * static_cast<int>(sizeof(bf16_t));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 4) flash_fwd_mma_kernel(const FwdArgs a) {
  using namespace mma;
  constexpr int LD = tile_ld<D>(), KS = D / 16, NT = D / 8;
  extern __shared__ float4 smem4[];
  bf16_t* Qs = reinterpret_cast<bf16_t*>(smem4);  // [kBQ][LD]
  bf16_t* Ks = Qs + kBQ * LD;                      // [2][kBK][LD]
  bf16_t* Vs = Ks + 2 * kBK * LD;                  // [2][kBK][LD]
  __shared__ int kstate[2][kBK];
  __shared__ int kseg[2][kBK];

  const int nq = (a.s + kBQ - 1) / kBQ;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.h / a.hkv);
  const int q0 = qi * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bf16_t* qb = static_cast<const bf16_t*>(a.q) + b * a.qs.b + h * a.qs.h;
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
  load_tile_async<D, kBQ>(qb, a.qs.s, q0, a.s, Qs);
  prefetch(kj_lo);

  // this lane's rows g and g + 8 of the warp's 16 queries
  const int qrow = q0 + warp * 16;
  const int no_state[2] = {1, 1};
  int qseg[2];
  float m[2], l[2], o[NT][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qseg[r] = segment(a.seg, b, a.s, qrow + g + 8 * r);
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ni][e] = 0.f;

  uint32_t qf[KS][4];
  for (int kj = kj_lo; kj <= kj_hi; ++kj) {
    const int buf = (kj - kj_lo) & 1, k0 = kj * kBK;
    // tile kj has landed, and every warp is done with tile kj - 1, whose
    // buffer the next copy overwrites
    cp_async_wait<0>();
    __syncthreads();
    if (kj == kj_lo) load_a<KS>(qf, Qs + warp * 16 * LD, LD);
    if (kj < kj_hi) prefetch(kj + 1);

    float sc[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[ni][e] = 0.f;
    mma_a_bt<8, KS>(sc, qf, Ks + buf * kBK * LD, LD);
    // A plain pair keeps the raw products in sc (a pair on the causal
    // diagonal with -inf for the keys after their query): its p is one FMA
    // (scale log2(e) folded in) and one ex2 per element.  A masked pair
    // holds the scaled, masked scores, and NEG_INF cancels exactly against
    // a maximum of NEG_INF.
    const PairKind kind = pair_kind(q0, k0, a.s, a.causal, a.window, key_masks);
    const bool plain = kind != kMasked;
    if (kind == kMasked)
      mask_fragments<false>(sc, a.scale, qrow, no_state, qseg, k0, kstate[buf], kseg[buf], a.s,
                            a.causal, a.window);
    else if (kind == kDiagonal)
      causal_fragments<false>(sc, qrow, k0);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float rmax = -INFINITY;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) rmax = fmaxf(rmax, fmaxf(sc[ni][2 * r], sc[ni][2 * r + 1]));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[r], plain ? rmax * a.scale : rmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key reached yet
      const float alpha = __expf(m[r] - m_use);
      float rsum = 0.f;
      if (plain) {
        const float c2 = a.scale * kLog2e, m2 = m_use * kLog2e;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            sc[ni][e] = fast_exp2(fmaf(sc[ni][e], c2, -m2));
            rsum += sc[ni][e];
          }
      } else {
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            sc[ni][e] = __expf(sc[ni][e] - m_use);
            rsum += sc[ni][e];
          }
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      l[r] = l[r] * alpha + rsum;
      m[r] = m_new;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        o[ni][2 * r] *= alpha;
        o[ni][2 * r + 1] *= alpha;
      }
    }

    // p, rounded to bf16, is the A operand of P.V straight from registers
    uint32_t pf[4][4];
    pack_a<8>(pf, sc);
    mma_a_b<NT, 4>(o, pf, Vs + buf * kBK * LD, LD);
  }

  bf16_t* ob = static_cast<bf16_t*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qrow + g + 8 * r;
    if (qp >= a.s) continue;
    bf16_t* orow =
        ob + (static_cast<long long>(b) * a.s + qp) * a.h * D + static_cast<long long>(h) * D;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
      *reinterpret_cast<uint32_t*>(orow + ni * 8 + 2 * t) =
          pack_bf16(o[ni][2 * r] / l[r], o[ni][2 * r + 1] / l[r]);
    if (t == 0) a.lse[(static_cast<long long>(b) * a.h + h) * a.s + qp] = m[r] + logf(l[r]);
  }
}

template <int D>
cudaError_t launch_mma(const FwdArgs& a, cudaStream_t stream) {
  const int smem = fwd_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.h, a.b);
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, S, H, D), k and v (B, S, Hkv, D), all bf16 or all fp32, each with
// its (batch, seq, head) strides in `strides` (9 values, in elements) and
// a contiguous head dim; o (B, S, H, D) contiguous in q's type; lse
// (B, H, S) fp32; mask (B, S) bytes and seg (B, S) int32, each may be
// null; kseg (B, S) int32, the keys' segments where they are not the
// queries' (ring attention's rotated K/V chunk), null to read seg.  window <= 0 means none.  D is 32 or 64.  bf16 runs on the tensor
// cores, fp32 on the CUDA cores.  Returns the CUDA error of the launch (0
// on success).
extern "C" int dtf_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* mask, const void* seg, const void* kseg,
                             const long long* strides, int b, int h, int hkv, int s, int d,
                             int causal, int window, float scale, int bf16, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hkv <= 0 || h % hkv) return cudaErrorInvalidValue;
  FwdArgs a{q, k, v, o, static_cast<float*>(lse),
            static_cast<const unsigned char*>(mask), static_cast<const int*>(seg),
            static_cast<const int*>(kseg ? kseg : seg),
            {strides[0], strides[1], strides[2]}, {strides[3], strides[4], strides[5]},
            {strides[6], strides[7], strides[8]},
            b, h, hkv, s, causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) err = bf16 ? launch_mma<64>(a, st) : launch<float, 64>(a, st);
  else if (d == 32) err = bf16 ? launch_mma<32>(a, st) : launch<float, 32>(a, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
