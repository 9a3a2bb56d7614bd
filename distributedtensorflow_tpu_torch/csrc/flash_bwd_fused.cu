// Flash-attention backward for Hopper (sm_90a) in one sweep: dq, dk and dv
// from one recomputation of each score tile.
//
// Replaces the TPU kernel `_bwd_fused_kernel`
// (distributedtensorflow_tpu/ops/flash_attention.py:586, launched by
// `_flash_backward_pallas_bhsd` at :889), which JAX takes whenever the
// (S, D) fp32 dq scratch fits its VMEM budget, `S * D * 4 <= 2 MiB`
// (:583, :859).  The function is the split pair's (flash_bwd.cu): from q,
// k, v, dO, the forward's LSE and delta = rowsum(dO * O), both (B, H, S)
// fp32 and passed in,
//   p  = exp(s - lse),  dv = sum_q p^T dO,  dp = dO v^T,
//   ds = p * (dp - delta) * scale,  dq = ds k,  dk = ds^T q,
// with s the masked, scaled scores of the forward (flash_common.cuh) and
// the TPU kernel's rounding points: p rounded to dO's type before the dv
// product (:637), ds rounded once to q's type for both the dk and the dq
// product (:645); sums are fp32.  Five products and one exp per (query
// tile, key tile) pair, where the split pair needs seven and two.  Under
// GQA, dk and dv of a kv head sum the query heads of its group in fp32
// before one rounding, as flash_bwd.cu does.
//
// What bounds it on the H100: operations, five products of
// 2 * B * H * S^2 * D flops (half under the causal mask).
//
// Design.  A block of four warps owns one key tile of one kv head of one
// batch row.  It keeps dk and dv of its 64 keys in registers, sweeps the
// query tiles of the band (`_band_run`, :278) for every query head of its
// GQA group, and computes s, p, dp and ds once per pair.  From them it
// forms dv += p^T dO and dk += ds^T q in registers, and the query tile's
// dq partial ds k.
//
// The dq partials are what the TPU carries across its sequential grid in
// VMEM scratch (`dq_all_scr`).  Here blocks run in no order, so the
// partials of each (batch, head, query tile) are summed in an fp32
// accumulator in device memory in ascending key-tile order, the order of
// `dq_all_scr[row] + dot(ds, k)` (:651), under a turn counter per (batch,
// head, query tile).  The band's first key tile stores its partial instead
// of adding it (0 + x is x, so the accumulator needs no clearing), and its
// last rounds the sum to dq's type and writes the output row.  No atomic
// touches a value, so dq, dk and dv repeat bit for bit.
//
// bf16 (flash_bwd_fused_mma_kernel): all five products run on the tensor
// cores (mma.sync.m16n8k16, bf16 in, fp32 sums).  K and V are copied once
// into shared memory as bf16; each warp keeps its 16 keys of both as A
// fragments in registers for the whole sweep.  The Q and dO tiles are two
// buffers deep: cp.async brings the next query tile while this one is
// multiplied.  The scores are computed transposed (keys as rows): S^T =
// K.Q^T and dP^T = V.dO^T come out in the accumulator layout, and p and ds
// are formed on those fragments with the row's LSE and delta (the masks
// are skipped where a tile pair needs none, and only the causal one is
// applied on the diagonal).  Rounded to bf16, P^T and
// dS^T are the A fragments of dv += P^T.dO and dk += dS^T.Q straight from
// registers, with dO and Q read by ldmatrix.trans.  dS^T is also written
// to shared memory once (the same bf16 values: ds is rounded once), and
// after a barrier each warp forms 16 query rows of the dq partial dS.K,
// with dS read back transposed by ldmatrix.trans.  bf16 operands are
// needed exactly where the TPU kernel rounds.  The dk/dv half of this
// (dkv_prefetch, dkv_keys, dkv_pair, dkv_store in flash_common.cuh) is
// also the split pair's dk/dv kernel, so both give the same dk and dv
// bits.  About 56 KB of shared
// memory at D 64 and at most 255 registers a thread: two blocks share an
// SM, so one block's products fill the time the other waits for its turn.
//
// The turn in bf16: each warp adds its own 16 rows of the partial, so the
// counter counts warps.  A warp of the band's n-th key tile waits until
// the counter reads 4 n (all four warps of every earlier key tile have
// added), fetches the sum so far with one batch of 16-byte loads that
// bypass L1 (started before the dq product, consumed after it), stores the
// new sum, and, after __syncwarp, lane 0 adds 1 with release semantics.
// The sum of a (batch, head, query tile) lies in the scratch in the
// accumulator's fragment order, 64 rows a tile, so a warp's load or store
// covers whole 128-byte lines; only the band's last key tile leaves that
// order, when it writes dq.  The next tile's copies are started before the
// wait, and no block barrier stands between the add and the release.
//
// fp32 (flash_bwd_fused_kernel): FMAs on the CUDA cores (the tensor cores
// have no full-precision fp32 product), fp32 tiles in shared memory (171
// KB, one block per SM); the block of the n-th key tile adds once the
// counter reads n, then sets it to n + 1, and the sum lies in the scratch
// row by row.
//
// Deadlock.  Blocks take their work from a ticket counter, key tile after
// key tile: every (batch, kv head) of key tile 0, then of key tile 1, and
// so on, whatever order the hardware starts the blocks in.  A ticket is
// taken by a block that is already resident, and a block waits only on
// work with a smaller ticket, so by induction over the tickets every wait
// ends: the smallest unfinished ticket waits on nothing, and it is
// running.  That holds for one or two resident blocks per SM alike, since
// a resident block never needs another block's SM.  This order also
// starts the key tiles with the most causal work first, and a block's
// predecessor in the band has started before it, so it runs about one
// tile ahead instead of keeping the block waiting.  The counters are
// cleared on the launch's stream just before the kernel (a CUDA graph
// captures both).

#include "flash_common.cuh"

namespace {

using namespace flash;

struct FusedArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;       // dO, (B, S, H, D)
  const float* lse;    // (B, H, S)
  const float* delta;  // (B, H, S)
  void* dq;            // (B, S, H, D) contiguous, q's type
  void* dk;            // (B, S, Hkv, D) contiguous
  void* dv;
  float* dq_acc;       // (B, H, S, D) fp32 scratch, needs no clearing
  int* counters;       // [0] the ticket, then a turn per (B, H, query tile)
  const unsigned char* mask;
  const int* seg;   // the queries' segments
  const int* kseg;  // the keys' (seg when no second array)
  Strides qs, ks, vs, gs;
  int b, h, hkv, s, causal, window;
  float scale;
};

template <int D>
constexpr int fused_smem_floats() {
  return 2 * D * (kBK + kPad) + 2 * D * (kBQ + kPad) + 2 * kBQ * D + 2 * kBQ * (kBK + kPad) +
         kBK * D + kBK * (kBQ + kPad);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_fused_kernel(const FusedArgs a) {
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
  float* Ks = Ss + kBQ * KT;                     // [kBK][D]
  float* St = Ks + kBK * D;                      // [kBK][QT] ds, rounded, key-major
  __shared__ float qlse[kBQ];
  __shared__ float qdl[kBQ];
  __shared__ int qseg[kBQ];
  __shared__ int ticket;

  const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;
  if (tid == 0) ticket = atomicAdd(a.counters, 1);
  __syncthreads();
  const int chains = a.b * a.hkv;
  const int kj = ticket / chains;
  const int b = ticket % chains / a.hkv, hk = ticket % chains % a.hkv;
  const int group = a.h / a.hkv;
  const int nq = (a.s + kBQ - 1) / kBQ;
  const int k0 = kj * kBK;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + hk * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + hk * a.vs.h;

  load_tile<T, D, kBK>(kb, a.ks.s, k0, a.s, Ks, Kt);
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

      // s and dp, transposed: rows are this thread's 4 keys, columns 8 queries
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
          const float ds = round_to<T>((p * (dpt[i][j] - qdl[qc])) * a.scale);
          Ps[qc * KT + rg * 4 + i] = round_to<T>(p);
          Ss[qc * KT + rg * 4 + i] = ds;
          St[(rg * 4 + i) * QT + qc] = ds;
        }
      __syncthreads();

      // dv += p^T dO and dk += ds^T q for this thread's 4 keys
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

      // the dq partial ds k for this thread's 4 queries
      float dqp[4][DC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dqp[i][c] = 0.f;
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
          for (int c = 0; c < DC; ++c) dqp[i][c] = fmaf(sa[i], ka[c], dqp[i][c]);
      }

      // add it to the query tile's sum in ascending key-tile order
      int kj_lo, kj_hi;
      key_band(q0, a.s, a.causal, a.window, &kj_lo, &kj_hi);
      int* turn = a.counters + 1 + (static_cast<long long>(b) * a.h + h) * nq + qi;
      if (tid == 0) {
        while (load_acquire(turn) != kj - kj_lo) __nanosleep(64);
      }
      __syncthreads();
      T* dqb = static_cast<T*>(a.dq);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + rg * 4 + i;
        if (qp >= a.s) continue;
        float* acc = a.dq_acc + (row_base + qp) * D;
        T* out = dqb + (static_cast<long long>(b) * a.s + qp) * a.h * D + static_cast<long long>(h) * D;
#pragma unroll
        for (int c4 = 0; c4 < DC / 4; ++c4) {
          float* part = &dqp[i][c4 * 4];
          float4* cell = reinterpret_cast<float4*>(acc + c4 * 32 + cg * 4);
          if (kj != kj_lo) {
            const float4 sum = __ldcg(cell);
            part[0] = sum.x + part[0]; part[1] = sum.y + part[1];
            part[2] = sum.z + part[2]; part[3] = sum.w + part[3];
          }
          if (kj == kj_hi) store4(out + c4 * 32 + cg * 4, part);
          else __stcg(cell, make_float4(part[0], part[1], part[2], part[3]));
        }
      }
      // the block's stores, then one release (CUTLASS's semaphore pattern:
      // the barrier orders them before thread 0's st.release.gpu)
      __syncthreads();
      if (tid == 0) store_release(turn, kj - kj_lo + 1);
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
cudaError_t launch(const FusedArgs& a, int n_counters, cudaStream_t stream) {
  const int smem = fused_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_fused_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(a.counters, 0, static_cast<size_t>(n_counters) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int blocks = (a.s + kBK - 1) / kBK * a.b * a.hkv;
  flash_bwd_fused_kernel<T, D><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

__device__ __forceinline__ void add_release(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

template <int D>
constexpr int fused_mma_smem_bytes() {
  return ((kBK + 4 * kBQ) * tile_ld<D>() + kBK * (kBQ + 8)) * static_cast<int>(sizeof(bf16_t));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_fused_mma_kernel(const FusedArgs a) {
  using namespace mma;
  constexpr int LD = tile_ld<D>(), KS = D / 16, NT = D / 8;
  constexpr int LDS = kBQ + 8;  // row of the ds^T tile, padded like the others
  static_assert(LD <= LDS, "V is staged in the ds^T tile's room");
  extern __shared__ float4 smem4[];
  bf16_t* Ks = reinterpret_cast<bf16_t*>(smem4);  // [kBK][LD]
  bf16_t* Qs = Ks + kBK * LD;                      // [2][kBQ][LD]
  bf16_t* Gs = Qs + 2 * kBQ * LD;                  // [2][kBQ][LD] dO
  bf16_t* St = Gs + 2 * kBQ * LD;                  // [kBK][LDS] ds^T, rounded; V at first
  __shared__ float qlse[2][kBQ];
  __shared__ float qdl[2][kBQ];
  __shared__ int qsg[2][kBQ];
  __shared__ int ticket;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (tid == 0) ticket = atomicAdd(a.counters, 1);
  __syncthreads();
  const int chains = a.b * a.hkv;
  const int kj = ticket / chains;
  const int b = ticket % chains / a.hkv, hk = ticket % chains % a.hkv;
  const int group = a.h / a.hkv;
  const int nq = (a.s + kBQ - 1) / kBQ;
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
  load_tile_async<D, kBK>(kb, a.ks.s, k0, a.s, Ks);
  load_tile_async<D, kBK>(vb, a.vs.s, k0, a.s, St);
  prefetch(0);
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 keys: K and V as A fragments, dk and dv as accumulators
  const int krow = k0 + warp * 16;
  uint32_t kf[KS][4], vf[KS][4];
  int kst[2], ksg[2];
  float dk[NT][4], dv[NT][4];
  dkv_keys<D>(a, b, krow, Ks + warp * 16 * LD, St + warp * 16 * LD, kf, vf, kst, ksg, dk, dv);

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1, h = hk * group + it / nqb, qi = qi_lo + it % nqb, q0 = qi * kBQ;
    // pair `it` has landed, and every warp is done with pair it - 1 (at
    // first: with V's fragments), whose buffers are written next
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) prefetch(it + 1);

    // dv and dk of the pair (flash_common.cuh), then dS^T to shared memory,
    // the same bits, for the dq partial
    uint32_t sf[4][4];
    dkv_pair<D>(a, krow, k0, q0, key_masks, kf, vf, kst, ksg, Qs + buf * kBQ * LD,
                Gs + buf * kBQ * LD, qlse[buf], qdl[buf], qsg[buf], dk, dv, sf);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf16_t* row = St + (warp * 16 + g) * LDS + j * 16 + 2 * t;
      *reinterpret_cast<uint32_t*>(row) = sf[j][0];
      *reinterpret_cast<uint32_t*>(row + 8 * LDS) = sf[j][1];
      *reinterpret_cast<uint32_t*>(row + 8) = sf[j][2];
      *reinterpret_cast<uint32_t*>(row + 8 * LDS + 8) = sf[j][3];
    }
    __syncthreads();  // ds^T is whole

    // This warp's 16 queries of the tile's dq sum.  Once every earlier key
    // tile of the band has added (the turn), fetch the sum so far in one
    // batch of loads, which are in flight while the partial ds k is
    // multiplied.  The sum lies in the scratch in fragment order (lane l
    // holds 16 bytes of every 512): whole lines per warp and load.
    int kj_lo, kj_hi;
    key_band(q0, a.s, a.causal, a.window, &kj_lo, &kj_hi);
    int* turn = a.counters + 1 + (static_cast<long long>(b) * a.h + h) * nq + qi;
    float* cell = a.dq_acc + ((static_cast<long long>(b) * a.h + h) * nq + qi) * (kBQ * D) +
                  warp * 16 * D + lane * 4;
    float4 sum[NT];
    if (kj != kj_lo) {
      if (lane == 0) {
        while (load_acquire(turn) < 4 * (kj - kj_lo)) __nanosleep(32);
      }
      __syncwarp();
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        sum[ni] = __ldcg(reinterpret_cast<const float4*>(cell + ni * 128));
    } else {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) sum[ni] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

    // the dq partial ds k
    float dqp[NT][4];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqp[ni][e] = 0.f;
    {
      uint32_t af[4][4];
      load_a_trans<4>(af, St + warp * 16, LDS);
      mma_a_b<NT, 4>(dqp, af, Ks, LD);
    }

    // add in ascending key-tile order (the band's first key tile adds to
    // 0); its last rounds the sum and writes the output rows
    if (kj != kj_hi) {
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        __stcg(reinterpret_cast<float4*>(cell + ni * 128),
               make_float4(sum[ni].x + dqp[ni][0], sum[ni].y + dqp[ni][1],
                           sum[ni].z + dqp[ni][2], sum[ni].w + dqp[ni][3]));
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = q0 + warp * 16 + g + 8 * r;
        if (qp >= a.s) continue;
        bf16_t* out = static_cast<bf16_t*>(a.dq) +
                      (static_cast<long long>(b) * a.s + qp) * a.h * D +
                      static_cast<long long>(h) * D + 2 * t;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
          *reinterpret_cast<uint32_t*>(out + ni * 8) =
              r == 0 ? pack_bf16(sum[ni].x + dqp[ni][0], sum[ni].y + dqp[ni][1])
                     : pack_bf16(sum[ni].z + dqp[ni][2], sum[ni].w + dqp[ni][3]);
      }
    }
    // the warp's stores, then one release (CUTLASS's semaphore pattern at
    // warp scope: the barrier orders them before lane 0's red.release.gpu)
    __syncwarp();
    if (lane == 0 && kj != kj_hi) add_release(turn, 1);
  }

  dkv_store<D>(a, b, hk, krow, dk, dv);
}

template <int D>
cudaError_t launch_mma(const FusedArgs& a, int n_counters, cudaStream_t stream) {
  const int smem = fused_mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_fused_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(a.counters, 0, static_cast<size_t>(n_counters) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int blocks = (a.s + kBK - 1) / kBK * a.b * a.hkv;
  flash_bwd_fused_mma_kernel<D><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q and g = dO (B, S, H, D), k and v (B, S, Hkv, D), all bf16 or all
// fp32, with (batch, seq, head) strides in `strides` (12 values: q, k, v,
// g) and a contiguous head dim; lse and delta (B, H, S) fp32 contiguous;
// mask (B, S) bytes and seg (B, S) int32, each may be null; kseg (B, S)
// int32 the keys' segments, null to read seg; window <= 0
// means none; D is 32 or 64.  Outputs are contiguous: dq (B, S, H, D), dk
// and dv (B, S, Hkv, D).  Scratch: dq_acc, B * H * ceil(S / 64) * 64 * D
// floats, and counters, 1 + B * H * ceil(S / 64) ints, both of any
// content.  bf16 runs on the tensor cores, fp32 on the CUDA cores.
// Returns the CUDA error of the launch (0 on success).
extern "C" int dtf_flash_bwd_fused(const void* q, const void* k, const void* v, const void* g,
                                   const void* lse, const void* delta, void* dq, void* dk,
                                   void* dv, void* dq_acc, void* counters, const void* mask,
                                   const void* seg, const void* kseg, const long long* st,
                                   int b, int h, int hkv,
                                   int s, int d, int causal, int window, float scale, int bf16,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hkv <= 0 || h % hkv || b <= 0 || s <= 0) return cudaErrorInvalidValue;
  const FusedArgs a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
                    dq, dk, dv, static_cast<float*>(dq_acc), static_cast<int*>(counters),
                    static_cast<const unsigned char*>(mask), static_cast<const int*>(seg),
                    static_cast<const int*>(kseg ? kseg : seg),
                    {st[0], st[1], st[2]}, {st[3], st[4], st[5]}, {st[6], st[7], st[8]},
                    {st[9], st[10], st[11]}, b, h, hkv, s, causal, window, scale};
  const int n_counters = 1 + b * h * ((s + kBQ - 1) / kBQ);
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (d == 64) err = bf16 ? launch_mma<64>(a, n_counters, sm) : launch<float, 64>(a, n_counters, sm);
  else if (d == 32) err = bf16 ? launch_mma<32>(a, n_counters, sm) : launch<float, 32>(a, n_counters, sm);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
