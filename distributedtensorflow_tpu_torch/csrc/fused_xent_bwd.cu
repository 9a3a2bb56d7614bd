// Fused LM-head backward for Hopper (sm_90a): dx and dw kernels.
//
// Replaces the TPU kernels `_bwd_dx_kernel` and `_bwd_dw_kernel`
// (distributedtensorflow_tpu/ops/fused_xent.py:180 and :214, launched by
// `_fused_bwd_arrays` at :356 and :371).  Same function: from x (N, D),
// w (V, D) in the operand type T, the targets t (N,) int32, the
// forward's lse (N,) and c = g * w_row / w_sum (N,), both fp32, each
// kernel recomputes the logits tile and
//   dlog[n, v] = c[n] * (exp(x[n] . w[v] - lse[n]) - [v == t[n]]),
// rounds it to T (where the TPU kernels cast it to the operand dtype,
// :204-207 and :230-233), and sums in fp32
//   dx = dlog . w   (N, D),        dw = dlog^T . x   (V, D).
// Rows >= N or >= V give dlog = 0: a bound check, since a zero row that
// TMA fills in has logit 0 and p = exp(-lse) != 0.
//
// What bounds them on the H100: operations, two products of 2 N V D
// flops each (2.556 ms at gpt_lm's head, N 16376, D 768, V 50257, at
// 989 TFLOP/s bf16; 3.41 ms at D 1024).
//
// One template serves both kernels: OWN_TOKENS = dx (a cluster owns
// token rows and streams vocab rows), else dw (owns vocab rows, streams
// tokens).  Each output element is summed in one fixed order, with no
// atomics: reruns are bit-identical.
//
// bf16 (xent_bwd_wgmma_kernel, the plan of ops/fused_xent.py's
// xent_bwd_plan): a cluster of K = D / DK blocks owns M = 128 rows, and
// block k the output columns [k DK, (k + 1) DK), DK = 256 (D 768: K 3,
// D 1024: K 4; D 128: DK 128, K 1).  A block of two warpgroups (64 owned
// rows each) keeps its (M, DK) slice of the owned rows in shared memory
// for the whole sweep (64 KB) and its (M, DK) fp32 output in registers
// (128 a thread).  Thread 0 streams its slice of each S = 64-row tile of
// the other operand through a ring of three stages (32 KB each) with TMA
// (boxes of 64 columns, 128-byte swizzle, completion on an mbarrier).
// Per tile, each warpgroup on its own (the two warpgroups of a block
// drift apart, so one's tensor-core work overlaps the other's exchange):
//   1. partial logits of the slice, (64, S) fp32, by wgmma m64n64k16
//      (both operands K-major in shared memory), contracted over DK;
//   2. reduce-scatter through distributed shared memory: fragment chunk
//      c (8 columns of a thread's two rows) is reduced by block c % K,
//      and every other block sends it its partial of the chunk with
//      st.async, whose bytes complete a transaction of the receiver's
//      `exchanged` mbarrier (the receiver expects the tile's bytes);
//   3. the reducing block waits on `exchanged`, sums the K partials in
//      rank order 0 .. K-1, forms dlog, rounds it to bf16 and sends it
//      the same way to the other blocks' `ready` mbarriers.  Every dlog
//      is computed once, in one fixed order;
//   4. after `ready`, each thread reads its dlog chunks as wgmma's
//      register A operand (the accumulator layout of step 1 is the A
//      layout), and out += dlog . tile slice by wgmma m64n128k16 with the
//      same resident tile as B, MN-major (transposed);
//   5. every thread arrives on the stage's `empty` mbarrier; thread 0
//      waits on it and loads tile i + ST into the stage.
// A barrier's next phase is expected only after its current one
// completed, and no sender can start a tile before the receiver finished
// the previous one (it needs the receiver's dlog or partials first), so
// one buffer of each suffices and no bytes land in the wrong phase.
// Bytes a block sends per tile: about (K - 1) / K of the 32 KB fp32
// partial and K - 1 copies of its 1/K of the 16 KB bf16 dlog: 21.3 +
// 10.7 KB at K 3, 24 + 12 KB at K 4 (an all-gather of the partials
// would send (K - 1) x 32 KB and evaluate every exponential K times).
// Arithmetic intensity: a streamed slice of 32 KB from L2 feeds 2 x 128
// x 64 x 256 x 2 = 8.4 MFLOP, 256 flops a byte (the H100 needs about 180
// per L2 byte at its peak); the owned slice is read once per sweep.
// Shared memory a block: 1 KB alignment + 64 KB owned + 3 x 32 KB ring +
// the partials sent to it (K sources x ceil(8 / K) chunks x 4 KB: 36 KB
// at K 3, 32 KB at K 4) + 16 KB dlog + 3 KB of per-token values
// (two tiles a warpgroup, dw) + barriers = 221,272 bytes at D 768 and
// 217,176 at D 1024 (one block an SM); 118,888 at D 128 (K 1: no
// exchange, four stages).
// Registers: 128 output + 32 logits + 16 dlog fragments a thread, 256
// threads.
//
// fp32 (xent_bwd_fma_kernel, the parity steps' path): the first port's
// design on the CUDA cores.  A block of 256 threads owns 32 rows with
// their (32, D) fp32 output in registers and streams all rows of the
// other operand in tiles of 128 (xent_common.cuh's logits tile, then
// the dlog tile times the streamed rows, staged 16 at a time by
// cp.async).

#include <math.h>

#include "sm90_common.cuh"
#include "xent_common.cuh"

namespace {

struct BwdArgs {
  const void* x;
  const void* w;
  const int* t;
  const float* lse;
  const float* c;
  float* out;  // dx (N, D) or dw (V, D), fp32
  int n, v;
};

// ------------------------------------------------- bf16: wgmma + TMA + cluster

constexpr int kM = 128;       // owned rows of a cluster: two warpgroups of 64
constexpr int kS = 64;        // streamed rows of a tile
constexpr int kWgThreads = 256;

template <int DK, int K, int ST>
struct Layout {
  static constexpr int chunks = (8 + K - 1) / K;  // fragment chunks a block reduces
  static constexpr int own = kM * DK * 2;         // bf16 owned slice
  static constexpr int stage = kS * DK * 2;       // one ring stage
  static constexpr int recv = K > 1 ? K * chunks * kWgThreads * 16 : 0;  // partials sent here
  static constexpr int dlog = kM * kS * 2;        // bf16 dlog tile
  static constexpr int cols = 2 * 2 * 3 * kS * 4;  // dw: (lse, c, t), two tiles a warpgroup
  static constexpr int o_stage = own;
  static constexpr int o_recv = o_stage + ST * stage;
  static constexpr int o_dlog = o_recv + recv;
  static constexpr int o_cols = o_dlog + dlog;
  static constexpr int o_bars = o_cols + cols;
  // full[ST], empty[ST], own, exchanged[2], ready[2]
  static constexpr int bytes = o_bars + (2 * ST + 5) * 8;
  static constexpr int smem = 1024 + bytes;  // the base is aligned up to 1024
};

template <int D, int K, int ST, bool OWN_TOKENS>
__global__ void __launch_bounds__(kWgThreads, 1)
    xent_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap own_map,
                          const __grid_constant__ CUtensorMap str_map, const BwdArgs a) {
  using namespace sm90;
  constexpr int DK = D / K;
  constexpr int P = DK / 64;    // 64-column boxes of a slice
  constexpr int NH = DK / 128;  // n128 products of the gradient
  constexpr int W = 128;        // threads of a warpgroup
  using L = Layout<DK, K, ST>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t s_own = base, s_str = base + L::o_stage;
  const uint32_t full = base + L::o_bars, empty = full + ST * 8, own_bar = empty + ST * 8;

  const int n_own = OWN_TOKENS ? a.n : a.v;
  const int n_str = OWN_TOKENS ? a.v : a.n;
  const int tiles = (n_str + kS - 1) / kS;
  const int rank = K > 1 ? static_cast<int>(cluster_rank()) : 0;
  const int own0 = (blockIdx.x / K) * kM;
  const int col0 = rank * DK;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & (W - 1), lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = wg * 64 + (wt >> 5) * 16 + g;  // this thread's rows: row0, row0 + 8
  // Each warpgroup exchanges with the same warpgroup of its peers, on its
  // own barriers: `exchanged` (its peers' partials have arrived) and
  // `ready` (the whole dlog tile has arrived), one phase a tile.
  const uint32_t exchanged = own_bar + 8 + wg * 8, ready = own_bar + 24 + wg * 8;
  // Fragment chunk c8 of thread wt: columns 8 c8 .. 8 c8 + 7 of its two
  // rows, four fp32 logits or four bf16 dlog.  Block c8 % K reduces it:
  // the partial from block r lands in its recv[r][c8 / K][wt], and the
  // dlog goes to dlog[c8][wt] of every block (per warpgroup).
  float4* recv = reinterpret_cast<float4*>(gbase + L::o_recv) + wg * K * L::chunks * W;
  uint2* dlog = reinterpret_cast<uint2*>(gbase + L::o_dlog) + wg * 8 * W;
  float* cols = reinterpret_cast<float*>(gbase + L::o_cols) + wg * 2 * 3 * kS;

  // Bytes that reach this block's barriers a tile: the partials of its
  // `mine` chunks from K - 1 peers, and the dlog of the other chunks.
  int mine = 0;
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8) mine += c8 % K == rank;
  const uint32_t partial_bytes = (K - 1) * mine * W * 16, dlog_bytes = (8 - mine) * W * 8;

  const CUtensorMap* smap = &str_map;
  auto load_tile = [=](int i) {  // tile i into its ring stage (thread 0)
    const int st = i % ST;
    mbar_expect_tx(full + st * 8, L::stage);
#pragma unroll
    for (int p = 0; p < P; ++p)
      tma_load_2d(s_str + st * L::stage + p * kS * 128, smap, full + st * 8, col0 + p * 64,
                  i * kS);
  };

  if (tid == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(full + st * 8, 1);
      mbar_init(empty + st * 8, kWgThreads);
    }
    mbar_init(own_bar, 1);
    for (int w = 0; K > 1 && w < 2; ++w) {  // phase 0 expects its bytes now
      mbar_init(own_bar + 8 + w * 8, 1);
      mbar_init(own_bar + 24 + w * 8, 1);
      mbar_expect_tx(own_bar + 8 + w * 8, partial_bytes);
      mbar_expect_tx(own_bar + 24 + w * 8, dlog_bytes);
    }
    fence_mbar_init();
  }
  if (K > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (tid == 0) {
    mbar_expect_tx(own_bar, L::own);
#pragma unroll
    for (int p = 0; p < P; ++p)
      tma_load_2d(s_own + p * kM * 128, &own_map, own_bar, col0 + p * 64, own0);
    for (int i = 0; i < ST && i < tiles; ++i) load_tile(i);
  }

  // per-row values of dx's owned tokens; dw's owned rows only need the bound
  bool row_ok[2];
  float row_lse[2] = {0.f, 0.f}, row_c[2] = {0.f, 0.f};
  int row_t[2] = {-1, -1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = own0 + row0 + 8 * h;
    row_ok[h] = r < n_own;
    if (OWN_TOKENS && row_ok[h]) {
      row_lse[h] = a.lse[r];
      row_c[h] = a.c[r];
      row_t[h] = a.t[r];
    }
  }

  float out[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int e = 0; e < 64; ++e) out[h][e] = 0.f;

  mbar_wait(own_bar, 0);
  for (int i = 0; i < tiles; ++i) {
    const int st = i % ST, s0 = i * kS;
    const uint32_t sb = s_str + st * L::stage;
    float* cb = cols + (i & 1) * 3 * kS;
    // dw: this tile's per-token values, loaded while the logits run
    float tok_lse = 0.f, tok_c = 0.f;
    int tok_t = -1;
    if (!OWN_TOKENS && wt < kS && s0 + wt < n_str) {
      tok_lse = a.lse[s0 + wt];
      tok_c = a.c[s0 + wt];
      tok_t = a.t[s0 + wt];
    }
    mbar_wait(full + st * 8, (i / ST) & 1);

    // 1. partial logits of this block's D slice
    float lg[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) lg[e] = 0.f;
    fence_regs(lg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      const uint32_t k_off = (kk & 3) * 32;  // 16 columns of a 64-column box
      wgmma_m64n64k16_ss(lg, kmajor_desc(s_own + (kk / 4) * kM * 128 + wg * 64 * 128 + k_off),
                         kmajor_desc(sb + (kk / 4) * kS * 128 + k_off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(lg);

    // 2. send each fragment chunk's partial to the block that reduces it
    if (!OWN_TOKENS && wt < kS) {
      cb[wt] = tok_lse;
      cb[kS + wt] = tok_c;
      cb[2 * kS + wt] = __int_as_float(tok_t);
    }
    if (K > 1) {
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        if (c8 % K == rank) continue;
        const uint32_t slot = smem_u32(&recv[(rank * L::chunks + c8 / K) * W + wt]);
        st_async_f4(map_rank(slot, c8 % K), lg[4 * c8], lg[4 * c8 + 1], lg[4 * c8 + 2],
                    lg[4 * c8 + 3], map_rank(exchanged, c8 % K));
      }
      mbar_wait(exchanged, i & 1);
      if (wt == 0) mbar_expect_tx(exchanged, partial_bytes);  // the next tile's
    }
    if (!OWN_TOKENS) named_sync(1 + wg, W);  // cb is written

    // 3. reduce chunks c8 = rank (mod K) in rank order, form dlog, round it
    // to bf16 and write it into every block of the cluster
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      if (c8 % K != rank) continue;
      float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const float4 v = r == rank ? make_float4(lg[4 * c8], lg[4 * c8 + 1], lg[4 * c8 + 2],
                                                 lg[4 * c8 + 3])
                                   : recv[(r * L::chunks + c8 / K) * W + wt];
        if (r == 0) {
          z[0] = v.x;
          z[1] = v.y;
          z[2] = v.z;
          z[3] = v.w;
        } else {
          z[0] += v.x;
          z[1] += v.y;
          z[2] += v.z;
          z[3] += v.w;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = 8 * c8 + 2 * tq + (e & 1);
        float dl = 0.f;
        if (OWN_TOKENS) {
          const int voc = s0 + col;
          if (row_ok[h] && voc < n_str)
            dl = row_c[h] * (expf(z[e] - row_lse[h]) - (voc == row_t[h] ? 1.f : 0.f));
        } else {
          const int voc = own0 + row0 + 8 * h;
          if (row_ok[h] && s0 + col < n_str)
            dl = cb[kS + col] *
                 (expf(z[e] - cb[col]) - (voc == __float_as_int(cb[2 * kS + col]) ? 1.f : 0.f));
        }
        z[e] = dl;
      }
      const uint32_t lo = pack2(z[0], z[1]), hi = pack2(z[2], z[3]);
      const uint32_t slot = smem_u32(&dlog[c8 * W + wt]);
#pragma unroll
      for (int r = 0; r < K; ++r)
        if (r != rank) st_async_u2(map_rank(slot, r), lo, hi, map_rank(ready, r));
      dlog[c8 * W + wt] = make_uint2(lo, hi);  // read back by this thread only
    }
    if (K > 1) {
      mbar_wait(ready, i & 1);
      if (wt == 0) mbar_expect_tx(ready, dlog_bytes);
    }

    // 4. out += dlog . tile slice (A: chunks 2j and 2j + 1 are step j)
    uint32_t af[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint2 lo = dlog[2 * j * W + wt], hi = dlog[(2 * j + 1) * W + wt];
      af[j][0] = lo.x;
      af[j][1] = lo.y;
      af[j][2] = hi.x;
      af[j][3] = hi.y;
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs(out[h]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kS / 16; ++j)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wgmma_m64n128k16_rs(out[h], af[j],
                            mnmajor_desc(sb + 2 * h * kS * 128 + j * 16 * 128, kS * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) fence_regs(out[h]);

    // 5. both warpgroups are done with the stage: refill it
    mbar_arrive(empty + st * 8);
    if (tid == 0 && i + ST < tiles) {
      mbar_wait(empty + st * 8, (i / ST) & 1);
      load_tile(i + ST);
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = own0 + row0 + 8 * hr;
    if (r >= n_own) continue;
    float* row = a.out + static_cast<long long>(r) * D + col0 + 2 * tq;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(row + h * 128 + 8 * j) =
            make_float2(out[h][4 * j + 2 * hr], out[h][4 * j + 2 * hr + 1]);
  }
}

template <int D, int K, int ST, bool OWN_TOKENS>
cudaError_t launch_wgmma(const BwdArgs& a, int smem, cudaStream_t stream) {
  using L = Layout<D / K, K, ST>;
  if (smem != L::smem) return cudaErrorInvalidValue;
  const int n_own = OWN_TOKENS ? a.n : a.v, n_str = OWN_TOKENS ? a.v : a.n;
  CUtensorMap own_map, str_map;
  cudaError_t err = sm90::encode_bf16_2d(&own_map, OWN_TOKENS ? a.x : a.w, n_own, D, kM);
  if (err != cudaSuccess) return err;
  err = sm90::encode_bf16_2d(&str_map, OWN_TOKENS ? a.w : a.x, n_str, D, kS);
  if (err != cudaSuccess) return err;
  auto kernel = xent_bwd_wgmma_kernel<D, K, ST, OWN_TOKENS>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((n_own + kM - 1) / kM) * K);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = L::smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, own_map, str_map, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ------------------------------------------------------ fp32: CUDA-core FMAs

using namespace xent;

constexpr int kOwn = 32;  // owned rows per block
constexpr int kSC = 16;   // streamed rows per phase-2 chunk

template <int D>
__host__ __device__ constexpr int stage_elems() {
  constexpr int p1 = logits_smem_elems<float, kOwn>();
  constexpr int p2 = 2 * kSC * (D + pad<float>());
  return p1 > p2 ? p1 : p2;
}

template <int D>
__host__ __device__ constexpr int fma_smem_bytes() {
  return (stage_elems<D>() + kOwn * (kStream + pad<float>())) * 4;
}

template <int D, bool OWN_TOKENS>
__global__ void __launch_bounds__(kThreads, 1) xent_bwd_fma_kernel(const BwdArgs a) {
  constexpr int NT = D / 64;                   // n-tiles of a warp's D / 8 columns
  constexpr int ldd = kStream + pad<float>();  // dlog tile stride
  constexpr int ldc = D + pad<float>();        // phase-2 chunk stride
  constexpr int buf = kSC * ldc;               // one phase-2 buffer
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // phase 1, then phase 2
  float* sD = stage + stage_elems<D>();

  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const float* own = OWN_TOKENS ? x : w;
  const float* str = OWN_TOKENS ? w : x;
  const int n_own = OWN_TOKENS ? a.n : a.v;
  const int n_str = OWN_TOKENS ? a.v : a.n;
  const int own0 = blockIdx.x * kOwn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col0 = warp * (D / 8);

  float out[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[mi][ni][e] = 0.f;

  float lg[2][2][4];
  for (int s0 = 0; s0 < n_str; s0 += kStream) {
    logits_tile<float, kOwn>(own, n_own, own0, str, n_str, s0, D, stage, lg);
    // dlog tile (kOwn, kStream)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mi * 16 + g + 8 * (e >> 1);
          const int j = warp * 16 + ni * 8 + 2 * t + (e & 1);
          const int tok = OWN_TOKENS ? own0 + r : s0 + j;
          const int voc = OWN_TOKENS ? s0 + j : own0 + r;
          float dl = 0.f;
          if (tok < a.n && voc < a.v) {
            const float p = expf(lg[mi][ni][e] - a.lse[tok]);
            dl = a.c[tok] * (p - (voc == a.t[tok] ? 1.f : 0.f));
          }
          sD[r * ldd + j] = dl;
        }
    // out += dlog . streamed rows, kSC rows at a time
    auto prefetch = [&](int c) {
      load_rows<float, kSC, D>(str, D, s0 + c * kSC, n_str, 0, stage + (c & 1) * buf, ldc);
      cp_async_commit();
    };
    constexpr int chunks = kStream / kSC;
    __syncthreads();  // phase 1 is done with `stage`; sD is written
    prefetch(0);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        prefetch(c + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      WarpMma<float, 2, NT, kSC, true>::run(sD + c * kSC, ldd, stage + (c & 1) * buf + col0, ldc,
                                            out);
      __syncthreads();  // chunk c + 2 goes into this buffer next
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = own0 + mi * 16 + g + 8 * h;
      if (r >= n_own) continue;
      float* row = a.out + static_cast<long long>(r) * D + col0 + 2 * t;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        *reinterpret_cast<float2*>(row + ni * 8) =
            make_float2(out[mi][ni][2 * h], out[mi][ni][2 * h + 1]);
    }
}

template <int D, bool OWN_TOKENS>
cudaError_t launch_fma(const BwdArgs& a, int smem, cudaStream_t stream) {
  if (smem != fma_smem_bytes<D>()) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(xent_bwd_fma_kernel<D, OWN_TOKENS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = OWN_TOKENS ? a.n : a.v;
  xent_bwd_fma_kernel<D, OWN_TOKENS><<<(rows + kOwn - 1) / kOwn, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The plan (K, M, S, stages, smem) must be one the templates were built
// for: ops/fused_xent.py's xent_bwd_plan computes it, this checks it.
template <bool OWN_TOKENS>
cudaError_t dispatch(const BwdArgs& a, int d, int bf16, int kc, int m, int s, int stages,
                     int smem, cudaStream_t st) {
  if (!bf16) {
    if (kc != 1 || m != kOwn || s != kStream || stages != 2) return cudaErrorInvalidValue;
    if (d == 768) return launch_fma<768, OWN_TOKENS>(a, smem, st);
    if (d == 1024) return launch_fma<1024, OWN_TOKENS>(a, smem, st);
    if (d == 128) return launch_fma<128, OWN_TOKENS>(a, smem, st);
    return cudaErrorInvalidValue;
  }
  if (m != kM || s != kS) return cudaErrorInvalidValue;
  if (d == 768 && kc == 3 && stages == 3) return launch_wgmma<768, 3, 3, OWN_TOKENS>(a, smem, st);
  if (d == 1024 && kc == 4 && stages == 3)
    return launch_wgmma<1024, 4, 3, OWN_TOKENS>(a, smem, st);
  if (d == 128 && kc == 1 && stages == 4) return launch_wgmma<128, 1, 4, OWN_TOKENS>(a, smem, st);
  return cudaErrorInvalidValue;
}

template <bool OWN_TOKENS>
int run(const void* x, const void* w, const void* t, const void* lse, const void* c, void* out,
        int n, int v, int d, int bf16, int kc, int m, int s, int stages, int smem, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || v <= 0) return cudaErrorInvalidValue;
  const BwdArgs a{x, w, static_cast<const int*>(t), static_cast<const float*>(lse),
                  static_cast<const float*>(c), static_cast<float*>(out), n, v};
  return static_cast<int>(dispatch<OWN_TOKENS>(a, d, bf16, kc, m, s, stages, smem,
                                               static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared conventions: x (N, D) and w (V, D) contiguous and 16-byte
// aligned, both bf16 or both fp32, D one of 128, 768, 1024; t (N,)
// int32; lse and c (N,) fp32.  dx writes (N, D) fp32, dw (V, D) fp32,
// both contiguous.  (kc, m, s, stages, smem) is the plan: cluster size,
// owned rows, streamed rows, ring stages and dynamic shared memory in
// bytes; a plan the kernels were not built for returns
// cudaErrorInvalidValue.  Each returns the CUDA error of its launch (0
// on success).
extern "C" int dtf_xent_bwd_dx(const void* x, const void* w, const void* t, const void* lse,
                               const void* c, void* dx, int n, int v, int d, int bf16, int kc,
                               int m, int s, int stages, int smem, int device, void* stream) {
  return run<true>(x, w, t, lse, c, dx, n, v, d, bf16, kc, m, s, stages, smem, device, stream);
}

extern "C" int dtf_xent_bwd_dw(const void* x, const void* w, const void* t, const void* lse,
                               const void* c, void* dw, int n, int v, int d, int bf16, int kc,
                               int m, int s, int stages, int smem, int device, void* stream) {
  return run<false>(x, w, t, lse, c, dw, n, v, d, bf16, kc, m, s, stages, smem, device, stream);
}
