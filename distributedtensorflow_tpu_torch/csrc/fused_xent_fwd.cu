// Fused LM-head forward for Hopper (sm_90a): per-token logsumexp of
// x . w^T and the target logit, without the logits ever reaching memory.
//
// Replaces the TPU kernel `_fwd_kernel`
// (distributedtensorflow_tpu/ops/fused_xent.py:136, launched by
// `_fused_fwd_arrays` at :275/:300).  Same function: from x (N, D) and
// the tied table w (V, D), both rounded to the compute type by the
// caller, and the targets t (N,) int32,
//   lse[n] = log sum_v exp(x[n] . w[v]),   tgt[n] = x[n] . w[t[n]],
// products and sums in fp32.  Vocab rows >= V are left out (the TPU pads
// them and masks them with NEG_INF); a target outside [0, V) matches no
// row, so its tgt is 0 (its weight is 0).
//
// What bounds it on the H100: operations, 2 N V D flops (1.26e12 at
// gpt_lm's head, N 16376, D 768, V 50257: 1.278 ms at 989 TFLOP/s bf16);
// its bytes (x and w once, ~0.1 GB) are far below.  What stands between
// the two is the traffic from L2 into shared memory: every block sweeps
// the whole vocabulary, so w is read once a block and x once a vocab tile.
//
// bf16 (xent_fwd_wgmma_kernel; the plan is ops/fused_xent.py's
// xent_fwd_plan): a block owns M = 128 tokens and sweeps the vocabulary in
// tiles of 256 rows, contracting over D in chunks of 64 columns.  Three
// roles in 384 threads:
//   - a producer warpgroup (setmaxnreg: 24 registers a thread), whose
//     first lane keeps a ring of ST = 4
//     stages in flight by TMA: a stage is the x chunk (128 x 64) and the w
//     chunk (256 x 64), 48 KB in boxes of 64 columns with the 128-byte
//     swizzle, completing on the stage's `full` mbarrier;
//   - two consumer warpgroups of 64 tokens each (setmaxnreg: 240
//     registers a thread), which run the chunk's products as wgmma
//     m64n256k16 with both operands K-major in shared memory (64 x 256
//     fp32 accumulator: 128 registers a thread), keep one
//     chunk's products in flight (wgmma.wait_group 1), and release a stage
//     by one arrival a warp on its `empty` mbarrier;
//   - after a tile's last chunk, each warpgroup's epilogue in registers,
//     in the accumulator layout (sm90_common.cuh): columns >= V set to
//     -inf before the max (TMA fills them with zeros, whose logit 0 would
//     otherwise add exp(0 - m) to the sum), the target logit picked by a
//     column compare in the one tile that holds it, and each thread's
//     running (max, sum) of its two rows over its own columns updated with
//     ex2.approx, log2(e) folded into one FMA an element.  The warpgroups
//     drift apart as far as the ring lets them, so one's exponentials
//     overlap the other's products.
// After the sweep the four lanes of a row merge (max, sum, tgt) by two
// xor shuffles, which give every lane the same value; a warpgroup's rows
// are its own, so there is no merge across blocks and no atomic: reruns
// are bit-identical.  Rows >= N (TMA's zeros) are not stored; D is any
// multiple of 64 (the chunk loop runs D / 64 times, the ring's depth does
// not assume more chunks than a tile has).
//
// A cluster of two blocks on adjacent token ranges sharing each w chunk
// by TMA multicast (half the w bytes from L2) measured twice as slow at
// gpt_lm's head and was dropped.
//
// Intensity: a 48 KB stage feeds 128 x 256 x 64 x 2 = 4.19 MFLOP, 85 flops
// a staged byte (the mma.sync design it replaced staged 43).  Shared
// memory: 1 KB to align the base + 4 x 48 KB + barriers = 197,696 bytes
// (one block an SM); grid ceil(N / 128) blocks: 128 at gpt_lm's head,
// about one wave on 132 SMs.  ptxas -v: 168 registers a thread at launch
// (12 warps over the register file's four quarters, three to a quarter),
// the consumers raised to 240 by setmaxnreg; 416 bytes of spill.
//
// fp32 (xent_fwd_fma_kernel, the parity steps' path): the CUDA cores.  One
// block of 256 threads owns 64 tokens and sweeps the vocabulary in tiles
// of 128 rows, staged by cp.async two chunks deep (xent_common.cuh's
// logits tile); each lane keeps an online (max, sum) and the target logit
// of its rows over its own columns, merged at the end over the lanes of a
// row and then the 8 warps in a fixed order.

#include <math.h>

#include "sm90_common.cuh"
#include "xent_common.cuh"

namespace {

struct FwdArgs {
  const void* x;
  const void* w;
  const int* t;
  float* lse;
  float* tgt;
  int n, v, d;
};

// ------------------------------------------------------ bf16: wgmma + TMA

constexpr int kM = 128;           // tokens of a block: two warpgroups of 64
constexpr int kTile = 256;        // vocab rows of a tile
constexpr int kStages = 4;        // ring depth
constexpr int kThreadsWg = 384;   // two consumer warpgroups and a producer warpgroup
constexpr int kXBytes = kM * 128;      // x chunk: 128 rows of 64 bf16
constexpr int kWBytes = kTile * 128;   // w chunk: 256 rows of 64 bf16
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kSmemWg = 1024 + kStages * kStageBytes + kStages * 16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNoMax = -1e30f;  // running max before the first valid logit

__global__ void __launch_bounds__(kThreadsWg, 1)
    xent_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map, const FwdArgs a) {
  using namespace sm90;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + kStages * kStageBytes, empty = full + kStages * 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tok0 = blockIdx.x * kM;
  const int chunks = a.d / 64, tiles = (a.v + kTile - 1) / kTile;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s * 8, 1);
      mbar_init(empty + s * 8, 8);  // one arrival a consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  // One if-else whose branches never meet again, so that ptxas can give
  // each role its own register budget (setmaxnreg).
  if (warp >= 8) {  // producer warpgroup: warp 8's lane 0 issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      const int total = tiles * chunks;
      int c = 0, v0 = 0;
      for (int k = 0; k < total; ++k) {
        const int s = k % kStages;
        const uint32_t stage = base + s * kStageBytes;
        if (k >= kStages) mbar_wait(empty + s * 8, ((k / kStages) - 1) & 1);
        mbar_expect_tx(full + s * 8, kStageBytes);
        tma_load_2d(stage, &x_map, full + s * 8, c * 64, tok0);
        tma_load_2d(stage + kXBytes, &w_map, full + s * 8, c * 64, v0);
        if (++c == chunks) {
          c = 0;
          v0 += kTile;
        }
      }
    }
  } else {  // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp >> 2, g = lane >> 2, tq = lane & 3;
    const int row0 = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows: row0, row0 + 8
    int tt[2];
    float m[2] = {kNoMax, kNoMax}, s[2] = {0.f, 0.f}, tg[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = tok0 + row0 + 8 * h;
      const int t = tok < a.n ? a.t[tok] : -1;
      tt[h] = t >= 0 && t < a.v ? t : -1;
    }
    auto release = [&](int k) {
      if (lane == 0) mbar_arrive(empty + (k % kStages) * 8);
    };

    float acc[128];
    int k = 0;
    for (int vt = 0; vt < tiles; ++vt) {
      const int v0 = vt * kTile;
      for (int c = 0; c < chunks; ++c, ++k) {
        const int st = k % kStages;
        const uint32_t stage = base + st * kStageBytes;
        const uint32_t xs = stage + wg * 64 * 128, ws = stage + kXBytes;  // our 64 x rows; w
        mbar_wait(full + st * 8, (k / kStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n256k16_ss(acc, kmajor_desc(xs + kk * 32), kmajor_desc(ws + kk * 32),
                              (c | kk) != 0);
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          release(k - 1);
        }
      }
      wgmma_wait<0>();
      release(k - 1);
      fence_regs(acc);

      // epilogue: acc[4j + 2h + e] is row row0 + 8h, column v0 + 8j + 2tq + e
      if (v0 + kTile > a.v) {
#pragma unroll
        for (int j = 0; j < 32; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (v0 + 8 * j + 2 * tq + (e & 1) >= a.v) acc[4 * j + e] = -INFINITY;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = tt[h] - v0;  // tt -1 (no target) gives col < 0
        if (col >= 0 && col < kTile && ((col >> 1) & 3) == tq) {
#pragma unroll
          for (int j = 0; j < 32; ++j)  // static register indices only
            if (j == (col >> 3)) tg[h] = col & 1 ? acc[4 * j + 2 * h + 1] : acc[4 * j + 2 * h];
        }
        float mx0 = acc[2 * h], mx1 = acc[2 * h + 1];
#pragma unroll
        for (int j = 1; j < 32; ++j) {
          mx0 = fmaxf(mx0, acc[4 * j + 2 * h]);
          mx1 = fmaxf(mx1, acc[4 * j + 2 * h + 1]);
        }
        const float mnew = fmaxf(m[h], fmaxf(mx0, mx1));
        const float mb = mnew * kLog2e;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          s0 += exp2_approx(fmaf(acc[4 * j + 2 * h], kLog2e, -mb));
          s1 += exp2_approx(fmaf(acc[4 * j + 2 * h + 1], kLog2e, -mb));
        }
        s[h] = s[h] * exp2_approx((m[h] - mnew) * kLog2e) + (s0 + s1);
        m[h] = mnew;
      }
      fence_regs(acc);
    }

    // the four lanes of a row: two xor shuffles, the same value in each lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s[h], off);
        const float t2 = __shfl_xor_sync(0xffffffffu, tg[h], off);
        const float mx = fmaxf(m[h], m2);
        s[h] = s[h] * exp2_approx((m[h] - mx) * kLog2e) + s2 * exp2_approx((m2 - mx) * kLog2e);
        m[h] = mx;
        tg[h] += t2;
      }
      const int tok = tok0 + row0 + 8 * h;
      if (tq == 0 && tok < a.n) {
        a.lse[tok] = m[h] + logf(s[h]);
        a.tgt[tok] = tg[h];
      }
    }
  }
}

cudaError_t launch_wgmma(const FwdArgs& a, cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  cudaError_t err = sm90::encode_bf16_2d(&x_map, a.x, a.n, a.d, kM);
  if (err != cudaSuccess) return err;
  err = sm90::encode_bf16_2d(&w_map, a.w, a.v, a.d, kTile);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(xent_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemWg);
  if (err != cudaSuccess) return err;
  xent_fwd_wgmma_kernel<<<(a.n + kM - 1) / kM, kThreadsWg, kSmemWg, stream>>>(x_map, w_map, a);
  return cudaGetLastError();
}

// ------------------------------------------------------ fp32: CUDA-core FMAs

using namespace xent;

constexpr int kOwn = 64;  // tokens per block
constexpr int kMT = kOwn / 16;
constexpr int kSmemFma = logits_smem_elems<float, kOwn>() * 4;

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

__global__ void __launch_bounds__(kThreads) xent_fwd_fma_kernel(const FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red_m[kWarps][kOwn], red_s[kWarps][kOwn], red_t[kWarps][kOwn];

  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  const int tok0 = blockIdx.x * kOwn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // this lane's rows: mi * 16 + g + 8 h
  int tt[kMT][2];
  float m[kMT][2], s[kMT][2], tg[kMT][2];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = tok0 + mi * 16 + g + 8 * h;
      tt[mi][h] = tok < a.n ? a.t[tok] : -1;
      m[mi][h] = kInit;
      s[mi][h] = 0.f;
      tg[mi][h] = 0.f;
    }

  float acc[kMT][2][4];
  for (int v0 = 0; v0 < a.v; v0 += kStream) {
    logits_tile<float, kOwn>(x, a.n, tok0, w, a.v, v0, a.d, smem, acc);
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lmax = kInit;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int voc = v0 + warp * 16 + ni * 8 + 2 * t + e;
            const float l = acc[mi][ni][2 * h + e];
            if (voc < a.v) {
              lmax = fmaxf(lmax, l);
              if (voc == tt[mi][h]) tg[mi][h] += l;
            }
          }
        const float mx = fmaxf(m[mi][h], lmax);
        float sum = s[mi][h] * expf(m[mi][h] - mx);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int voc = v0 + warp * 16 + ni * 8 + 2 * t + e;
            if (voc < a.v) sum += expf(acc[mi][ni][2 * h + e] - mx);
          }
        m[mi][h] = mx;
        s[mi][h] = sum;
      }
  }

  // merge the 4 lanes of a row (t = 0..3), then the 8 warps in order
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[mi][h], off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s[mi][h], off);
        const float t2 = __shfl_xor_sync(0xffffffffu, tg[mi][h], off);
        merge(m[mi][h], s[mi][h], m2, s2);
        tg[mi][h] += t2;
      }
      if (t == 0) {
        const int r = mi * 16 + g + 8 * h;
        red_m[warp][r] = m[mi][h];
        red_s[warp][r] = s[mi][h];
        red_t[warp][r] = tg[mi][h];
      }
    }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < kOwn && tok0 + r < a.n) {
    float mm = red_m[0][r], ss = red_s[0][r], tsum = red_t[0][r];
    for (int wi = 1; wi < kWarps; ++wi) {
      merge(mm, ss, red_m[wi][r], red_s[wi][r]);
      tsum += red_t[wi][r];
    }
    a.lse[tok0 + r] = mm + logf(ss);
    a.tgt[tok0 + r] = tsum;
  }
}

cudaError_t launch_fma(const FwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(xent_fwd_fma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemFma);
  if (err != cudaSuccess) return err;
  xent_fwd_fma_kernel<<<(a.n + kOwn - 1) / kOwn, kThreads, kSmemFma, stream>>>(a);
  return cudaGetLastError();
}

// The plan (m, tile, stages, cluster, threads, smem) must be one the
// kernels were built for: ops/fused_xent.py's xent_fwd_plan computes it,
// this checks it.
cudaError_t dispatch(const FwdArgs& a, int bf16, int m, int tile, int stages, int cluster,
                     int threads, int smem, cudaStream_t st) {
  if (!bf16) {
    if (m != kOwn || tile != kStream || stages != 2 || cluster != 1 || threads != kThreads ||
        smem != kSmemFma)
      return cudaErrorInvalidValue;
    return launch_fma(a, st);
  }
  if (m != kM || tile != kTile || stages != kStages || cluster != 1 || threads != kThreadsWg ||
      smem != kSmemWg)
    return cudaErrorInvalidValue;
  return launch_wgmma(a, st);
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (N, D) and w (V, D) contiguous and 16-byte aligned, both bf16 or both
// fp32, D a multiple of 64; t (N,) int32; lse and tgt (N,) fp32 outputs.
// (m, tile, stages, cluster, threads, smem) is the plan: tokens of a
// block, vocab rows of a tile, ring stages, blocks of a cluster, threads
// of a block and dynamic shared memory in bytes; a plan the kernels were
// not built for returns cudaErrorInvalidValue.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int dtf_xent_fwd(const void* x, const void* w, const void* t, void* lse, void* tgt,
                            int n, int v, int d, int bf16, int m, int tile, int stages,
                            int cluster, int threads, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || v <= 0 || d <= 0 || d % 64) return cudaErrorInvalidValue;
  const FwdArgs a{x, w, static_cast<const int*>(t), static_cast<float*>(lse),
                  static_cast<float*>(tgt), n, v, d};
  return static_cast<int>(dispatch(a, bf16, m, tile, stages, cluster, threads, smem,
                                   static_cast<cudaStream_t>(stream)));
}
