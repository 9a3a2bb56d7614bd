// Fused LM-head forward for Hopper (sm_90a): per-token logsumexp of
// x . w^T and the target logit, without the logits ever reaching memory.
//
// Replaces the TPU kernel `_fwd_kernel`
// (distributedtensorflow_tpu/ops/fused_xent.py:136, launched by
// `_fused_fwd_arrays` at :275/:300).  Same function: from x (N, D) and
// the tied table w (V, D), both rounded to the compute type by the
// caller, and the targets t (N,) int32,
//   lse[n] = log sum_v exp(x[n] . w[v]),   tgt[n] = x[n] . w[t[n]],
// products and sums in fp32.  Vocab rows >= V are left out by a bound
// check (the TPU pads them and masks them with NEG_INF); a target
// outside [0, V) matches no row, so its tgt is 0 (its weight is 0).
//
// What bounds it on the H100: operations, 2 N V D flops (1.26e12 at the
// gpt_lm step: 1.3 ms at 989 TFLOP/s bf16); its bytes (x and w once,
// ~0.1 GB) are far below.  Design: one block of 256 threads owns 64
// tokens and sweeps the whole vocabulary in tiles of 128 rows, the
// operands staged by cp.async two chunks deep (xent_common.cuh); the
// bf16 tile products run on the tensor cores (mma.sync m16n8k16), fp32
// ones on the CUDA cores.  Each lane keeps an online (max, sum) and the
// target logit for each of its rows over its own columns; at the end the
// lanes of a row and then the 8 warps merge their partials in a fixed
// order, so the result is deterministic.  w and the token tile are
// staged chunk by chunk, from L2 where the blocks in flight share them:
// about 43 flops per staged byte, where the tensor cores at their peak
// need about 180 per byte of L2, so this design cannot reach its bound
// (128 tokens a block measured slower on the H100).  TMA multicast
// across a cluster and wgmma tiles are later work.

#include <math.h>

#include "xent_common.cuh"

namespace {

using namespace xent;

constexpr int kOwn = 64;  // tokens per block
constexpr int kMT = kOwn / 16;

struct FwdArgs {
  const void* x;
  const void* w;
  const int* t;
  float* lse;
  float* tgt;
  int n, v, d;
};

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) xent_fwd_kernel(const FwdArgs a) {
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  __shared__ float red_m[kWarps][kOwn], red_s[kWarps][kOwn], red_t[kWarps][kOwn];

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
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
    logits_tile<T, kOwn>(x, a.n, tok0, w, a.v, v0, a.d, smem, acc);
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

template <typename T>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  const int smem = logits_smem_elems<T, kOwn>() * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(xent_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kOwn - 1) / kOwn);
  xent_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (N, D) and w (V, D) contiguous, both bf16 or both fp32, D a multiple
// of 64; t (N,) int32; lse and tgt (N,) fp32 outputs.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int dtf_xent_fwd(const void* x, const void* w, const void* t, void* lse, void* tgt,
                            int n, int v, int d, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || v <= 0 || d <= 0 || d % kKC) return cudaErrorInvalidValue;
  const FwdArgs a{x, w, static_cast<const int*>(t), static_cast<float*>(lse),
                  static_cast<float*>(tgt), n, v, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
  return static_cast<int>(err);
}
