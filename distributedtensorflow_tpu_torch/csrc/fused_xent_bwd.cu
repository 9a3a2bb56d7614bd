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
// Rows >= N or >= V give dlog = 0 (a bound check replaces the padding).
//
// What bounds them on the H100: operations, two products of 2 N V D
// flops each (2.5 ms at the gpt_lm step at 989 TFLOP/s bf16).
//
// Design: one kernel template for both.  A block of 256 threads owns 32
// rows of one operand (tokens for dx, vocab rows for dw) with their
// (32, D) fp32 output in registers (warp w holds columns [w D/8,
// (w+1) D/8)), and streams all rows of the other operand in tiles of
// 128: phase 1 forms the (32, 128) logits tile (xent_common.cuh), the
// epilogue turns it into the rounded dlog tile in shared memory, phase 2
// multiplies it by the tile's 128 streamed rows, staged 32 (fp32: 16)
// at a time by cp.async, two buffers deep (bf16: mma.sync with the B
// fragments from ldmatrix.trans; fp32: FMAs on the CUDA cores).  Each output element is summed by one thread in a
// fixed order: no atomics, bit-identical on a rerun.  The streamed rows
// are read twice per tile (phase 1 in column chunks, phase 2 whole),
// mostly from L2; the logits are recomputed once per kernel, as on the
// TPU.  32 owned rows (as many as the registers hold at D = 1024) give
// about 57 flops per staged byte, where the tensor cores at their peak
// need about 180 per byte of L2, so this design cannot reach its bound;
// TMA multicast across a cluster and wgmma tiles are later work.

#include <math.h>

#include "xent_common.cuh"

namespace {

using namespace xent;

constexpr int kOwn = 32;  // owned rows per block

// Streamed rows per phase-2 chunk: two chunks of (kSC, D) fit beside the
// dlog tile at D = 1024 in either type.
template <typename T>
__host__ __device__ constexpr int sc() { return 64 / static_cast<int>(sizeof(T)); }

struct BwdArgs {
  const void* x;
  const void* w;
  const int* t;
  const float* lse;
  const float* c;
  float* out;  // dx (N, D) or dw (V, D), fp32
  int n, v;
};

template <typename T, int D>
__host__ __device__ constexpr int stage_elems() {
  constexpr int p1 = logits_smem_elems<T, kOwn>();
  constexpr int p2 = 2 * sc<T>() * (D + pad<T>());
  return p1 > p2 ? p1 : p2;
}

template <typename T, int D>
__host__ __device__ constexpr int bwd_smem_elems() {
  return stage_elems<T, D>() + kOwn * (kStream + pad<T>());
}

// OWN_TOKENS: the dx kernel (owned rows are tokens, streamed rows vocab);
// otherwise the dw kernel (owned rows vocab, streamed rows tokens).
template <typename T, int D, bool OWN_TOKENS>
__global__ void __launch_bounds__(kThreads, 1) xent_bwd_kernel(const BwdArgs a) {
  constexpr int NT = D / 64;               // n-tiles of a warp's D / 8 columns
  constexpr int ldd = kStream + pad<T>();  // dlog tile stride
  constexpr int ldc = D + pad<T>();        // phase-2 chunk stride
  constexpr int kSC = sc<T>();
  constexpr int buf = kSC * ldc;           // one phase-2 buffer
  extern __shared__ float4 smem4[];
  T* stage = reinterpret_cast<T*>(smem4);  // phase 1, then phase 2
  T* sD = stage + stage_elems<T, D>();

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const T* own = OWN_TOKENS ? x : w;
  const T* str = OWN_TOKENS ? w : x;
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
    logits_tile<T, kOwn>(own, n_own, own0, str, n_str, s0, D, stage, lg);
    // dlog tile (kOwn, kStream), rounded to T
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
          sD[r * ldd + j] = from_float<T>(dl);
        }
    // out += dlog . streamed rows, kSC rows at a time
    auto prefetch = [&](int c) {
      load_rows<T, kSC, D>(str, D, s0 + c * kSC, n_str, 0, stage + (c & 1) * buf, ldc);
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
      WarpMma<T, 2, NT, kSC, true>::run(sD + c * kSC, ldd, stage + (c & 1) * buf + col0, ldc,
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

template <typename T, int D, bool OWN_TOKENS>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int smem = bwd_smem_elems<T, D>() * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(xent_bwd_kernel<T, D, OWN_TOKENS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = OWN_TOKENS ? a.n : a.v;
  const dim3 grid((rows + kOwn - 1) / kOwn);
  xent_bwd_kernel<T, D, OWN_TOKENS><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool OWN_TOKENS>
int run(const void* x, const void* w, const void* t, const void* lse, const void* c, void* out,
        int n, int v, int d, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || v <= 0) return cudaErrorInvalidValue;
  const BwdArgs a{x, w, static_cast<const int*>(t), static_cast<const float*>(lse),
                  static_cast<const float*>(c), static_cast<float*>(out), n, v};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (d == 768)
    err = bf16 ? launch<bf, 768, OWN_TOKENS>(a, st) : launch<float, 768, OWN_TOKENS>(a, st);
  else if (d == 1024)
    err = bf16 ? launch<bf, 1024, OWN_TOKENS>(a, st) : launch<float, 1024, OWN_TOKENS>(a, st);
  else if (d == 128)
    err = bf16 ? launch<bf, 128, OWN_TOKENS>(a, st) : launch<float, 128, OWN_TOKENS>(a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared conventions: x (N, D) and w (V, D) contiguous, both bf16 or both
// fp32, D one of 128, 768, 1024; t (N,) int32; lse and c (N,) fp32.
// dx writes (N, D) fp32, dw (V, D) fp32, both contiguous.  Each returns
// the CUDA error of its launch (0 on success).
extern "C" int dtf_xent_bwd_dx(const void* x, const void* w, const void* t, const void* lse,
                               const void* c, void* dx, int n, int v, int d, int bf16,
                               int device, void* stream) {
  return run<true>(x, w, t, lse, c, dx, n, v, d, bf16, device, stream);
}

extern "C" int dtf_xent_bwd_dw(const void* x, const void* w, const void* t, const void* lse,
                               const void* c, void* dw, int n, int v, int d, int bf16,
                               int device, void* stream) {
  return run<false>(x, w, t, lse, c, dw, n, v, d, bf16, device, stream);
}
