// Single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_attn_kernel`
// (distributedtensorflow_tpu/ops/attention.py:279, launched by
// `_pallas_decode_attention` at :389; `cached_decode_attention` calls it
// when one new token is decoded).  Same function: for every batch row b
// and query head h, one query against the contiguous (B, Hkv, S, D) cache,
//   s = scale * q . k          (fp32 accumulation)
//   w = softmax(s) in fp32, normalised, then rounded to V's type
//   o = w . V                  (fp32 accumulation, rounded to q's type)
// over the positions [lo, hi) that the shared causal and sliding-window
// mask keeps.  The TPU kernel scores every cache position and sets the
// masked ones to -1e9, whose weight exp(-1e9 - max) is exactly 0 in fp32;
// this kernel skips them, which gives the same sums.  Under GQA query
// head h reads kv head h / group.
//
// What bounds it on the H100: the K/V read.  It moves
// 2 * B * Hkv * (hi - lo) * D * sizeof(T) bytes and does 4 operations
// per query head per cached element, under one operation per byte at
// GPT-2 shapes, so its floor is those bytes / 3.35 TB/s (gpt_small, B=4,
// S=2048, bf16: 25 MB, about 7.5 us).
//
// Design: one block of 256 threads per (b, kv head), serving that head's
// whole query group, so each K/V row is read once per group, as the TPU
// kernel's head blocks do (:308-312).  Rows arrive as 16-byte vectors:
// D / VEC lanes share a row and a warp covers 32 / (D / VEC) rows per
// load.  Pass 1 writes the group's scores to fp32 shared memory
// (group * (hi - lo) * 4 bytes); pass 2 gives each query head a warp for
// its max, sum and normalisation; pass 3 streams V with the group's
// accumulators in registers, and the warps' partial sums meet in shared
// memory.  The wrapper (ops/attention.py) raises where the scores would
// not fit a block's 227 KB.  Not done yet, for a later change: splitting
// S across blocks (B * Hkv blocks fill few of the 132 SMs at small batch),
// cp.async/TMA prefetch, and tensor-core products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load_vec(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  union { uint4 u; __nv_bfloat162 h[4]; } pack;
  pack.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pack.h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, int h,
                   int hkv, int s_max, int d, int lo, int hi, float scale) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float smem[];
  const int n = hi - lo;
  const int g = h / hkv;
  float* scores = smem;         // [g][n]
  float* red = smem + g * n;    // [kWarps][g][d]

  const int b = blockIdx.x / hkv;
  const int hk = blockIdx.x % hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lpr = d / V;        // lanes per row
  const int rpw = 32 / lpr;     // rows per warp load
  const int sub = lane / lpr;   // this lane's row within the warp load
  const int c = lane % lpr;     // this lane's 16-byte column chunk
  const int rstep = kWarps * rpw;
  const size_t kv_off = static_cast<size_t>(b * hkv + hk) * s_max * d;
  const T* kb = k + kv_off + static_cast<size_t>(lo) * d + c * V;
  const T* vb = v + kv_off + static_cast<size_t>(lo) * d + c * V;
  const T* qb = q + (static_cast<size_t>(b) * h + hk * g) * d + c * V;

  float qr[kMaxGroup][V];
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j)
    if (j < g) load_vec(qb + j * d, qr[j]);

  // Pass 1: scores of the group's query heads against rows [lo, hi).
  // The loop bound is uniform across the warp, so every lane reaches the
  // shuffles; lanes past the end compute on zeros and write nothing.
  for (int base = warp * rpw; base < n; base += rstep) {
    const int r = base + sub;
    float kr[V];
    if (r < n) {
      load_vec(kb + static_cast<size_t>(r) * d, kr);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) kr[e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j) {
      if (j < g) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) p += qr[j][e] * kr[e];
        for (int off = lpr >> 1; off; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
        if (r < n && c == 0) scores[j * n + r] = p * scale;
      }
    }
  }
  __syncthreads();

  // Pass 2: one warp per query head: max, exp, sum, then the normalised
  // weight rounded to V's type (the TPU kernel's `.astype(v_ref.dtype)`).
  for (int j = warp; j < g; j += kWarps) {
    float* sj = scores + j * n;
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, sj[i]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(sj[i] - m);
      sj[i] = p;
      l += p;
    }
    l = warp_sum(l);
    for (int i = lane; i < n; i += 32) sj[i] = round_to(sj[i] / l, static_cast<T*>(nullptr));
  }
  __syncthreads();

  // Pass 3: o = w . V with fp32 accumulators in registers.
  float acc[kMaxGroup][V];
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
  for (int r = warp * rpw + sub; r < n; r += rstep) {
    float vr[V];
    load_vec(vb + static_cast<size_t>(r) * d, vr);
#pragma unroll
    for (int j = 0; j < kMaxGroup; ++j) {
      if (j < g) {
        const float w = scores[j * n + r];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[j][e] += w * vr[e];
      }
    }
  }
  // Sum the warp's row slots (lanes lpr apart hold the same columns) ...
#pragma unroll
  for (int j = 0; j < kMaxGroup; ++j) {
    if (j < g) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        for (int off = lpr; off < 32; off <<= 1)
          acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], off);
      if (sub == 0) {
#pragma unroll
        for (int e = 0; e < V; ++e) red[(warp * g + j) * d + c * V + e] = acc[j][e];
      }
    }
  }
  __syncthreads();
  // ... then the warps, and write the group's outputs.
  T* ob = out + (static_cast<size_t>(b) * h + hk * g) * d;
  for (int t = threadIdx.x; t < g * d; t += kThreads) {
    const int j = t / d, col = t % d;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * g + j) * d + col];
    store(ob + j * d + col, s);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int h, int hkv, int s_max, int d, int lo, int hi,
                   float scale, cudaStream_t stream) {
  const int g = h / hkv;
  const size_t smem =
      (static_cast<size_t>(g) * (hi - lo) + static_cast<size_t>(kWarps) * g * d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  decode_attn_kernel<T><<<b * hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), h, hkv, s_max, d, lo,
      hi, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, out (B, 1, H, D); k, v (B, Hkv, s_max, D); all bf16 or all fp32,
// contiguous.  Attends positions [lo, hi) of the cache.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int dtf_decode_attention(const void* q, const void* k,
                                    const void* v, void* out, int b, int h,
                                    int hkv, int s_max, int d, int lo, int hi,
                                    float scale, int is_bf16, int device,
                                    void* stream) {
  if (hkv <= 0 || h % hkv || h / hkv > kMaxGroup || lo < 0 || hi <= lo || hi > s_max)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, b, h, hkv, s_max, d, lo, hi, scale, s)
                : launch<float>(q, k, v, out, b, h, hkv, s_max, d, lo, hi, scale, s);
  return static_cast<int>(err);
}
