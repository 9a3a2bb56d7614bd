// Single-token decode attention for Hopper (sm_90a), split over the cache.
//
// Replaces the TPU kernel `_decode_attn_kernel`
// (distributedtensorflow_tpu/ops/attention.py:279, launched by
// `_pallas_decode_attention` at :389; `cached_decode_attention` calls it
// when one new token is decoded).  Same function: for every batch row b
// and query head h, one query against the contiguous (B, Hkv, S, D) cache,
//   s = scale * q . k          (fp32 accumulation)
//   w = softmax(s) in fp32 over the whole band, normalised, then rounded
//       to V's type
//   o = w . V                  (fp32 accumulation, rounded to q's type)
// over the positions [lo, hi) that the shared causal and sliding-window
// mask keeps.  The TPU kernel scores every cache position and sets the
// masked ones to -1e9, whose weight exp(-1e9 - max) is exactly 0 in fp32;
// this kernel skips them, which gives the same sums.  Under GQA query
// head h reads kv head h / group, for any group size.
//
// What bounds it on the H100: the K/V read.  It moves
// 2 * B * Hkv * (hi - lo) * D * sizeof(T) bytes and does 4 operations
// per query head per cached element, under one operation per byte at
// GPT-2 shapes, so its floor is those bytes / 3.35 TB/s (gpt_small, B=4,
// S=2048, bf16: 25 MB, about 7.5 us).
//
// Design: the band is cut into `splits` chunks of `chunk` rows (the plan
// is `decode_plan` in ops/attention.py: as many splits as keep
// B * Hkv * splits blocks within two a SM, one wave).  A block of 256
// threads owns one split of one (b, kv head) and serves the head's whole
// query group, so each K/V row is read from device memory once per group.
// Rows arrive as 16-byte vectors: D / VEC lanes share a row and a warp
// covers 32 / (D / VEC) rows per load, several loads in flight a lane.
//
// The weights are normalised by the whole band's max and sum before they
// are rounded, as the TPU kernel rounds them, so the split cannot use the
// usual rescaling of unnormalised partial outputs.  Two launches:
//  1. scores: the group's queries sit in shared memory (any group size),
//     each K row is loaded once and scored against every query head of
//     the group; the split's scores go to an fp32 scratch (B, H, hi - lo)
//     and its max m_i and sum l_i = sum exp(s - m_i) to (B, H, splits).
//  2. output: every block combines the splits' (m_i, l_i) of its heads in
//     split order into the band's max M and sum L = sum l_i exp(m_i - M)
//     (the same values in every block of the group), forms its rows'
//     weights w = round(exp(s - M) / L) and the partial w . V with fp32
//     sums, in passes of at most 8 query heads held in registers (a group
//     above 8 heads reads its split's V rows again in the next pass, from
//     the L2 cache), and writes it to (B, H, splits, D).  The last block of
//     a (b, kv head) to finish, found by a counter that the scores launch
//     clears, sums the partials in split order and writes the outputs.  No
//     atomic touches a value, so reruns are bit-identical.
// The scratch comes from PyTorch's allocator and the counters are cleared
// by a kernel on the same stream, so a CUDA graph captures the whole call
// (two kernel nodes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPass = 8;       // query heads one pass of w . V keeps in registers
constexpr int kUnrollK = 4;    // K loads in flight per lane
constexpr int kUnrollV = 2;    // V loads in flight per lane
constexpr int kSmemLimit = 232448;
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

struct DecodeArgs {
  const void* q;     // (B, 1, H, D)
  const void* k;     // (B, Hkv, s_max, D)
  const void* v;
  void* out;         // (B, 1, H, D), q's type
  float* scores;     // (B, H, hi - lo) fp32 scratch
  float2* stats;     // (B, H, splits): a split's max and sum of exp
  float* partial;    // (B, H, splits, D): a split's w . V
  int* done;         // (B, Hkv): splits finished; the scores launch zeroes it
  int h, hkv, s_max, d, lo, hi, chunk, splits;
  float scale;
};

// Lane layout of a warp over rows of D elements (see the top of the file).
struct Lanes {
  int lpr, rpw, sub, c, rstep;
  __device__ Lanes(int d, int vec) {
    const int lane = threadIdx.x & 31;
    lpr = d / vec;              // lanes per row
    rpw = 32 / lpr;             // rows per warp load
    sub = lane / lpr;           // this lane's row within the warp load
    c = lane % lpr;             // this lane's 16-byte column chunk
    rstep = kWarps * rpw;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) decode_scores_kernel(const DecodeArgs a) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float4 smem4[];
  const int g = a.h / a.hkv, n = a.hi - a.lo, d = a.d;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int r0 = split * a.chunk, rows = min(a.chunk, n - r0);
  float* qs = reinterpret_cast<float*>(smem4);  // [g][d] the group's queries
  float* sc = qs + g * d;                        // [g][chunk] scores
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Lanes L(d, V);
  const size_t row0 = static_cast<size_t>(b) * a.h + static_cast<size_t>(hk) * g;

  // the output launch's counter of finished splits starts at 0 (that
  // launch runs after this one on the stream)
  if (split == 0 && threadIdx.x == 0) a.done[b * a.hkv + hk] = 0;
  const T* qb = static_cast<const T*>(a.q) + row0 * d;
  for (int i = threadIdx.x; i < g * d; i += kThreads) qs[i] = to_float(qb[i]);
  __syncthreads();

  // Every K row once, against every query head of the group.  The loop
  // bound is uniform across the warp, so every lane reaches the shuffles;
  // lanes past the end compute on zeros and write nothing.
  const T* kb = static_cast<const T*>(a.k) +
                ((static_cast<size_t>(b) * a.hkv + hk) * a.s_max + a.lo + r0) * d + L.c * V;
  for (int base = warp * L.rpw; base < rows; base += kUnrollK * L.rstep) {
    float kr[kUnrollK][V];
#pragma unroll
    for (int u = 0; u < kUnrollK; ++u) {
      const int r = base + u * L.rstep + L.sub;
      if (r < rows) {
        load_vec(kb + static_cast<size_t>(r) * d, kr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kr[u][e] = 0.f;
      }
    }
    for (int j = 0; j < g; ++j) {
      float qv[V];
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 x = *reinterpret_cast<const float4*>(qs + j * d + L.c * V + e);
        qv[e] = x.x; qv[e + 1] = x.y; qv[e + 2] = x.z; qv[e + 3] = x.w;
      }
#pragma unroll
      for (int u = 0; u < kUnrollK; ++u) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) p += qv[e] * kr[u][e];
        for (int off = L.lpr >> 1; off; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
        const int r = base + u * L.rstep + L.sub;
        if (r < rows && L.c == 0) sc[j * a.chunk + r] = p * a.scale;
      }
    }
  }
  __syncthreads();

  // One warp per query head: the split's max and sum of exp, and its
  // scores to device memory for the output launch.
  for (int j = warp; j < g; j += kWarps) {
    const float* sj = sc + j * a.chunk;
    float m = -INFINITY;
    for (int i = lane; i < rows; i += 32) m = fmaxf(m, sj[i]);
    m = warp_max(m);
    const size_t row = row0 + j;
    float* dst = a.scores + row * n + r0;
    float l = 0.f;
    for (int i = lane; i < rows; i += 32) {
      l += expf(sj[i] - m);
      dst[i] = sj[i];
    }
    l = warp_sum(l);
    if (lane == 0) a.stats[row * a.splits + split] = make_float2(m, l);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) decode_output_kernel(const DecodeArgs a) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float4 smem4[];
  const int g = a.h / a.hkv, n = a.hi - a.lo, d = a.d, pw = min(g, kPass);
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int r0 = split * a.chunk, rows = min(a.chunk, n - r0);
  float* red = reinterpret_cast<float*>(smem4);  // [kWarps][pw][d] warps' partials
  float* ws = red + kWarps * pw * d;              // [g][chunk] weights, rounded
  float* band = ws + g * a.chunk;                 // [g][2] the band's max and sum
  int* last = reinterpret_cast<int*>(band + 2 * g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Lanes L(d, V);
  const size_t row0 = static_cast<size_t>(b) * a.h + static_cast<size_t>(hk) * g;

  // The band's max and sum of each query head from the splits' (m, l), in
  // split order (lanes stride the splits, then a fixed shuffle tree).
  for (int j = warp; j < g; j += kWarps) {
    const float2* st = a.stats + (row0 + j) * a.splits;
    float m = -INFINITY;
    for (int i = lane; i < a.splits; i += 32) m = fmaxf(m, st[i].x);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < a.splits; i += 32) l += st[i].y * expf(st[i].x - m);
    l = warp_sum(l);
    if (lane == 0) {
      band[2 * j] = m;
      band[2 * j + 1] = l;
    }
  }
  __syncthreads();
  // w = exp(s - M) / L, normalised, then rounded to V's type (the TPU
  // kernel's `.astype(v_ref.dtype)`)
  for (int t = threadIdx.x; t < g * rows; t += kThreads) {
    const int j = t / rows, r = t - j * rows;
    const float s = a.scores[(row0 + j) * n + r0 + r];
    ws[j * a.chunk + r] = round_to(expf(s - band[2 * j]) / band[2 * j + 1], static_cast<T*>(nullptr));
  }
  __syncthreads();

  // The split's partial w . V, at most kPass query heads a pass.
  const T* vb = static_cast<const T*>(a.v) +
                ((static_cast<size_t>(b) * a.hkv + hk) * a.s_max + a.lo + r0) * d + L.c * V;
  for (int j0 = 0; j0 < g; j0 += kPass) {
    const int np = min(kPass, g - j0);
    float acc[kPass][V];
#pragma unroll
    for (int j = 0; j < kPass; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[j][e] = 0.f;
    for (int base = warp * L.rpw + L.sub; base < rows; base += kUnrollV * L.rstep) {
      float vr[kUnrollV][V];
#pragma unroll
      for (int u = 0; u < kUnrollV; ++u) {
        const int r = base + u * L.rstep;
        if (r < rows) load_vec(vb + static_cast<size_t>(r) * d, vr[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnrollV; ++u) {
        const int r = base + u * L.rstep;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < kPass; ++j) {
          if (j < np) {
            const float w = ws[(j0 + j) * a.chunk + r];
#pragma unroll
            for (int e = 0; e < V; ++e) acc[j][e] += w * vr[u][e];
          }
        }
      }
    }
    // Sum the warp's row slots (lanes lpr apart hold the same columns) ...
#pragma unroll
    for (int j = 0; j < kPass; ++j) {
      if (j < np) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          for (int off = L.lpr; off < 32; off <<= 1)
            acc[j][e] += __shfl_xor_sync(kFull, acc[j][e], off);
        if (L.sub == 0) {
#pragma unroll
          for (int e = 0; e < V; ++e) red[(warp * pw + j) * d + L.c * V + e] = acc[j][e];
        }
      }
    }
    __syncthreads();
    // ... then the warps, in order, into the split's partial
    for (int t = threadIdx.x; t < np * d; t += kThreads) {
      const int j = t / d, col = t - j * d;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[(w * pw + j) * d + col];
      a.partial[((row0 + j0 + j) * a.splits + split) * d + col] = s;
    }
    __syncthreads();  // red is rewritten by the next pass
  }

  // The last block of this (b, kv head) to finish sums the partials in
  // split order (threadFenceReduction: every thread's stores, a fence,
  // then one counter add).
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(a.done + b * a.hkv + hk, 1) == a.splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  T* ob = static_cast<T*>(a.out) + row0 * d;
  for (int t = threadIdx.x; t < g * d; t += kThreads) {
    const int j = t / d, col = t - j * d;
    const float* p = a.partial + (row0 + j) * a.splits * d + col;
    float s = 0.f;
    for (int i = 0; i < a.splits; ++i) s += __ldcg(p + static_cast<size_t>(i) * d);
    store(ob + t, s);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch(const DecodeArgs& a, int b, cudaStream_t stream) {
  const int g = a.h / a.hkv, pw = g < kPass ? g : kPass;
  const size_t smem1 = static_cast<size_t>(g) * (a.d + a.chunk) * sizeof(float);
  const size_t smem2 =
      (static_cast<size_t>(g) * a.chunk + static_cast<size_t>(kWarps) * pw * a.d + 2 * g + 1) *
      sizeof(float);
  if (smem1 > kSmemLimit || smem2 > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(decode_scores_kernel<T>, smem1);
  if (err != cudaSuccess) return err;
  err = allow_smem(decode_output_kernel<T>, smem2);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.splits, a.hkv, b);
  decode_scores_kernel<T><<<grid, kThreads, smem1, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_output_kernel<T><<<grid, kThreads, smem2, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, out (B, 1, H, D); k, v (B, Hkv, s_max, D); all bf16 or all fp32,
// contiguous.  Attends positions [lo, hi) of the cache, cut into `splits`
// chunks of `chunk` rows (the last may be shorter).  Scratch: scores
// B * H * (hi - lo) floats, stats B * H * splits float pairs (8-byte
// aligned), partial B * H * splits * D floats, done B * Hkv ints, none
// needing any content.  Returns the CUDA error of the launches (0 on
// success).
extern "C" int dtf_decode_attention(const void* q, const void* k, const void* v, void* out,
                                    void* scores, void* stats, void* partial, void* done, int b,
                                    int h, int hkv, int s_max, int d, int lo, int hi, int chunk,
                                    int splits, float scale, int is_bf16, int device,
                                    void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  if (b <= 0 || hkv <= 0 || h % hkv || lo < 0 || hi <= lo || hi > s_max || chunk <= 0 ||
      splits != (hi - lo + chunk - 1) / chunk || d <= 0 || d % vec || 32 % (d / vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const DecodeArgs a{q, k, v, out, static_cast<float*>(scores), static_cast<float2*>(stats),
                     static_cast<float*>(partial), static_cast<int*>(done), h, hkv, s_max, d,
                     lo, hi, chunk, splits, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch<__nv_bfloat16>(a, b, s) : launch<float>(a, b, s);
  return static_cast<int>(err);
}
