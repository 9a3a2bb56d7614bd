// LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ln_fwd_kernel`
// (distributedtensorflow_tpu/ops/layernorm.py:48, launched by
// `_fused_ln_fwd` at :117).  Same function: over the last axis,
//   y = ((x - mean) * rsqrt(var + eps)) * gamma + beta
// with the statistics and the normalisation in fp32 whatever the input
// type, and one rounding to the output type.  Inputs bf16 or fp32,
// outputs bf16 or fp32, gamma and beta fp32.
//
// What bounds it on the H100: bytes.  It does about 8 operations per
// element against 2-6 bytes moved, far under the card's ~295 operations
// per byte, so its floor is (N*D*(in + out) + 8*D) bytes / 3.35 TB/s.  On
// the serving path it runs on `max_slots` rows of 768 (25 launches per
// decode step), where launch latency is larger than that floor.
//
// Design: one warp per row, four rows per block.  Each lane loads its
// share of the row once, as 16-byte vectors, and keeps it in registers
// (NV vectors a lane); mean and centred variance are warp-shuffle sums in
// fp32; every output element is written once.  The TPU kernel holds a
// 512-row tile in VMEM per sequential grid step; here rows run in
// parallel blocks and one row fits a warp's registers, so the kernel
// needs no shared memory and no block-wide barrier.  The wrapper
// (ops/layernorm.py) limits D to 2048 and to whole 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
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

// Stores N floats (N = one input vector's elements) rounded to the output type.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 8) {
    union { uint4 u; __nv_bfloat162 h[4]; } pack;
#pragma unroll
    for (int i = 0; i < 4; ++i) pack.h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = pack.u;
  } else {
    union { uint2 u; __nv_bfloat162 h[2]; } pack;
#pragma unroll
    for (int i = 0; i < 2; ++i) pack.h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint2*>(p) = pack.u;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <typename Tin, typename Tout, int NV>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_kernel(const Tin* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, Tout* __restrict__ y, int n,
              int d, float eps) {
  constexpr int V = Vec<Tin>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warp leaves together
  const int nvec = d / V;
  const Tin* xr = x + static_cast<size_t>(row) * d;

  float v[NV][V];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < nvec) {
      load_vec(xr + c * V, v[i]);
#pragma unroll
      for (int e = 0; e < V; ++e) sum += v[i][e];
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(d);

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * 32 + lane < nvec) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[i][e] -= mean;
        sq += v[i][e] * v[i][e];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);

  Tout* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * 32 + lane;
    if (c < nvec) {
      float g[V], b[V], o[V];
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        load_vec(gamma + c * V + e, g + e);
        load_vec(beta + c * V + e, b + e);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = (v[i][e] * rstd) * g[e] + b[e];
      store_vec<V>(yr + c * V, o);
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* x, const void* gamma, const void* beta, void* y,
                   int n, int d, float eps, cudaStream_t stream) {
  const int per_lane = (d / Vec<Tin>::N + 31) / 32;
  const dim3 grid((n + kWarps - 1) / kWarps), block(kWarps * 32);
  const Tin* xp = static_cast<const Tin*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  Tout* yp = static_cast<Tout*>(y);
  if (per_lane <= 1)
    ln_fwd_kernel<Tin, Tout, 1><<<grid, block, 0, stream>>>(xp, gp, bp, yp, n, d, eps);
  else if (per_lane <= 2)
    ln_fwd_kernel<Tin, Tout, 2><<<grid, block, 0, stream>>>(xp, gp, bp, yp, n, d, eps);
  else if (per_lane <= 4)
    ln_fwd_kernel<Tin, Tout, 4><<<grid, block, 0, stream>>>(xp, gp, bp, yp, n, d, eps);
  else if (per_lane <= 8)
    ln_fwd_kernel<Tin, Tout, 8><<<grid, block, 0, stream>>>(xp, gp, bp, yp, n, d, eps);
  else if (per_lane <= 16)
    ln_fwd_kernel<Tin, Tout, 16><<<grid, block, 0, stream>>>(xp, gp, bp, yp, n, d, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, d) bf16/fp32 row-major, gamma/beta (d,) fp32, y (n, d) bf16/fp32.
// Returns the CUDA error of the launch (0 on success).
extern "C" int dtf_layernorm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, int n, int d,
                                 float eps, int in_bf16, int out_bf16,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16)
    err = out_bf16 ? launch<bf16, bf16>(x, gamma, beta, y, n, d, eps, s)
                   : launch<bf16, float>(x, gamma, beta, y, n, d, eps, s);
  else
    err = out_bf16 ? launch<float, bf16>(x, gamma, beta, y, n, d, eps, s)
                   : launch<float, float>(x, gamma, beta, y, n, d, eps, s);
  return static_cast<int>(err);
}
