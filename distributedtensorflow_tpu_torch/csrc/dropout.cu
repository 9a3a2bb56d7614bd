// Dropout with a counter-based mask, for Hopper (sm_90a).
//
// Not the port of a TPU kernel: the JAX package leaves dropout to flax's
// `nn.Dropout` (distributedtensorflow_tpu/models/bert.py:38 sets its rate;
// the TPU draws the bits with its own generator inside XLA).  The port
// needs its own because a CUDA graph replays k training steps: a mask
// drawn on the host, or from a generator seeded on the host, would be
// frozen into the graph.  Here the mask is a pure function of a seed that
// the kernel reads from device memory, of the site (which dropout call of
// the forward, a constant of the graph) and of the element's flat index:
//   words = Philox4x32-10(counter = (i / 4 lo, i / 4 hi, site, 0),
//                         key = (seed lo, seed hi))
//   keep  = (words[i % 4] >> 8) >= threshold      (24 random bits)
//   out   = keep ? float(x) / keep_prob : 0        (one rounding to T)
// so the host writes the next steps' seeds into a buffer before a replay
// and the graph draws fresh masks, a recomputation (block remat, the
// backward) draws the same mask, and the plain version in ops/dropout.py
// gives the same bits on the CPU.  threshold = ceil(rate * 2^24).
//
// What bounds it on the H100: bytes.  Ten Philox rounds for 4 elements
// are ~120 integer operations against 8-16 bytes moved (bf16 or fp32 in
// and out): the card's integer rate is far above that, so the floor is
// n * (in + out) bytes / 3.35 TB/s.  Design: one thread per 4 elements
// (one Philox call), no shared memory; the backward is the same kernel on
// the gradient.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
               const long long* __restrict__ seed, uint32_t site,
               uint32_t threshold, float keep_prob) {
  const long long group = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long first = group * 4;
  if (first >= n) return;
  const uint64_t s = static_cast<uint64_t>(*seed);
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(group), static_cast<uint32_t>(group >> 32), site, 0u),
      make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32)));
  const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = first + j;
    if (i < n)
      out[i] = (words[j] >> 8) >= threshold ? from_float<T>(to_float(x[i]) / keep_prob)
                                            : from_float<T>(0.0f);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long n, const void* seed,
                   uint32_t site, uint32_t threshold, float keep_prob,
                   cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  const long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dropout_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n,
      static_cast<const long long*>(seed), site, threshold, keep_prob);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: n contiguous elements of one type (0 fp32, 1 bf16, 2 fp16);
// seed: one int64 in device memory.  Returns the launch's CUDA error.
extern "C" int dtf_dropout(const void* x, void* out, long long n,
                           const void* seed, unsigned site,
                           unsigned threshold, float keep_prob, int dtype,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(x, out, n, seed, site, threshold, keep_prob, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, out, n, seed, site, threshold, keep_prob, s);
  else if (dtype == 2)
    err = launch<__half>(x, out, n, seed, site, threshold, keep_prob, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
