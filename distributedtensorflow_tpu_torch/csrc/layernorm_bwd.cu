// LayerNorm backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ln_bwd_kernel`
// (distributedtensorflow_tpu/ops/layernorm.py:59, launched by
// `_fused_ln_bwd` at :138).  Same function: with the row statistics
// recomputed from the saved input x,
//   xhat = (x - mean) * rstd,  a = dy * gamma,
//   dx   = rstd * (a - mean(a) - xhat * mean(a * xhat))   (rounded to x's type)
//   dgamma = sum over rows of dy * xhat,  dbeta = sum over rows of dy   (fp32)
// All arithmetic is fp32; dy arrives bf16 or fp32 and is widened in
// registers, which gives the values of JAX's `dy.astype(float32)` (:135).
//
// What bounds it on the H100: bytes.  About 20 operations per element
// against 6-12 bytes moved, far under the card's ~295 operations per
// byte, so its floor is (N*D*(x + dy + dx) + 12*D) bytes / 3.35 TB/s.
//
// Design: one warp per row, as in layernorm_fwd.cu: each lane keeps its
// share of x and dy in registers as chunks of 8 elements (one 16-byte
// bf16 vector or two fp32 ones), so x and dy are read once and dx
// written once.  A fixed grid of at most kMaxBlocks blocks walks the
// rows; each warp sums dgamma/dbeta for its rows in registers, the warps
// of a block add theirs in warp order into shared memory, and the block
// writes one fp32 partial row to a workspace.  A second small kernel
// sums the partials of every column in block order.  No atomics: the
// sums are the same on every run.  The TPU kernel instead revisits one
// (1, D) output block across its sequential grid; blocks on a GPU run in
// no order, hence the two passes.  The wrapper (ops/layernorm.py) limits
// D to 1024 in whole chunks of 8 and allocates the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxD = 1024;
constexpr int kMaxBlocks = 256;  // must match ops/layernorm.py _BWD_MAX_BLOCKS
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  union { uint4 u; __nv_bfloat162 h[4]; } pack;
  pack.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pack.h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  union { uint4 u; __nv_bfloat162 h[4]; } pack;
#pragma unroll
  for (int i = 0; i < 4; ++i) pack.h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = pack.u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// partial: (gridDim.x, 2, d) fp32, row 0 dgamma, row 1 dbeta.
template <typename Tx, typename Tdy, int NV>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_kernel(const Tx* __restrict__ x, const float* __restrict__ gamma,
              const Tdy* __restrict__ dy, Tx* __restrict__ dx,
              float* __restrict__ partial, int n, int d, float eps) {
  __shared__ float red[2 * kMaxD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunk = d / 8;

  float dg[NV][8], db[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) dg[i][e] = db[i][e] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < n; row += gridDim.x * kWarps) {
    const size_t off = static_cast<size_t>(row) * d;
    float xv[NV][8], gv[NV][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < nchunk) {
        load8(x + off + c * 8, xv[i]);
        load8(dy + off + c * 8, gv[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += xv[i][e];
      }
    }
    const float mean = warp_sum(sum) / static_cast<float>(d);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * 32 + lane < nchunk) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xv[i][e] -= mean;
          sq += xv[i][e] * xv[i][e];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);
    // xv becomes xhat; sums of a = dy * gamma and of a * xhat
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < nchunk) {
        float g[8];
        load8(gamma + c * 8, g);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xv[i][e] *= rstd;
          const float a = gv[i][e] * g[e];
          s1 += a;
          s2 += a * xv[i][e];
          dg[i][e] += gv[i][e] * xv[i][e];
          db[i][e] += gv[i][e];
        }
      }
    }
    const float c1 = warp_sum(s1) / static_cast<float>(d);
    const float c2 = warp_sum(s2) / static_cast<float>(d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * 32 + lane;
      if (c < nchunk) {
        float g[8], o[8];
        load8(gamma + c * 8, g);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = rstd * (gv[i][e] * g[e] - c1 - xv[i][e] * c2);
        store8(dx + off + c * 8, o);
      }
    }
  }

  // the block's partial: warps add theirs in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = i * 32 + lane;
        if (c < nchunk) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int col = c * 8 + e;
            red[col] = (w ? red[col] : 0.f) + dg[i][e];
            red[d + col] = (w ? red[d + col] : 0.f) + db[i][e];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int col = threadIdx.x; col < 2 * d; col += blockDim.x) out[col] = red[col];
}

// dgamma/dbeta: every column summed over the partial rows in block order.
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ partial, int blocks,
                                     int d, float* __restrict__ dgamma,
                                     float* __restrict__ dbeta) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= 2 * d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * 2 * d + col];
  if (col < d)
    dgamma[col] = s;
  else
    dbeta[col - d] = s;
}

template <typename Tx, typename Tdy>
cudaError_t launch(const void* x, const void* gamma, const void* dy, void* dx,
                   void* partial, void* dgamma, void* dbeta, int n, int d,
                   int blocks, float eps, cudaStream_t stream) {
  const int per_lane = (d / 8 + 31) / 32;
  const Tx* xp = static_cast<const Tx*>(x);
  const float* gp = static_cast<const float*>(gamma);
  const Tdy* dyp = static_cast<const Tdy*>(dy);
  Tx* dxp = static_cast<Tx*>(dx);
  float* pp = static_cast<float*>(partial);
  const dim3 grid(blocks), block(kWarps * 32);
  if (per_lane == 1)
    ln_bwd_kernel<Tx, Tdy, 1><<<grid, block, 0, stream>>>(xp, gp, dyp, dxp, pp, n, d, eps);
  else if (per_lane == 2)
    ln_bwd_kernel<Tx, Tdy, 2><<<grid, block, 0, stream>>>(xp, gp, dyp, dxp, pp, n, d, eps);
  else if (per_lane == 3)
    ln_bwd_kernel<Tx, Tdy, 3><<<grid, block, 0, stream>>>(xp, gp, dyp, dxp, pp, n, d, eps);
  else if (per_lane == 4)
    ln_bwd_kernel<Tx, Tdy, 4><<<grid, block, 0, stream>>>(xp, gp, dyp, dxp, pp, n, d, eps);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_reduce_kernel<<<(2 * d + 255) / 256, 256, 0, stream>>>(
      pp, blocks, d, static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, d) bf16/fp32, gamma (d,) fp32, dy (n, d) bf16/fp32, all row-major;
// dx (n, d) in x's type; partial (blocks, 2, d) fp32 workspace with
// 1 <= blocks <= 256; dgamma, dbeta (d,) fp32.  Returns the CUDA error of
// the launches (0 on success).
extern "C" int dtf_layernorm_bwd(const void* x, const void* gamma, const void* dy,
                                 void* dx, void* partial, void* dgamma, void* dbeta,
                                 int n, int d, int blocks, float eps, int x_bf16,
                                 int dy_bf16, int device, void* stream) {
  if (d % 8 || d > kMaxD || blocks < 1 || blocks > kMaxBlocks) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    err = dy_bf16 ? launch<bf16, bf16>(x, gamma, dy, dx, partial, dgamma, dbeta, n, d, blocks, eps, s)
                  : launch<bf16, float>(x, gamma, dy, dx, partial, dgamma, dbeta, n, d, blocks, eps, s);
  else
    err = dy_bf16 ? launch<float, bf16>(x, gamma, dy, dx, partial, dgamma, dbeta, n, d, blocks, eps, s)
                  : launch<float, float>(x, gamma, dy, dx, partial, dgamma, dbeta, n, d, blocks, eps, s);
  return static_cast<int>(err);
}
