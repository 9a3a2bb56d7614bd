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
// byte, so its floor is (N*D*(x + dy + dx) + 12*D) bytes / 3.35 TB/s
// (0.0225 ms at 16384 x 768 in bf16).
//
// Main pass (ln_bwd_kernel): a block of 16 warps takes groups of 16 rows,
// one row a warp; the grid is `blocks` = 2 x the SMs (ops/layernorm.py's
// bwd_blocks), and two blocks fit an SM (<= 64 registers a thread; one
// with fp32 dy at D 1024, by shared memory), so each SM holds 32 warps.  A warp issues every load of its row (x and dy,
// 16 bytes a lane a load) before it uses any, keeps them packed in
// registers and widens them where each pass needs them: the sums of x and
// of a (two warp sums at once), then of (x - mean)^2 and of a (x - mean),
// then dx, stored.  It writes its row's dy * xhat (fp32) and dy (as it
// came) to shared memory; after a block barrier each thread adds the 16
// rows of its columns in warp order to its own dgamma and dbeta sums (at
// most 2 columns a thread), so no thread holds a sum for every column.
// The sums run over the block's groups in order, and the block writes one
// fp32 partial row of 2 D values at the end.
//
// Final sum (ln_bwd_reduce_kernel): a block of 32 warps per 32 of the 2 D
// columns, lane = column; warp w adds the w-th 32nd of the partial rows
// in block order (sixteen loads in flight, then sixteen adds in order), and
// warp 0 adds the 32 warps' sums in warp order.  No atomics: every
// dgamma and dbeta is summed in one fixed order, the same on every run.
// The TPU kernel instead revisits one (1, D) output block across its
// sequential grid; blocks on a GPU run in no order, hence the two passes.
//
// The wrapper (ops/layernorm.py) limits D to 1024 in whole chunks of 8
// and allocates the (blocks, 2, D) partial workspace.  Shared memory of a
// block: gamma (4 D) and the 16 rows' dy * xhat (4 D each) and dy (2 or 4 D
// each): 75 KB at D 768 with bf16 dy.  ptxas -v: 64 registers a thread (the
// launch bound), no spill with bf16 x and dy at D 768, 36 bytes with fp32
// dy, 68 at D 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kMaxD = 1024;
constexpr int kBlocksPerSm = 2;  // must match ops/layernorm.py BWD_BLOCKS_PER_SM
constexpr int kColsPerThread = kMaxD / (kWarps * 32);
constexpr unsigned kFull = 0xffffffffu;

// 8 elements of T as they lie in memory: one 16-byte vector for bf16, two
// for fp32.
template <typename T>
struct Chunk {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Chunk<T> load_chunk(const T* p) {
  Chunk<T> c;
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T)) / 2; ++k) c.u[k] = reinterpret_cast<const uint4*>(p)[k];
  return c;
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* p, const Chunk<T>& c) {
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T)) / 2; ++k) reinterpret_cast<uint4*>(p)[k] = c.u[k];
}

__device__ __forceinline__ void widen(const Chunk<float>& c, float* o) {
  const float* f = reinterpret_cast<const float*>(c.u);
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = f[e];
}

__device__ __forceinline__ void widen(const Chunk<__nv_bfloat16>& c, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(c.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
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

// Two warp sums at once: the two shuffle chains overlap.
__device__ __forceinline__ void warp_sum2(float& x, float& y) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    x += __shfl_xor_sync(kFull, x, off);
    y += __shfl_xor_sync(kFull, y, off);
  }
}

// Dynamic shared memory of a block: gamma, then each warp's dy * xhat and
// dy rows.
template <typename Tdy>
int smem_bytes(int d) {
  return 4 * d + kWarps * d * static_cast<int>(4 + sizeof(Tdy));
}

// partial: (gridDim.x, 2, d) fp32, row 0 dgamma, row 1 dbeta.
template <typename Tx, typename Tdy, int NV>
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm)
ln_bwd_kernel(const Tx* __restrict__ x, const float* __restrict__ gamma,
              const Tdy* __restrict__ dy, Tx* __restrict__ dx,
              float* __restrict__ partial, int n, int d, float eps) {
  extern __shared__ float4 smem4[];
  float* sgamma = reinterpret_cast<float*>(smem4);
  float* sdg = sgamma + d;                                 // [warp][d]: dy * xhat
  Tdy* sdb = reinterpret_cast<Tdy*>(sdg + kWarps * d);     // [warp][d]: dy
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunk = d / 8;
  const float inv_d = 1.f / static_cast<float>(d);

  for (int c = threadIdx.x; c < d; c += blockDim.x) sgamma[c] = gamma[c];
  float acc[kColsPerThread][2];  // columns threadIdx.x + 256 j: dgamma, dbeta
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j][0] = acc[j][1] = 0.f;
  __syncthreads();

  for (int grp = blockIdx.x; grp * kWarps < n; grp += gridDim.x) {
    const int row = grp * kWarps + warp;
    float* my_dg = sdg + warp * d;
    Tdy* my_db = sdb + warp * d;
    if (row < n) {
      const size_t off = static_cast<size_t>(row) * d;
      Chunk<Tx> xr[NV];
      Chunk<Tdy> yr[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = i * 32 + lane;
        if (c < nchunk) {
          xr[i] = load_chunk(x + off + c * 8);
          yr[i] = load_chunk(dy + off + c * 8);
        }
      }
      // sums of x and of a = dy * gamma; then of (x - mean)^2 and a (x - mean)
      float sum = 0.f, sa = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = i * 32 + lane;
        if (c < nchunk) {
          float xf[8], gv[8], g[8];
          widen(xr[i], xf);
          widen(yr[i], gv);
          load8(sgamma + c * 8, g);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            sum += xf[e];
            sa += gv[e] * g[e];
          }
        }
      }
      warp_sum2(sum, sa);
      const float mean = sum * inv_d, c1 = sa * inv_d;
      float sq = 0.f, sxa = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = i * 32 + lane;
        if (c < nchunk) {
          float xf[8], gv[8], g[8];
          widen(xr[i], xf);
          widen(yr[i], gv);
          load8(sgamma + c * 8, g);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xc = xf[e] - mean;
            sq += xc * xc;
            sxa += gv[e] * g[e] * xc;
          }
        }
      }
      warp_sum2(sq, sxa);
      const float rstd = rsqrtf(sq * inv_d + eps);
      const float c2 = rstd * sxa * inv_d;  // mean(a * xhat)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = i * 32 + lane;
        if (c < nchunk) {
          float xf[8], gv[8], g[8], o[8], p[8];
          widen(xr[i], xf);
          widen(yr[i], gv);
          load8(sgamma + c * 8, g);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xh = (xf[e] - mean) * rstd;
            p[e] = gv[e] * xh;
            o[e] = rstd * (gv[e] * g[e] - c1 - xh * c2);
          }
          store8(dx + off + c * 8, o);
          store8(my_dg + c * 8, p);
          store_chunk(my_db + c * 8, yr[i]);
        }
      }
    } else {  // past the last row: nothing to add
      const float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int c = lane; c < nchunk; c += 32) {
        store8(my_dg + c * 8, z);
        store_chunk(my_db + c * 8, Chunk<Tdy>{});
      }
    }
    __syncthreads();
    // this thread's columns: the group's rows in warp order
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = threadIdx.x + j * kWarps * 32;
      if (col < d) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          acc[j][0] += sdg[w * d + col];
          acc[j][1] += to_float(sdb[w * d + col]);
        }
      }
    }
    __syncthreads();  // the rows' stage is free for the next group
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int col = threadIdx.x + j * kWarps * 32;
    if (col < d) {
      out[col] = acc[j][0];
      out[d + col] = acc[j][1];
    }
  }
}

// dgamma/dbeta: 32 columns a block; warp w sums its 32nd of the partial
// rows in block order, warp 0 the 32 warps' sums in warp order.
constexpr int kReduceWarps = 32;

__global__ void __launch_bounds__(kReduceWarps * 32)
ln_bwd_reduce_kernel(const float* __restrict__ partial, int blocks, int d,
                     float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float red[kReduceWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int per = (blocks + kReduceWarps - 1) / kReduceWarps;
  const int lo = min(warp * per, blocks), hi = min(lo + per, blocks);
  float s = 0.f;
  if (col < 2 * d) {
    const float* p = partial + col;
    const size_t ld = static_cast<size_t>(2) * d;
    int b = lo;
    for (; b + 16 <= hi; b += 16) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = p[(b + u) * ld];
#pragma unroll
      for (int u = 0; u < 16; ++u) s += v[u];
    }
    for (; b < hi; ++b) s += p[b * ld];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < 2 * d) {
    float t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kReduceWarps; ++w) t += red[w][lane];
    if (col < d)
      dgamma[col] = t;
    else
      dbeta[col - d] = t;
  }
}

template <typename Tx, typename Tdy, int NV>
cudaError_t launch_main(const void* x, const void* gamma, const void* dy, void* dx,
                        float* partial, int n, int d, int blocks, float eps,
                        cudaStream_t stream) {
  auto kernel = ln_bwd_kernel<Tx, Tdy, NV>;
  const int smem = smem_bytes<Tdy>(d);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(
      static_cast<const Tx*>(x), static_cast<const float*>(gamma),
      static_cast<const Tdy*>(dy), static_cast<Tx*>(dx), partial, n, d, eps);
  return cudaGetLastError();
}

template <typename Tx, typename Tdy>
cudaError_t launch(const void* x, const void* gamma, const void* dy, void* dx,
                   void* partial, void* dgamma, void* dbeta, int n, int d,
                   int blocks, float eps, cudaStream_t stream) {
  const int per_lane = (d / 8 + 31) / 32;
  float* pp = static_cast<float*>(partial);
  cudaError_t err;
  if (per_lane == 1)
    err = launch_main<Tx, Tdy, 1>(x, gamma, dy, dx, pp, n, d, blocks, eps, stream);
  else if (per_lane == 2)
    err = launch_main<Tx, Tdy, 2>(x, gamma, dy, dx, pp, n, d, blocks, eps, stream);
  else if (per_lane == 3)
    err = launch_main<Tx, Tdy, 3>(x, gamma, dy, dx, pp, n, d, blocks, eps, stream);
  else if (per_lane == 4)
    err = launch_main<Tx, Tdy, 4>(x, gamma, dy, dx, pp, n, d, blocks, eps, stream);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  ln_bwd_reduce_kernel<<<(2 * d + 31) / 32, kReduceWarps * 32, 0, stream>>>(
      pp, blocks, d, static_cast<float*>(dgamma), static_cast<float*>(dbeta));
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* dtf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n, d) bf16/fp32, gamma (d,) fp32, dy (n, d) bf16/fp32, all row-major
// and 16-byte aligned; dx (n, d) in x's type; partial (blocks, 2, d) fp32
// workspace, blocks >= 1; dgamma, dbeta (d,) fp32.  Returns the CUDA error
// of the launches (0 on success).
extern "C" int dtf_layernorm_bwd(const void* x, const void* gamma, const void* dy,
                                 void* dx, void* partial, void* dgamma, void* dbeta,
                                 int n, int d, int blocks, float eps, int x_bf16,
                                 int dy_bf16, int device, void* stream) {
  if (d % 8 || d > kMaxD || blocks < 1) return cudaErrorInvalidValue;
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
