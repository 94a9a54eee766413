// Conditional instance norm, forward and backward: CUDA C++ for Hopper
// (sm_90a).
//
// Forward: replaces the TPU kernel srgan_tpu/ops/pallas/norm.py::_fwd_kernel
// (reached through _fused_fwd, behind fused_cbinorm and fused_instance_norm).
// For each (sample b, channel c) plane of x, over its H*W elements:
//
//   mu   = E[x]                      (fp32, one pass: sum and sum of squares)
//   rstd = rsqrt(max(E[x^2] - mu^2, 0) + eps)
//   y    = relu?(((x - mu) * rstd + t[b, c]) * g[c] + b[c])
//
// applied as y = x * scale + shift with scale = rstd * g[c] and
// shift = (t[b, c] - mu * rstd) * g[c] + b[c], as the TPU kernel does.
// mu and rstd are written as (B, C) fp32 for the backward.
//
// Backward: replaces srgan_tpu/ops/pallas/norm.py::_cbinorm_bwd (:139-156),
// which is plain jnp on the TPU.  With dy' = dy masked by y > 0 under ReLU
// (y recomputed exactly as the forward computed it), xhat = (x - mu) * rstd,
// S1 = sum_hw dy' and S2 = sum_hw dy' * xhat per plane:
//
//   dx    = rstd * g[c] * (dy' - S1 / HW - xhat * S2 / HW)
//   dt    = g[c] * S1                          (B, C)
//   dg[c] = sum_b (S2 + t[b, c] * S1),  db[c] = sum_b S1
//
// Bound: bytes, both ways.  The forward's least traffic is one read of x and
// one write of y; the backward's one read of x and dy and one write of dx.
// The arithmetic is a handful of flops per element, far below the card's
// ratio.
//
// Design: x is contiguous NCHW, so a plane is H*W contiguous elements.  One
// block of 256 threads per plane.  Pass 1 reads the plane with coalesced
// strided loads and reduces its sums in fp32, first with warp shuffles, then
// across the 8 warps in shared memory.  Pass 2 reads the plane again (for
// planes up to 64 KB it is likely still in L2) and writes y (or dx) in x's
// dtype (float32 or bfloat16).  The backward's dg and db are a reduction over
// the batch of the per-plane sums, which blocks cannot share without atomics;
// a second, tiny grid of the same entry point (one thread per channel, a
// loop over the batch in order) computes them, so every run gives the same
// bits.  The kernels allocate nothing and do not synchronise; they run on
// the stream the caller passes.
//
// Left for later: one block per plane under-fills the 132 SMs where planes
// are few (batch 1 at the generator's stem has 64 planes); a split of large
// planes over a cluster, vector loads and a single-read variant that keeps
// the plane in shared memory are later work.  Measured times, beside the
// bound, are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
cbinorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ t,
                   const float* __restrict__ g, const float* __restrict__ b,
                   T* __restrict__ y, float* __restrict__ mu_out,
                   float* __restrict__ rstd_out, int C, int HW, float eps) {
  __shared__ float red_s[kWarps];
  __shared__ float red_ss[kWarps];
  __shared__ float coef[2];

  const int plane = blockIdx.x;  // b * C + c
  const int c = plane % C;
  const T* xp = x + static_cast<size_t>(plane) * HW;
  T* yp = y + static_cast<size_t>(plane) * HW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < HW; i += kThreads) {
    const float v = load_f32(xp + i);
    s += v;
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  if (lane == 0) {
    red_s[warp] = s;
    red_ss[warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? red_s[lane] : 0.f;
    ss = lane < kWarps ? red_ss[lane] : 0.f;
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (lane == 0) {
      const float n = static_cast<float>(HW);
      const float mu = s / n;
      const float var = fmaxf(ss / n - mu * mu, 0.f);
      const float r = rsqrtf(var + eps);
      const float gc = g[c];
      coef[0] = r * gc;
      coef[1] = (t[plane] - mu * r) * gc + b[c];
      mu_out[plane] = mu;
      rstd_out[plane] = r;
    }
  }
  __syncthreads();

  const float scale = coef[0];
  const float shift = coef[1];
  for (int i = threadIdx.x; i < HW; i += kThreads) {
    float v = fmaf(load_f32(xp + i), scale, shift);
    if (kRelu) v = fmaxf(v, 0.f);
    store_f32(yp + i, v);
  }
}

// Sum of two values over the block; every thread gets the totals.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red_a,
                                           float* red_b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    red_a[warp] = a;
    red_b[warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    a += red_a[w];
    b += red_b[w];
  }
}

template <typename T, bool kRelu>
__global__ void __launch_bounds__(kThreads)
cbinorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const float* __restrict__ t, const float* __restrict__ g,
                   const float* __restrict__ b, const float* __restrict__ mu,
                   const float* __restrict__ rstd, T* __restrict__ dx,
                   float* __restrict__ dt, float* __restrict__ s1_out,
                   float* __restrict__ s2_out, int C, int HW) {
  __shared__ float red_a[kWarps];
  __shared__ float red_b[kWarps];

  const int plane = blockIdx.x;  // b * C + c
  const int c = plane % C;
  const size_t off = static_cast<size_t>(plane) * HW;
  const T* xp = x + off;
  const T* dyp = dy + off;
  T* dxp = dx + off;
  const float m = mu[plane];
  const float r = rstd[plane];
  const float gc = g[c];
  // the forward's y = x * scale + shift, recomputed bit for bit for the mask
  const float scale = r * gc;
  const float shift = (t[plane] - m * r) * gc + b[c];

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < HW; i += kThreads) {
    const float xv = load_f32(xp + i);
    float d = load_f32(dyp + i);
    if (kRelu && !(fmaf(xv, scale, shift) > 0.f)) d = 0.f;
    s1 += d;
    s2 = fmaf(d, (xv - m) * r, s2);
  }
  block_sum2(s1, s2, red_a, red_b);
  if (threadIdx.x == 0) {
    dt[plane] = gc * s1;
    s1_out[plane] = s1;
    s2_out[plane] = s2;
  }

  const float inv_n = 1.f / static_cast<float>(HW);
  const float k1 = s1 * inv_n;
  const float k2 = s2 * inv_n;
  for (int i = threadIdx.x; i < HW; i += kThreads) {
    const float xv = load_f32(xp + i);
    float d = load_f32(dyp + i);
    if (kRelu && !(fmaf(xv, scale, shift) > 0.f)) d = 0.f;
    const float xhat = (xv - m) * r;
    store_f32(dxp + i, scale * (d - k1 - xhat * k2));
  }
}

// dg[c] = sum_b (S2[b, c] + t[b, c] * S1[b, c]), db[c] = sum_b S1[b, c],
// summed over b in order.
__global__ void cbinorm_bwd_param_kernel(const float* __restrict__ s1,
                                         const float* __restrict__ s2,
                                         const float* __restrict__ t,
                                         float* __restrict__ dg,
                                         float* __restrict__ db, int B,
                                         int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sg = 0.f, sb = 0.f;
  for (int i = 0; i < B; ++i) {
    const int p = i * C + c;
    sb += s1[p];
    sg += s2[p] + t[p] * s1[p];
  }
  dg[c] = sg;
  db[c] = sb;
}

template <typename T>
void launch(const void* x, const void* t, const void* g, const void* b,
            void* y, void* mu, void* rstd, int planes, int C, int HW,
            float eps, int relu, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const float* tt = static_cast<const float*>(t);
  const float* gt = static_cast<const float*>(g);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  float* mt = static_cast<float*>(mu);
  float* rt = static_cast<float*>(rstd);
  if (relu) {
    cbinorm_fwd_kernel<T, true><<<planes, kThreads, 0, stream>>>(
        xt, tt, gt, bt, yt, mt, rt, C, HW, eps);
  } else {
    cbinorm_fwd_kernel<T, false><<<planes, kThreads, 0, stream>>>(
        xt, tt, gt, bt, yt, mt, rt, C, HW, eps);
  }
}

template <typename T>
void launch_bwd(const void* x, const void* dy, const float* t, const float* g,
                const float* b, const float* mu, const float* rstd, void* dx,
                float* dt, float* sums, float* dg, float* db, int B, int C,
                int HW, int relu, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const int planes = B * C;
  float* s1 = sums;
  float* s2 = sums + planes;
  if (relu) {
    cbinorm_bwd_kernel<T, true><<<planes, kThreads, 0, stream>>>(
        xt, dyt, t, g, b, mu, rstd, dxt, dt, s1, s2, C, HW);
  } else {
    cbinorm_bwd_kernel<T, false><<<planes, kThreads, 0, stream>>>(
        xt, dyt, t, g, b, mu, rstd, dxt, dt, s1, s2, C, HW);
  }
  constexpr int kParamThreads = 128;
  cbinorm_bwd_param_kernel<<<(C + kParamThreads - 1) / kParamThreads,
                             kParamThreads, 0, stream>>>(s1, s2, t, dg, db,
                                                         B, C);
}

}  // namespace

// C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t (0 on success).
extern "C" int srgan_cbinorm_fwd(const void* x, const void* t, const void* g,
                                 const void* b, void* y, void* mu, void* rstd,
                                 int planes, int C, int HW, float eps,
                                 int relu, int dtype, void* stream) {
  if (planes <= 0 || C <= 0 || HW <= 0 || planes % C != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, t, g, b, y, mu, rstd, planes, C, HW, eps, relu, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, t, g, b, y, mu, rstd, planes, C, HW, eps, relu,
                          s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// C entry point of the backward, bound with ctypes.  x, dy, dx: (B, C, HW)
// in dtype (0 = float32, 1 = bfloat16); t, mu, rstd, dt: (B, C) fp32;
// sums: (2, B, C) fp32 scratch (S1 then S2); g, b, dg, db: (C,) fp32.
// Launches two grids on the stream; returns the cudaError_t of the launches
// (0 on success).
extern "C" int srgan_cbinorm_bwd(const void* x, const void* dy,
                                 const void* t, const void* g, const void* b,
                                 const void* mu, const void* rstd, void* dx,
                                 void* dt, void* sums, void* dg, void* db,
                                 int B, int C, int HW, int relu, int dtype,
                                 void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tf = static_cast<const float*>(t);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(mu);
  const float* rf = static_cast<const float*>(rstd);
  float* dtf = static_cast<float*>(dt);
  float* sf = static_cast<float*>(sums);
  float* dgf = static_cast<float*>(dg);
  float* dbf = static_cast<float*>(db);
  if (dtype == 0) {
    launch_bwd<float>(x, dy, tf, gf, bf, mf, rf, dx, dtf, sf, dgf, dbf, B, C,
                      HW, relu, s);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(x, dy, tf, gf, bf, mf, rf, dx, dtf, sf, dgf,
                              dbf, B, C, HW, relu, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
