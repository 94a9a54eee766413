// Conditional instance norm, forward: CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel srgan_tpu/ops/pallas/norm.py::_fwd_kernel (reached
// through _fused_fwd, behind fused_cbinorm and fused_instance_norm).  For
// each (sample b, channel c) plane of x, over its H*W elements:
//
//   mu   = E[x]                      (fp32, one pass: sum and sum of squares)
//   rstd = rsqrt(max(E[x^2] - mu^2, 0) + eps)
//   y    = relu?(((x - mu) * rstd + t[b, c]) * g[c] + b[c])
//
// applied as y = x * scale + shift with scale = rstd * g[c] and
// shift = (t[b, c] - mu * rstd) * g[c] + b[c], as the TPU kernel does.
// mu and rstd are written as (B, C) fp32 for the backward of a later slice.
//
// Bound: bytes.  The least traffic is one read of x and one write of y; the
// arithmetic is a handful of flops per element, far below the card's ratio.
//
// Design: x is contiguous NCHW, so a plane is H*W contiguous elements.  One
// block of 256 threads per plane.  Pass 1 reads the plane with coalesced
// strided loads and reduces sum and sum of squares in fp32, first with warp
// shuffles, then across the 8 warps in shared memory.  Pass 2 reads the plane
// again (for planes up to 64 KB it is likely still in L2) and writes y in x's
// dtype (float32 or bfloat16).  The kernel allocates nothing and does not
// synchronise; it runs on the stream the caller passes.
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
