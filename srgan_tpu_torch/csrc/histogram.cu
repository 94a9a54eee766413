// Gaussian soft histogram of the style means, forward and backward: CUDA C++
// for Hopper (sm_90a).
//
// Forward: replaces the TPU kernel srgan_tpu/ops/pallas/histogram.py::_fwd
// (kernel _fwd_kernel), behind soft_histogram_cols.  For mu (B, D) fp32,
// row-major, and bin centres c_j = vmin + delta * (j + 1/2):
//
//   H[d, j] = norm * sum_i exp(-1/2 ((mu[i, d] - c_j) / sigma)^2),
//   norm = delta / (sigma sqrt(2 pi))
//
// Backward: replaces srgan_tpu/ops/pallas/histogram.py::_bwd_rule (kernel
// _bwd_kernel).  With z = (mu[i, d] - c_j) / sigma and w = norm exp(-z^2/2):
//
//   dmu[i, d] = sum_j gH[d, j] * (-w z / sigma)
//
// Bound: neither bytes nor operations.  On the training path mu is (128, 8)
// and H (8, 50): 4 KB in, 1.6 KB out, about 51,200 exponentials; the card
// would move that in nanoseconds.  What a launch costs is its latency, a few
// microseconds, so one launch of one small grid is the design: the forward
// has one thread per (d, j) that loops over the batch, the backward one
// thread per (i, d) that loops over the bins, each in fp32 and in a fixed
// order, with no shared memory and no atomics.  The kernels allocate nothing
// and do not synchronise; they run on the stream the caller passes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
soft_histogram_fwd_kernel(const float* __restrict__ mu, float* __restrict__ h,
                          int B, int D, int bins, float vmin, float delta,
                          float sigma, float norm) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // d * bins + j
  if (k >= D * bins) return;
  const int d = k / bins;
  const int j = k - d * bins;
  const float c = vmin + delta * (static_cast<float>(j) + 0.5f);
  float acc = 0.f;
  for (int i = 0; i < B; ++i) {
    const float z = (mu[i * D + d] - c) / sigma;
    acc += expf(-0.5f * z * z);
  }
  h[k] = acc * norm;
}

__global__ void __launch_bounds__(kThreads)
soft_histogram_bwd_kernel(const float* __restrict__ mu,
                          const float* __restrict__ gh,
                          float* __restrict__ dmu, int B, int D, int bins,
                          float vmin, float delta, float sigma, float norm) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // i * D + d
  if (k >= B * D) return;
  const int d = k % D;
  const float x = mu[k];
  const float* g = gh + d * bins;
  float acc = 0.f;
  for (int j = 0; j < bins; ++j) {
    const float c = vmin + delta * (static_cast<float>(j) + 0.5f);
    const float z = (x - c) / sigma;
    const float w = expf(-0.5f * z * z) * norm;
    acc = fmaf(-w * z / sigma, g[j], acc);
  }
  dmu[k] = acc;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// C entry points, bound with ctypes.  mu, dmu: (B, D) fp32; h, gh: (D, bins)
// fp32.  Each returns its launch's cudaError_t (0 on success).
extern "C" int srgan_soft_histogram_fwd(const void* mu, void* h, int B, int D,
                                        int bins, float vmin, float delta,
                                        float sigma, float norm,
                                        void* stream) {
  if (B <= 0 || D <= 0 || bins <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  soft_histogram_fwd_kernel<<<blocks(D * bins), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<float*>(h), B, D, bins, vmin,
      delta, sigma, norm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srgan_soft_histogram_bwd(const void* mu, const void* gh,
                                        void* dmu, int B, int D, int bins,
                                        float vmin, float delta, float sigma,
                                        float norm, void* stream) {
  if (B <= 0 || D <= 0 || bins <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  soft_histogram_bwd_kernel<<<blocks(B * D), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(gh),
      static_cast<float*>(dmu), B, D, bins, vmin, delta, sigma, norm);
  return static_cast<int>(cudaGetLastError());
}
