// Gaussian soft histogram of the style means, forward and backward: CUDA C++
// for Hopper (sm_90a).
//
// Forward, srgan_soft_histogram_fwd: replaces the TPU kernel
// srgan_tpu/ops/pallas/histogram.py::_fwd (kernel _fwd_kernel), behind
// soft_histogram_cols.  For mu (B, D) fp32, row-major, and bin centres
// c_j = vmin + delta * (j + 1/2):
//
//   H[d, j] = norm * sum_i exp(-1/2 ((mu[i, d] - c_j) / sigma)^2),
//   norm = delta / (sigma sqrt(2 pi))
//
// Backward, srgan_soft_histogram_bwd: replaces
// srgan_tpu/ops/pallas/histogram.py::_bwd_rule (kernel _bwd_kernel).  With
// z = (mu[i, d] - c_j) / sigma and w = norm exp(-z^2 / 2):
//
//   dmu[i, d] = sum_j gH[d, j] * (-w z / sigma)
//
// Bound: launch latency, not bytes or operations.  On the training path mu
// is (128, 8) and H (8, 50): 4 KB in, 1.6 KB out, 51,200 exponentials each
// way, which the card's memory and fp32 units would get through in a few
// nanoseconds; an empty launch costs about 2 us.  So the design spreads the
// work over as many warps as there are outputs, so that each warp's chain
// of dependent loads, exponentials and adds is a few terms long, and keeps
// the rest of the kernel to one staging step and one shuffle tree:
//
//   - forward: a warp per output (d, j).  A block of 8 warps takes one
//     column d and 8 bins; it stages the column in shared memory in chunks
//     of 2,048 samples (any B), and its lanes stride the batch (i = lane,
//     lane + 32, ...), 4 terms a lane at B = 128.  At (128, 8, 50) that is
//     56 blocks and 400 warps, where a thread per output ran a 128-long
//     serial loop on 4 blocks.
//   - backward: a warp per output (i, d).  A block of 8 warps takes one
//     column d and 8 samples; it stages row d of gH in shared memory in
//     chunks of 2,048 bins (any bins), and its lanes stride the bins, 2
//     terms a lane at 50 bins.  At (128, 8, 50) that is 128 blocks and
//     1,024 warps, where a thread per output ran a 50-long loop on 8 blocks.
//
// Each lane adds its terms in a fixed order (ascending index), and a fixed
// __shfl_xor_sync butterfly adds the lanes; lane 0 writes.  No atomics: two
// calls on the same input give the same bits.  1 / sigma is computed once
// and multiplied in place of each divide (a relative change of about one
// fp32 ulp in z); expf stays, not __expf.  The kernels allocate nothing, do
// not synchronise and run on the stream the caller passes.  The entry points
// take any B, D, bins >= 1 with B * D and D * bins below 2^31, refuse the
// rest with cudaErrorInvalidValue, and return cudaGetLastError() after the
// launch.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // outputs per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 2048;  // floats staged in shared memory per step

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Block b: column d = b / bin_groups, bins (b % bin_groups) * kWarps + warp.
__global__ void __launch_bounds__(kThreads)
soft_histogram_fwd_kernel(const float* __restrict__ mu, float* __restrict__ h,
                          int B, int D, int bins, int bin_groups, float vmin,
                          float delta, float inv_sigma, float norm) {
  __shared__ float col[kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x / bin_groups;
  const long long j =
      static_cast<long long>(blockIdx.x - d * bin_groups) * kWarps + warp;
  const bool active = j < bins;  // the same for the whole warp
  const float c = vmin + delta * (static_cast<float>(j) + 0.5f);
  float acc = 0.f;
  for (long long base = 0; base < B; base += kChunk) {
    const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                       B - base));
    __syncthreads();  // every warp is done with the previous chunk
    for (int t = threadIdx.x; t < n; t += kThreads) {
      col[t] = mu[(base + t) * D + d];
    }
    __syncthreads();
    if (active) {
      for (int t = lane; t < n; t += 32) {
        const float z = (col[t] - c) * inv_sigma;
        acc += expf(-0.5f * z * z);
      }
    }
  }
  if (!active) return;
  acc = warp_sum(acc);
  if (lane == 0) h[static_cast<long long>(d) * bins + j] = acc * norm;
}

// Block b: column d = b / row_groups, sample (b % row_groups) * kWarps + warp.
__global__ void __launch_bounds__(kThreads)
soft_histogram_bwd_kernel(const float* __restrict__ mu,
                          const float* __restrict__ gh,
                          float* __restrict__ dmu, int B, int D, int bins,
                          int row_groups, float vmin, float delta,
                          float inv_sigma, float norm) {
  __shared__ float g[kChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = blockIdx.x / row_groups;
  const long long i =
      static_cast<long long>(blockIdx.x - d * row_groups) * kWarps + warp;
  const bool active = i < B;  // the same for the whole warp
  const long long k = i * D + d;
  const float x = active ? mu[k] : 0.f;
  const float* row = gh + static_cast<long long>(d) * bins;
  float acc = 0.f;
  for (long long base = 0; base < bins; base += kChunk) {
    const int n = static_cast<int>(min(static_cast<long long>(kChunk),
                                       bins - base));
    __syncthreads();  // every warp is done with the previous chunk
    for (int t = threadIdx.x; t < n; t += kThreads) g[t] = row[base + t];
    __syncthreads();
    if (active) {
      for (int t = lane; t < n; t += 32) {
        const float c = vmin + delta * (static_cast<float>(base + t) + 0.5f);
        const float z = (x - c) * inv_sigma;
        const float w = expf(-0.5f * z * z) * norm;
        acc = fmaf(-w * z * inv_sigma, g[t], acc);
      }
    }
  }
  if (!active) return;
  acc = warp_sum(acc);
  if (lane == 0) dmu[k] = acc;
}

// Blocks for D columns x ceil(n / kWarps) groups of outputs, or 0 if a size
// is out of the kernels' range: B * D and D * bins must index as an int,
// and then the block count is an int too.
int grid(int B, int D, int bins, int n) {
  if (B <= 0 || D <= 0 || bins <= 0) return 0;
  if (static_cast<long long>(B) * D > INT_MAX ||
      static_cast<long long>(D) * bins > INT_MAX) {
    return 0;
  }
  return D * ((n - 1) / kWarps + 1);
}

}  // namespace

// C entry points, bound with ctypes.  mu, dmu: (B, D) fp32; h, gh: (D, bins)
// fp32.  Each returns its launch's cudaError_t (0 on success).
extern "C" int srgan_soft_histogram_fwd(const void* mu, void* h, int B, int D,
                                        int bins, float vmin, float delta,
                                        float sigma, float norm,
                                        void* stream) {
  const int blocks = grid(B, D, bins, bins);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  soft_histogram_fwd_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<float*>(h), B, D, bins,
      blocks / D, vmin, delta, 1.0f / sigma, norm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srgan_soft_histogram_bwd(const void* mu, const void* gh,
                                        void* dmu, int B, int D, int bins,
                                        float vmin, float delta, float sigma,
                                        float norm, void* stream) {
  const int blocks = grid(B, D, bins, B);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  soft_histogram_bwd_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(gh),
      static_cast<float*>(dmu), B, D, bins, blocks / D, vmin, delta,
      1.0f / sigma, norm);
  return static_cast<int>(cudaGetLastError());
}
