// The fused diversification loss: CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel srgan_tpu/ops/pallas/diversification.py::_fwd
// (kernel _fused_kernel), behind fused_diversification.  From the style
// means mu (B, D) fp32 and the histogram target (bins,) fp32 it writes the
// three raw losses of the proposed stack:
//
//   out[0]  batch-KL  -1/2 sum_d (1 + log v_d - m_d^2 - v_d), with
//           v_d = var_unbiased(mu[:, d]) * n_cfg / (n_cfg - 1)  (the double
//           bias correction against the configured batch)
//   out[1]  corr      sum |clip(cov / std_j / std_i, -1, 1) - I| / (D(D-1))
//   out[2]  hist      sum_d sum_j t_j (log t_j - log p_dj), with p_d the soft
//           histogram of mu[:, d] normalised to 1, plus 1e-8
//
// Its gradient is autograd of the plain composition, as on the TPU
// (diversification.py:124-130); this file has no backward.
//
// Bound: latency.  At B = 128, D = 8 the kernel reads 4.2 KB and does about
// 60,000 flops and 51,200 exponentials; one launch of one block is the
// design.  The block copies mu into shared memory once; then, with the
// block's threads striding over the work, it computes the column means, the
// D x D covariance (two-pass, as the TPU kernel does), the D soft histograms,
// and per dimension the histogram KL; thread 0 folds the D terms and the
// covariance into the three scalars.  Every sum runs in a fixed order, so
// every run gives the same bits.  The kernel allocates nothing and does not
// synchronise; it runs on the stream the caller passes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
diversification_fwd_kernel(const float* __restrict__ mu,
                           const float* __restrict__ target,
                           float* __restrict__ out, int B, int D, int bins,
                           float n_cfg, float vmin, float delta, float sigma,
                           float norm) {
  extern __shared__ float sm[];
  float* smu = sm;                // B * D
  float* mean = smu + B * D;      // D
  float* cov = mean + D;          // D * D
  float* h = cov + D * D;         // D * bins
  float* kl = h + D * bins;       // D
  const int tid = threadIdx.x;

  for (int k = tid; k < B * D; k += kThreads) smu[k] = mu[k];
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float s = 0.f;
    for (int i = 0; i < B; ++i) s += smu[i * D + d];
    mean[d] = s / static_cast<float>(B);
  }
  __syncthreads();
  const float inv_bm1 = 1.f / static_cast<float>(B - 1);
  for (int k = tid; k < D * D; k += kThreads) {
    const int d1 = k / D;
    const int d2 = k - d1 * D;
    float s = 0.f;
    for (int i = 0; i < B; ++i) {
      s = fmaf(smu[i * D + d1] - mean[d1], smu[i * D + d2] - mean[d2], s);
    }
    cov[k] = s * inv_bm1;
  }
  for (int k = tid; k < D * bins; k += kThreads) {
    const int d = k / bins;
    const float c = vmin + delta * (static_cast<float>(k - d * bins) + 0.5f);
    float acc = 0.f;
    for (int i = 0; i < B; ++i) {
      const float z = (smu[i * D + d] - c) / sigma;
      acc += expf(-0.5f * z * z);
    }
    h[k] = acc * norm;
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    const float* hd = h + d * bins;
    float tot = 0.f;
    for (int j = 0; j < bins; ++j) tot += hd[j];
    float s = 0.f;
    for (int j = 0; j < bins; ++j) {
      const float p = hd[j] / tot + 1e-8f;
      s += target[j] * (logf(target[j]) - logf(p));
    }
    kl[d] = s;
  }
  __syncthreads();
  if (tid == 0) {
    const float corr_n = n_cfg / (n_cfg - 1.f);
    float bkl = 0.f, hist = 0.f, corr = 0.f;
    for (int d = 0; d < D; ++d) {
      const float v = cov[d * D + d] * corr_n;
      bkl += 1.f + logf(v) - mean[d] * mean[d] - v;
      hist += kl[d];
    }
    for (int d1 = 0; d1 < D; ++d1) {
      const float s1 = sqrtf(cov[d1 * D + d1]);
      for (int d2 = 0; d2 < D; ++d2) {
        const float s2 = sqrtf(cov[d2 * D + d2]);
        float r = cov[d1 * D + d2] / s2 / s1;
        r = fminf(fmaxf(r, -1.f), 1.f);
        corr += fabsf(r - (d1 == d2 ? 1.f : 0.f));
      }
    }
    out[0] = -0.5f * bkl;
    out[1] = corr / static_cast<float>(D * (D - 1));
    out[2] = hist;
  }
}

}  // namespace

// C entry point, bound with ctypes.  mu: (B, D) fp32; target: (bins,) fp32;
// out: (3,) fp32.  smem_bytes: 4 * (B*D + D + D*D + D*bins + D), at most
// 48 KB (the wrapper checks).  Returns the launch's cudaError_t.
extern "C" int srgan_diversification_fwd(const void* mu, const void* target,
                                         void* out, int B, int D, int bins,
                                         float n_cfg, float vmin, float delta,
                                         float sigma, float norm,
                                         int smem_bytes, void* stream) {
  if (B < 2 || D < 2 || bins <= 0 || smem_bytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  diversification_fwd_kernel<<<1, kThreads, smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(target),
      static_cast<float*>(out), B, D, bins, n_cfg, vmin, delta, sigma, norm);
  return static_cast<int>(cudaGetLastError());
}
