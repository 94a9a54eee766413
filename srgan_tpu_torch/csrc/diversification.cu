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
// Bound: latency.  At B = 128, D = 8, 50 bins the kernel reads 4.2 KB and
// does about 60,000 flops and 51,200 exponentials, which the card's fp32
// units would get through in nanoseconds; an empty launch costs about 2 us.
// So the design keeps every serial chain a few terms long and spreads the
// work over one thread-block cluster of K <= 8 blocks of 32 warps (K from
// ops/diversification.py::plan, checked again here), a warp per work item,
// its lanes striding the batch of mu, which is read in place (column d at
// mu + d, its elements D apart) through L1 and L2:
//
//   - phase 1, block r: for each column d = r, r + K, ... it owns, d's
//     moments (the mean, then, two-pass as the TPU kernel, the unbiased
//     variance), its batch-KL term and the diagonal's corr term, and its
//     soft histogram, kBinsPerItem bins an item, into d's row of the
//     caller's workspace (D x bins); and the unordered pairs u = r, r + K,
//     ... of distinct columns, each computing both columns' moments and
//     their covariance in two passes and adding the two mirrored
//     |clip(cov / sd2 / sd1)| terms, so no D x D matrix is stored;
//   - phase 2, after a block barrier: per owned column, the row's total and
//     its KL against the target;
//   - fold: warp 0 adds the block's 32 warps with a shuffle tree; every
//     block writes its totals into rank 0's shared memory over distributed
//     shared memory, one cluster.sync() publishes them, and rank 0 adds
//     them, a rank a lane, with a shuffle tree.  A cluster barrier arrived
//     at the start and waited on before those writes makes sure every block
//     runs, at no stall.
//
// Sums run in a fixed order only (each lane in ascending index, then a
// fixed __shfl_xor_sync butterfly, then the warps, then the ranks), with no
// atomics: two calls give the same bits.  Shared memory is 0.5 KB, whatever
// B, D and bins: nothing of the caller's sizes is staged on chip.
// 1 / sigma is computed once and multiplied in place of each divide; expf,
// logf and sqrtf stay (no fast math).  The kernel does not synchronise the
// device and runs on the stream the caller passes.

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 32;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kBinsPerItem = 4;  // histogram values per warp item
static_assert(kWarps <= 32, "one warp's lanes add the block's warps");

struct Args {
  const float* mu;
  const float* target;
  float* out;
  float* rows;  // the workspace: D histogram rows of bins floats
  int B, D, bins, K;
  float n_cfg, vmin, delta, inv_sigma, norm;
};

// The two halves of a cluster barrier, split so that the wait, long after
// the arrive, does not stall: once it returns every block of the cluster
// has started, and its shared memory may be written.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// How many of n items, handed out in turn over K blocks, block r takes.
__device__ __forceinline__ int share(int n, int r, int K) {
  return n > r ? (n - 1 - r) / K + 1 : 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Column item d: d's batch-KL term and the diagonal's corr term.  Every
// lane ends with the same values.
__device__ __forceinline__ void column_item(const Args& a, int d, int lane,
                                            float& bkl, float& corr) {
  const float* x = a.mu + d;
  const int B = a.B, D = a.D;
  float s = 0.f;
  for (int i = lane; i < B; i += 32) s += x[i * D];
  const float m = warp_sum(s) / static_cast<float>(B);
  float v = 0.f;
  for (int i = lane; i < B; i += 32) {
    const float y = x[i * D] - m;
    v = fmaf(y, y, v);
  }
  v = warp_sum(v) / static_cast<float>(B - 1);
  const float sd = sqrtf(v);
  corr += fabsf(fminf(fmaxf(v / sd / sd, -1.f), 1.f) - 1.f);
  const float vc = v * (a.n_cfg / (a.n_cfg - 1.f));
  bkl += 1.f + logf(vc) - m * m - vc;
}

// Unordered pair u of the D (D - 1) / 2 pairs of distinct columns:
// (d, d + s mod D) for s = 1 + u / D, d = u mod D.  The shifts s below D / 2
// take every d, the shift D / 2 (D even) only d < D / 2, which the count
// of pairs cuts off; so every pair comes once.
__device__ __forceinline__ void pair_of(int u, int D, int& d1, int& d2) {
  const int s = 1 + u / D;
  d1 = u - (s - 1) * D;
  d2 = d1 + s < D ? d1 + s : d1 + s - D;
}

// Pair item (d1, d2): both columns' means, then (two-pass) their variances
// and covariance; adds the corr terms of entries (d1, d2) and (d2, d1).
__device__ __forceinline__ void pair_item(const Args& a, int d1, int d2,
                                          int lane, float& corr) {
  const float* x1 = a.mu + d1;
  const float* x2 = a.mu + d2;
  const int B = a.B, D = a.D;
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < B; i += 32) {
    s1 += x1[i * D];
    s2 += x2[i * D];
  }
  const float m1 = warp_sum(s1) / static_cast<float>(B);
  const float m2 = warp_sum(s2) / static_cast<float>(B);
  float v1 = 0.f, v2 = 0.f, c = 0.f;
  for (int i = lane; i < B; i += 32) {
    const float y1 = x1[i * D] - m1;
    const float y2 = x2[i * D] - m2;
    v1 = fmaf(y1, y1, v1);
    v2 = fmaf(y2, y2, v2);
    c = fmaf(y1, y2, c);
  }
  const float n1 = static_cast<float>(B - 1);
  const float sd1 = sqrtf(warp_sum(v1) / n1);
  const float sd2 = sqrtf(warp_sum(v2) / n1);
  c = warp_sum(c) / n1;
  corr += fabsf(fminf(fmaxf(c / sd2 / sd1, -1.f), 1.f)) +
          fabsf(fminf(fmaxf(c / sd1 / sd2, -1.f), 1.f));
}

// Histogram item (d, j0): H[d, j] for the kBinsPerItem bins j = j0,
// j0 + 1, ... below bins into row[j] (lane 0).  Each lane loads an element
// once for all of them.
__device__ __forceinline__ void hist_item(const Args& a, int d, int j0,
                                          int lane, float* row) {
  const float* x = a.mu + d;
  float c[kBinsPerItem], acc[kBinsPerItem];
#pragma unroll
  for (int g = 0; g < kBinsPerItem; ++g) {
    c[g] = a.vmin + a.delta * (static_cast<float>(j0 + g) + 0.5f);
    acc[g] = 0.f;
  }
  for (int i = lane; i < a.B; i += 32) {
    const float xi = x[i * a.D];
#pragma unroll
    for (int g = 0; g < kBinsPerItem; ++g) {
      const float z = (xi - c[g]) * a.inv_sigma;
      acc[g] += expf(-0.5f * z * z);
    }
  }
#pragma unroll
  for (int g = 0; g < kBinsPerItem; ++g) {
    acc[g] = warp_sum(acc[g]);
    if (lane == 0 && j0 + g < a.bins) row[j0 + g] = acc[g] * a.norm;
  }
}

// KL(target || p) of one histogram row, p = row / sum(row) + 1e-8.
__device__ __forceinline__ float kl_row(const Args& a, const float* row,
                                        int lane) {
  float tot = 0.f;
  for (int j = lane; j < a.bins; j += 32) tot += row[j];
  const float inv_tot = 1.f / warp_sum(tot);
  float s = 0.f;
  for (int j = lane; j < a.bins; j += 32) {
    const float t = __ldg(a.target + j);
    s += t * (logf(t) - logf(row[j] * inv_tot + 1e-8f));
  }
  return warp_sum(s);
}

// Grid: one cluster of K blocks.
__global__ void __launch_bounds__(kThreads, 1)
diversification_fwd_kernel(const Args a) {
  __shared__ float red[3][kWarps];
  __shared__ float blk[kMaxCluster][3];  // rank 0's: the blocks' totals
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = blockIdx.x;
  const int K = a.K, D = a.D, bins = a.bins;
  cluster_arrive();
  // the row of this block's lc-th column rank + lc * K
  auto row = [&](int lc) { return a.rows + (rank + lc * K) * bins; };

  // Phase 1: this block's columns, then their histograms in groups of
  // kBinsPerItem bins, then its pairs; items go to the warps in turn.
  float bkl = 0.f, corr = 0.f, hist = 0.f;
  const int ncols = share(D, rank, K);
  const int groups = (bins - 1) / kBinsPerItem + 1;
  const int nhist = ncols * groups;
  const int npairs = share(D * (D - 1) / 2, rank, K);
  for (int v = warp; v < ncols + nhist + npairs; v += kWarps) {
    if (v < ncols) {
      column_item(a, rank + v * K, lane, bkl, corr);
    } else if (v < ncols + nhist) {
      const int k = v - ncols;
      const int lc = k / groups;
      hist_item(a, rank + lc * K, (k - lc * groups) * kBinsPerItem, lane,
                row(lc));
    } else {
      int d1, d2;
      pair_of(rank + (v - ncols - nhist) * K, D, d1, d2);
      pair_item(a, d1, d2, lane, corr);
    }
  }
  __syncthreads();  // the block's rows, written to global memory, complete

  // Phase 2: the KL of each of this block's histogram rows.
  for (int lc = warp; lc < ncols; lc += kWarps) {
    hist += kl_row(a, row(lc), lane);
  }

  // Fold: the block's warps, then the cluster's blocks in rank order.
  if (lane == 0) {
    red[0][warp] = bkl;
    red[1][warp] = corr;
    red[2][warp] = hist;
  }
  __syncthreads();
  float tot[3] = {0.f, 0.f, 0.f};
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      tot[q] = warp_sum(lane < kWarps ? red[q][lane] : 0.f);
    }
  }
  // every block of the cluster runs (the arrive at the start), so thread 0
  // puts the block's totals into rank 0's blk; cluster.sync() makes them
  // visible there, and rank 0 adds them, one rank a lane
  cluster_wait();
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    float* dst = cluster.map_shared_rank(&blk[0][0], 0) + 3 * rank;
#pragma unroll
    for (int q = 0; q < 3; ++q) dst[q] = tot[q];
  }
  cluster.sync();
  if (rank == 0 && warp == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      tot[q] = warp_sum(lane < K ? blk[lane][q] : 0.f);
    }
    if (lane == 0) {
      a.out[0] = -0.5f * tot[0];
      a.out[1] =
          tot[1] / (static_cast<float>(D) * static_cast<float>(D - 1));
      a.out[2] = tot[2];
    }
  }
}

// Whether the kernel takes (B, D, bins) with a cluster of K blocks: B, D
// >= 2, bins >= 1, B * D, D * D and D * bins below 2^31 (every index an
// int), and 1 <= K <= min(8, D).
bool plan_ok(int B, int D, int bins, int K) {
  if (B < 2 || D < 2 || bins < 1) return false;
  if (static_cast<long long>(B) * D > INT_MAX ||
      static_cast<long long>(D) * D > INT_MAX ||
      static_cast<long long>(D) * bins > INT_MAX) {
    return false;
  }
  return K >= 1 && K <= kMaxCluster && K <= D;
}

}  // namespace

// C entry point, bound with ctypes.  mu: (B, D) fp32; target: (bins,) fp32;
// out: (3,) fp32; rows: (D, bins) fp32 of scratch; K: the cluster's blocks.
// Returns cudaErrorInvalidValue for a size or plan the kernel does not take,
// else the launch's cudaError_t.
extern "C" int srgan_diversification_fwd(const void* mu, const void* target,
                                         void* out, void* rows, int B, int D,
                                         int bins, int K, float n_cfg,
                                         float vmin, float delta, float sigma,
                                         float norm, void* stream) {
  if (!mu || !target || !out || !rows || !plan_ok(B, D, bins, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(mu),
               static_cast<const float*>(target),
               static_cast<float*>(out),
               static_cast<float*>(rows),
               B, D, bins, K, n_cfg, vmin, delta, 1.0f / sigma, norm};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(K), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, diversification_fwd_kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
