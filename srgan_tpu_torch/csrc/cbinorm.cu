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
// Forward design: x is contiguous NCHW, so a plane is H*W contiguous
// elements.  One block of 256 threads per plane.  Pass 1 reads the plane
// with coalesced strided loads and reduces its sums in fp32, first with warp
// shuffles, then across the 8 warps in shared memory.  Pass 2 reads the
// plane again (from L2 where the planes in flight fit there) and writes y in
// x's dtype (float32 or bfloat16).
//
// Backward design: each plane's x and dy are read from device memory once.
// A thread loads its share of the plane into registers, masks dy, reduces
// S1 and S2, and computes dx from the same registers, so the traffic is the
// bound's.  Three tiers, chosen by the caller per plane size
// (srgan_tpu_torch/ops/norm.py::bwd_plan) and checked here:
//
//   warp  HW <= 1024: a warp per plane, 8 planes per 256-thread block, 2, 8
//         or 32 elements per lane, sums by shuffles alone.  The small planes
//         (7^2 to 32^2) no longer leave most of a block idle.
//   cta   1024 < HW <= 32768: a 256-thread block holds 4096 elements (16 a
//         thread); a plane takes ceil(HW / 4096) blocks, launched as one
//         thread-block cluster that adds its blocks' sums through distributed
//         shared memory.  A 128^2 fp32 plane is 4 blocks of 32 KB of data.
//   two-pass  larger planes: a block per plane reads x and dy twice.  No
//         path shape of the repo's presets lands here (image_size 256 would).
//
// Loads and stores are 16 bytes a thread (float4, or 8 bf16) where the
// plane's length and the tensors' base allow it; otherwise scalar, with the
// tail masked.  Sums are fp32 and fixed in order: each thread's elements in
// order, then a shuffle tree, then the warps' (and the cluster's blocks')
// totals in a fixed tree or rank order.  dg and db need a sum over the batch
// that blocks cannot share without atomics: each plane writes (S1,
// S2 + t S1) to a (2, B, C) scratch, and a second grid of the same call sums
// it over the batch, a warp per channel (lanes in order, then a shuffle
// tree).  Every run gives the same bits.  Without affine (the plain
// instance norm: no gradient for t, g or b) the call writes dx alone and
// skips dt, the scratch and the second grid.  The kernels allocate nothing
// and do not synchronise; they run on the stream the caller passes.
// Measured times, beside the bound, are in PERF.md.
//
// Channels-last (NHWC) pair, srgan_cbinorm_fwd_nhwc and _bwd_nhwc: the same two
// functions for x stored (B, HW, C), as cuDNN's NHWC convolutions leave their
// outputs; they replace no TPU kernel of their own (the TPU kernels above take
// one layout).  Bound: bytes, as above (one read of x, and of dy, one write of
// y or dx, at the card's 3.35 TB/s).  A plane's elements lie C apart, so a
// thread takes 16 bytes along C (8 bf16 or 4 fp32 channels, a "vector"), and a
// tile is one channel group of TC vectors (8 bf16 vectors make a 64-channel row
// of 128 bytes) of one sample.  The K blocks of a thread-block cluster (1 to
// 16) hold the tile's pixels in shared memory, each as boxes of up to 256
// pixels that TMA copies in (tensor maps from cuTensorMapEncodeTiled; pixels
// past HW arrive as zeros), so a sample's pixels sit in shared memory between
// the statistics and the output, not in registers, and neither the group nor
// the cluster is sized by the register file.  The grid is persistent: as many
// clusters as the device holds at once (cudaOccupancyMaxActiveClusters), each
// walking over the call's tiles.  A block is warp specialised: one producer
// warp keeps a ring of S slots loading, box by box in the order of its tiles,
// each slot refilled as soon as its box has been read (mbarriers count the
// copies in and the readers out); 8 consumer warps sum a tile's boxes as they
// arrive, exchange the sums with the cluster, compute the coefficients and
// write y or dx from the same shared memory.  The per-channel fp32 sums go
// through a shuffle tree over the warp's rows, a fixed tree over the block's 8
// warps, then the cluster's blocks in rank order: each block writes its totals
// into every block's shared memory and arrives on an mbarrier there, so the
// cluster waits for no more than the sums.  The plan (TC, rows, boxes, K, S) is
// srgan_tpu_torch/ops/norm.py::nhwc_plan's, chosen from (B, HW, C, the element
// size) and checked here; a shape whose ring does not fit a block has no NHWC
// plan, and the wrapper takes the NCHW pair for it.  The backward writes the
// same (2, B, C) scratch and runs the same ordered batch reduction for dg and
// db, so the bits repeat from run to run here too.  Both kernels take a plane's
// scale and shift from (mu, rstd) through one function with fixed roundings, so
// the backward's ReLU mask is the forward's bit for bit.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <algorithm>
#include <initializer_list>
#include <mutex>
#include <vector>

namespace cg = cooperative_groups;


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


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The tiers of the backward; srgan_tpu_torch/ops/norm.py mirrors these
// constants in bwd_plan.
constexpr int kTierWarp = 0;
constexpr int kTierCta = 1;
constexpr int kTierTwoPass = 2;
constexpr int kCtaItems = 16;                     // elements a thread, cta
constexpr int kCtaChunk = kThreads * kCtaItems;   // elements a block, cta
constexpr int kMaxCluster = 8;                    // the portable limit

template <typename T>
struct BwdArgs {
  const T* x;
  const T* dy;
  const float* t;
  const float* g;
  const float* b;
  const float* mu;
  const float* rstd;
  T* dx;
  float* dt;     // (B, C), written under affine
  float* parts;  // (2, B, C): S1, then S2 + t * S1; written under affine
  int planes;
  int C;
  int HW;
  int relu;
  int affine;
};

// VEC consecutive elements as fp32; one 16-byte access where VEC > 1.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    static_assert(VEC == 1, "fp32 vectors are 4 wide");
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an fp32; the lower address is the low
      // half of the word
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    static_assert(VEC == 1, "bf16 vectors are 8 wide");
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    static_assert(VEC == 1, "fp32 vectors are 4 wide");
    *p = v[0];
  }
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(v)));
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 8) {
    uint4 u;
    u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
    u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
    u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    static_assert(VEC == 1, "bf16 vectors are 8 wide");
    *p = __float2bfloat16(v[0]);
  }
}

struct PlaneCoef {
  float m, r, gc, tb, scale, shift;
};

// The plane's statistics and the forward's scale and shift, so that the
// ReLU mask fmaf(x, scale, shift) > 0 is the forward's bit for bit.
template <typename T>
__device__ __forceinline__ PlaneCoef plane_coef(const BwdArgs<T>& a,
                                                int plane) {
  const int c = plane % a.C;
  PlaneCoef k;
  k.m = a.mu[plane];
  k.r = a.rstd[plane];
  k.gc = a.g[c];
  k.tb = a.t[plane];
  k.scale = k.r * k.gc;
  k.shift = (k.tb - k.m * k.r) * k.gc + a.b[c];
  return k;
}

// A thread's share of n elements of a plane into registers: its vector k
// (of NV) starts at element (i + P * k) * VEC, where i is the thread's index
// among the P threads that share the elements.  Past n, x and dy read as 0,
// which adds nothing to the sums.  n is a multiple of VEC.
template <int VEC, int NV, typename T>
__device__ __forceinline__ void load_share(const T* xp, const T* dyp, int n,
                                           int i, int P, float* xs,
                                           float* ds) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e = (i + P * k) * VEC;
    if (e < n) {
      load_vec<VEC>(xp + e, xs + k * VEC);
      load_vec<VEC>(dyp + e, ds + k * VEC);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        xs[k * VEC + v] = 0.f;
        ds[k * VEC + v] = 0.f;
      }
    }
  }
}

// Masks dy in place (dy') and sums the share's S1 and S2, in element order.
template <int N>
__device__ __forceinline__ void share_sums(const PlaneCoef& k, int relu,
                                           const float* xs, float* ds,
                                           float& s1, float& s2) {
  s1 = 0.f;
  s2 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float d = ds[i];
    if (relu && !(fmaf(xs[i], k.scale, k.shift) > 0.f)) d = 0.f;
    ds[i] = d;
    s1 += d;
    s2 = fmaf(d, (xs[i] - k.m) * k.r, s2);
  }
}

// dx of the share, from the registers; k1 = S1 / HW, k2 = S2 / HW.
template <int VEC, int NV, typename T>
__device__ __forceinline__ void store_share(T* dxp, int n, int i, int P,
                                            const PlaneCoef& k, float k1,
                                            float k2, const float* xs,
                                            const float* ds) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = (i + P * j) * VEC;
    if (e < n) {
      float v[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float xhat = (xs[j * VEC + q] - k.m) * k.r;
        v[q] = k.scale * (ds[j * VEC + q] - k1 - xhat * k2);
      }
      store_vec<VEC>(dxp + e, v);
    }
  }
}

// A butterfly: every lane ends with the same bits, since each step adds
// the same two values in every lane of a pair.
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Sum of two values over the block, a fixed tree over the 8 warps; every
// thread gets the same totals.
__device__ __forceinline__ void block_sum2(float& a, float& b,
                                           float (*red)[kWarps]) {
  static_assert(kWarps == 8, "the tree below adds 8 warps");
  warp_sum2(a, b);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  const float* ra = red[0];
  const float* rb = red[1];
  a = ((ra[0] + ra[1]) + (ra[2] + ra[3])) +
      ((ra[4] + ra[5]) + (ra[6] + ra[7]));
  b = ((rb[0] + rb[1]) + (rb[2] + rb[3])) +
      ((rb[4] + rb[5]) + (rb[6] + rb[7]));
}

template <typename T>
__device__ __forceinline__ void write_plane_sums(const BwdArgs<T>& a,
                                                 int plane,
                                                 const PlaneCoef& k, float s1,
                                                 float s2) {
  a.dt[plane] = k.gc * s1;
  a.parts[plane] = s1;
  a.parts[a.planes + plane] = s2 + k.tb * s1;
}

// Tier warp: a warp per plane of HW <= 32 * ITEMS elements.  No block
// barrier, so a warp past the last plane leaves at once.
template <typename T, int VEC, int ITEMS>
__global__ void __launch_bounds__(kThreads)
cbinorm_bwd_warp_kernel(const BwdArgs<T> a) {
  static_assert(ITEMS % VEC == 0, "a lane holds whole vectors");
  constexpr int NV = ITEMS / VEC;
  const int plane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (plane >= a.planes) return;
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(plane) * a.HW;
  float xs[ITEMS], ds[ITEMS];
  load_share<VEC, NV>(a.x + off, a.dy + off, a.HW, lane, 32, xs, ds);
  const PlaneCoef k = plane_coef(a, plane);
  float s1, s2;
  share_sums<ITEMS>(k, a.relu, xs, ds, s1, s2);
  warp_sum2(s1, s2);
  if (a.affine && lane == 0) write_plane_sums(a, plane, k, s1, s2);
  const float inv_n = 1.f / static_cast<float>(a.HW);
  store_share<VEC, NV>(a.dx + off, a.HW, lane, 32, k, s1 * inv_n,
                       s2 * inv_n, xs, ds);
}

// Tier cta: block q of a plane's K holds elements [q * 4096, (q + 1) * 4096)
// in registers.  With K > 1 the K blocks are one cluster (grid = planes * K,
// cluster (K, 1, 1), so a block's rank is blockIdx.x % K), and each adds the
// blocks' sums in rank order from their shared memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
cbinorm_bwd_cta_kernel(const BwdArgs<T> a, int K) {
  static_assert(kCtaItems % VEC == 0, "a thread holds whole vectors");
  constexpr int NV = kCtaItems / VEC;
  __shared__ float red[2][kWarps];
  __shared__ float tot[2];
  const int plane = blockIdx.x / K;
  const int rank = blockIdx.x - plane * K;
  const int first = rank * kCtaChunk;
  const int n = min(a.HW - first, kCtaChunk);
  const size_t off = static_cast<size_t>(plane) * a.HW + first;
  float xs[kCtaItems], ds[kCtaItems];
  load_share<VEC, NV>(a.x + off, a.dy + off, n, threadIdx.x, kThreads, xs,
                      ds);
  const PlaneCoef k = plane_coef(a, plane);
  float s1, s2;
  share_sums<kCtaItems>(k, a.relu, xs, ds, s1, s2);
  block_sum2(s1, s2, red);
  if (K > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      tot[0] = s1;
      tot[1] = s2;
    }
    cluster.sync();
    s1 = 0.f;
    s2 = 0.f;
    for (int q = 0; q < K; ++q) {
      const float* p = cluster.map_shared_rank(tot, q);
      s1 += p[0];
      s2 += p[1];
    }
    cluster.sync();  // no block leaves while another still reads its tot
  }
  if (a.affine && rank == 0 && threadIdx.x == 0) {
    write_plane_sums(a, plane, k, s1, s2);
  }
  const float inv_n = 1.f / static_cast<float>(a.HW);
  store_share<VEC, NV>(a.dx + off, n, threadIdx.x, kThreads, k, s1 * inv_n,
                       s2 * inv_n, xs, ds);
}

// Tier two-pass: a block per plane, x and dy read twice (the second time
// from L2 where the planes in flight fit there).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cbinorm_bwd_two_pass_kernel(const BwdArgs<T> a) {
  __shared__ float red[2][kWarps];
  const int plane = blockIdx.x;
  const size_t off = static_cast<size_t>(plane) * a.HW;
  const T* xp = a.x + off;
  const T* dyp = a.dy + off;
  const PlaneCoef k = plane_coef(a, plane);
  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < a.HW; i += kThreads) {
    const float xv = load_f32(xp + i);
    float d = load_f32(dyp + i);
    if (a.relu && !(fmaf(xv, k.scale, k.shift) > 0.f)) d = 0.f;
    s1 += d;
    s2 = fmaf(d, (xv - k.m) * k.r, s2);
  }
  block_sum2(s1, s2, red);
  if (a.affine && threadIdx.x == 0) write_plane_sums(a, plane, k, s1, s2);
  const float inv_n = 1.f / static_cast<float>(a.HW);
  const float k1 = s1 * inv_n;
  const float k2 = s2 * inv_n;
  for (int i = threadIdx.x; i < a.HW; i += kThreads) {
    const float xv = load_f32(xp + i);
    float d = load_f32(dyp + i);
    if (a.relu && !(fmaf(xv, k.scale, k.shift) > 0.f)) d = 0.f;
    const float xhat = (xv - k.m) * k.r;
    store_f32(a.dx + off + i, k.scale * (d - k1 - xhat * k2));
  }
}

// dg[c] = sum_b parts[1][b][c], db[c] = sum_b parts[0][b][c]: a warp per
// channel; lane l adds b = l, l + 32, ... in order, then a shuffle tree.
// No atomics, so the bits repeat from run to run.
__global__ void __launch_bounds__(kThreads)
cbinorm_bwd_param_kernel(const float* __restrict__ parts,
                         float* __restrict__ dg, float* __restrict__ db,
                         int B, int C) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;
  const int lane = threadIdx.x & 31;
  const float* s1 = parts;
  const float* q = parts + static_cast<size_t>(B) * C;
  float sb = 0.f, sg = 0.f;
  for (int i = lane; i < B; i += 32) {
    sb += s1[i * C + c];
    sg += q[i * C + c];
  }
  warp_sum2(sb, sg);
  if (lane == 0) {
    dg[c] = sg;
    db[c] = sb;
  }
}

template <typename T, int VEC>
cudaError_t launch_cta(const BwdArgs<T>& a, int K, cudaStream_t stream) {
  if (K == 1) {
    cbinorm_bwd_cta_kernel<T, VEC><<<a.planes, kThreads, 0, stream>>>(a, 1);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.planes) * K, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cbinorm_bwd_cta_kernel<T, VEC>, a, K);
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs<T>& a, float* dg, float* db, int B,
                       int tier, int items, int vec, int K,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool v = vec > 1;
  cudaError_t err = cudaSuccess;
  if (tier == kTierWarp) {
    const int grid = (a.planes + kWarps - 1) / kWarps;
    if (items == 2) {
      cbinorm_bwd_warp_kernel<T, 1, 2><<<grid, kThreads, 0, stream>>>(a);
    } else if (items == 8 && v) {
      cbinorm_bwd_warp_kernel<T, kVec, 8><<<grid, kThreads, 0, stream>>>(a);
    } else if (items == 8) {
      cbinorm_bwd_warp_kernel<T, 1, 8><<<grid, kThreads, 0, stream>>>(a);
    } else if (v) {
      cbinorm_bwd_warp_kernel<T, kVec, 32><<<grid, kThreads, 0, stream>>>(a);
    } else {
      cbinorm_bwd_warp_kernel<T, 1, 32><<<grid, kThreads, 0, stream>>>(a);
    }
  } else if (tier == kTierCta) {
    err = v ? launch_cta<T, kVec>(a, K, stream)
            : launch_cta<T, 1>(a, K, stream);
  } else {
    cbinorm_bwd_two_pass_kernel<T><<<a.planes, kThreads, 0, stream>>>(a);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && a.affine) {
    cbinorm_bwd_param_kernel<<<(a.C + kWarps - 1) / kWarps, kThreads, 0,
                               stream>>>(a.parts, dg, db, B, a.C);
    err = cudaGetLastError();
  }
  return err;
}

// Whether (tier, items, vec, K) is a plan that the kernels can run for a
// plane of HW elements of `size` bytes at these addresses.
bool plan_ok(int HW, int size, int tier, int items, int vec, int K,
             const void* x, const void* dy, const void* dx) {
  const int full = 16 / size;
  if (vec != 1 && vec != full) return false;
  if (vec > 1) {
    if (HW % vec != 0) return false;
    const size_t bits = reinterpret_cast<size_t>(x) |
                        reinterpret_cast<size_t>(dy) |
                        reinterpret_cast<size_t>(dx);
    if (bits % 16 != 0) return false;
  }
  if (tier == kTierWarp) {
    if (items != 2 && items != 8 && items != 32) return false;
    return HW <= 32 * items && items % vec == 0 && K == 1;
  }
  if (tier == kTierCta) {
    return items == kCtaItems && K >= 1 && K <= kMaxCluster &&
           HW > (K - 1) * kCtaChunk && HW <= K * kCtaChunk;
  }
  return tier == kTierTwoPass && vec == 1 && K == 1;
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


// ---------------------------------------------------------------------------
// channels-last (NHWC)
// ---------------------------------------------------------------------------

// The plan's limits; srgan_tpu_torch/ops/norm.py::nhwc_plan mirrors them.
constexpr int kNhwcMaxTc = 32;        // threads across a group
constexpr int kNhwcMaxGroup = 256;    // channels of a group: 32 x 8 bf16
constexpr int kNhwcMaxCluster = 16;   // Hopper's non-portable cluster limit
constexpr int kNhwcMaxBoxRows = 256;  // pixels of one TMA box
constexpr int kNhwcMaxSlots = 64;     // boxes of the ring
constexpr int kNhwcSmem = 232448;     // shared memory a block may use

template <typename T>
struct VecOf;
template <>
struct VecOf<float> {
  static constexpr int kV = 4;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct VecOf<__nv_bfloat16> {
  static constexpr int kV = 8;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// 16 raw bytes as kV fp32 values, and back.
template <typename T>
__device__ __forceinline__ void unpack(uint4 u, float* v);

template <>
__device__ __forceinline__ void unpack<float>(uint4 u, float* v) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 u, float* v) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* v);

template <>
__device__ __forceinline__ uint4 pack<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

// Two fp32 values rounded to nearest bf16 in one conversion, the lower
// address holding the first: the bits of bf16_bits(lo) | bf16_bits(hi) << 16.
__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* v) {
  return make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                    bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7]));
}

// A plane's y = x * scale + shift from its statistics, every rounding
// fixed (no contraction), so that both kernels get the same bits.
__device__ __forceinline__ void nhwc_coef(float m, float r, float gc,
                                          float tb, float bc, float& scale,
                                          float& shift) {
  scale = __fmul_rn(r, gc);
  shift = __fadd_rn(__fmul_rn(__fsub_rn(tb, __fmul_rn(m, r)), gc), bc);
}

// The cluster barrier in two halves (every thread of every block arrives).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The TMA and mbarrier instructions the kernel uses.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The initialised barriers made visible to the copy engine and the cluster.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrives once and expects `bytes` of copies before the phase completes.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the (B, HW, C) tensor `map` (channels from c, pixels from p,
// sample n) into shared memory at dst; completion is counted on bar.
// Pixels past HW arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c, int p, int n,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c), "r"(p), "r"(n),
      "r"(smem_addr(bar))
      : "memory");
}

// The TMA map's descriptor fetched ahead of its first copy.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<unsigned long long>(map))
               : "memory");
}

// The consumer warps' own barrier (named barrier 1): the producer warp
// takes no part.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives on the barrier at bar's place in the shared memory of the
// cluster's block `rank`, releasing this block's earlier writes to the
// cluster.
__device__ __forceinline__ void mbar_arrive_remote(unsigned long long* bar,
                                                   int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

// mbar_wait that also acquires what the cluster's blocks released.
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar,
                                                  unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

template <typename T>
struct NhwcArgs {
  const T* x;
  const T* dy;   // backward
  const float* t;
  const float* g;
  const float* b;
  T* out;        // y, or dx
  float* mu;     // (B, C): written by the forward, read by the backward
  float* rstd;   // (B, C)
  float* dt;     // (B, C), written by the backward under affine
  float* parts;  // (2, B, C), written by the backward under affine
  int B;
  int C;
  int HW;
  int tc_log2;   // threads across a group: 1, 2, 4, ... 32
  int rows;      // pixels of a TMA box
  int boxes;     // boxes of a tile a block holds
  int K;         // blocks of a cluster, which together hold a tile
  int S;         // slots of the ring, each a box of x (and one of dy)
  int relu;
  int affine;
  float eps;
};

// Bytes of a block's bookkeeping past its ring, for a group of cb channels,
// a cluster of K and S slots (NhwcBook's arrays).
long nhwc_book_bytes(int cb, int K, int S) {
  return (88L + 16L * K) * cb + 16L * S + 16;
}

// A block's bookkeeping in shared memory past its ring.
struct NhwcBook {
  float4* coef;               // [cb] per channel of the group
  float2* k12;                // [cb] backward: S1 / HW, S2 / HW
  float* red;                 // [8][2][cb] the warps' sums
  float* recv;                // [2][K][2][cb] the cluster's, by tile parity
  unsigned long long* full;   // [S] a slot's copies arrived
  unsigned long long* empty;  // [S] a slot's box read by the 8 warps
  unsigned long long* xchg;   // [2] the K blocks' sums arrived, by parity
  __device__ NhwcBook(unsigned char* p, int cb, int K, int S)
      : coef(reinterpret_cast<float4*>(p)),
        k12(reinterpret_cast<float2*>(p + 16 * cb)),
        red(reinterpret_cast<float*>(p + 24 * cb)),
        recv(reinterpret_cast<float*>(p + 88 * cb)),
        full(reinterpret_cast<unsigned long long*>(p + (88 + 16 * K) * cb)),
        empty(full + S),
        xchg(empty + S) {}
};

// Two per-channel sums (a, b) of the thread's V channels over the tile's
// pixels, in a fixed order: the warp's rows by a shuffle butterfly (lanes of
// one vector lie TC apart), the 8 warps by a fixed tree in shared memory,
// then the cluster's K blocks in rank order.  Consumer thread ch < TC * V
// ends with channel ch's totals in (ta, tb), the same bits in every block of
// the cluster.  Every consumer thread calls it, for the block's j-th tile.
// With K > 1 each block writes its totals into every block's bk.recv (half
// j % 2, row of its rank) through distributed shared memory and arrives on
// that block's bk.xchg[j % 2]; a block reads its rows once K have arrived.
// A block writes half h for tile j + 2 only after every block's tile j + 1
// sums reached it, which each sent after reading tile j's half h.
template <int V>
__device__ __forceinline__ void nhwc_total(float* a, float* b, int tc,
                                           int cv, int K, int rank, int j,
                                           const NhwcBook& bk, float& ta,
                                           float& tb) {
  static_assert(kWarps == 8, "the tree below adds 8 warps");
  for (int o = 16; o >= tc; o >>= 1) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      a[q] += __shfl_xor_sync(0xffffffffu, a[q], o);
      b[q] += __shfl_xor_sync(0xffffffffu, b[q], o);
    }
  }
  const int warp = threadIdx.x >> 5;
  const int cb = tc * V;
  if ((threadIdx.x & 31) < tc) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      bk.red[2 * warp * cb + cv * V + q] = a[q];
      bk.red[(2 * warp + 1) * cb + cv * V + q] = b[q];
    }
  }
  consumers_sync();
  const int ch = threadIdx.x;
  const bool owner = ch < cb;
  if (owner) {
    float r[kWarps], q[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      r[w] = bk.red[2 * w * cb + ch];
      q[w] = bk.red[(2 * w + 1) * cb + ch];
    }
    ta = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    tb = ((q[0] + q[1]) + (q[2] + q[3])) + ((q[4] + q[5]) + (q[6] + q[7]));
  }
  if (K == 1) return;
  if (j == 0) cluster_wait();  // every block of the cluster has started
  const int half = j & 1;
  float* mine = bk.recv + (half * K + rank) * 2 * cb;
  if (owner) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int r = 0; r < K; ++r) {
      float* dst = cluster.map_shared_rank(mine, r);
      dst[ch] = ta;
      dst[cb + ch] = tb;
    }
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  }
  consumers_sync();
  if (threadIdx.x < K) mbar_arrive_remote(&bk.xchg[half], threadIdx.x);
  if (owner) {
    mbar_wait_cluster(&bk.xchg[half], static_cast<unsigned>((j >> 1) & 1));
    const float* rows = bk.recv + half * K * 2 * cb;
    ta = 0.f;
    tb = 0.f;
    for (int r = 0; r < K; ++r) {
      ta += rows[r * 2 * cb + ch];
      tb += rows[r * 2 * cb + cb + ch];
    }
  }
}

// dy masked by the forward's y > 0 under ReLU (y recomputed from the
// plane's scale and shift).
__device__ __forceinline__ float masked(float d, float x, float scale,
                                        float shift, int relu) {
  return relu && !(fmaf(x, scale, shift) > 0.f) ? 0.f : d;
}

// The NHWC forward (kBwd false) or backward (true), persistent and warp
// specialised.  A tile is one channel group of TC vectors (TC * V channels)
// of one sample; the K blocks of a cluster hold its pixels, block rank q
// pixels [q * P, q * P + P) with P = rows * boxes, as `boxes` TMA boxes of
// x (and of dy).  Cluster i takes tiles i, i + n, i + 2n, ... of the call
// (n clusters in the grid).  A block's ring has S >= boxes + 1 slots of one
// box each: its producer warp loads the boxes of its tiles in order, each
// into the next slot as soon as the 8 consumer warps have read the box
// before it there; the consumers sum a tile's boxes as they arrive,
// exchange the sums with the cluster, compute the coefficients, and write
// y (or dx) box by box, freeing each slot as they leave it.  So every slot
// that does not hold the tile in hand holds a load in flight.
template <typename T, bool kBwd>
__device__ __forceinline__ void nhwc_body(const CUtensorMap& mx,
                                          const CUtensorMap& mdy,
                                          const NhwcArgs<T>& a) {
  constexpr int V = VecOf<T>::kV;
  extern __shared__ unsigned char dsmem[];
  unsigned char* ring = dsmem + ((128u - (smem_addr(dsmem) & 127u)) & 127u);
  const int tc = 1 << a.tc_log2;
  const int cb = tc * V;
  const int groups = a.C / cb;
  const int tiles = a.B * groups;
  const int rows = a.rows;
  const int box_bytes = rows * tc * 16;
  const int slot_bytes = kBwd ? 2 * box_bytes : box_bytes;
  const int K = a.K;
  const NhwcBook bk(ring + a.S * slot_bytes, cb, K, a.S);
  const int rank = blockIdx.x % K;
  const int cid = blockIdx.x / K;
  const int ncl = gridDim.x / K;
  const int first = rank * rows * a.boxes;  // the block's first pixel
  const int nv = min(rows * a.boxes, a.HW - first);  // >= 1 by the plan

  if (threadIdx.x == kThreads) {
    prefetch_map(&mx);
    if (kBwd) prefetch_map(&mdy);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.S; ++s) {
      mbar_init(&bk.full[s], 1);
      mbar_init(&bk.empty[s], kWarps);
    }
    mbar_init(&bk.xchg[0], K);
    mbar_init(&bk.xchg[1], K);
    mbar_fence_init();
  }
  __syncthreads();
  // every block's barriers are ready before another block writes to it:
  // each arrives here and waits before its first remote access
  // (nhwc_total's, in the first tile) or, in the producer warp, before it
  // arrives again to leave
  if (K > 1) cluster_arrive();

  if (threadIdx.x >= kThreads) {
    // the producer warp: one lane starts every load
    if (threadIdx.x == kThreads) {
      int n = 0;
      for (int tile = cid; tile < tiles; tile += ncl) {
        const int smp = tile / groups;
        const int g0 = (tile - smp * groups) * cb;
        for (int i = 0; i < a.boxes; ++i, ++n) {
          const int s = n % a.S;
          if (n >= a.S) {
            mbar_wait(&bk.empty[s], static_cast<unsigned>((n / a.S - 1) & 1));
          }
          if (i * rows >= nv) {
            // past the sample's last pixel: an empty box
            mbar_arrive(&bk.full[s]);
            continue;
          }
          unsigned char* slot = ring + s * slot_bytes;
          mbar_expect(&bk.full[s], static_cast<unsigned>(slot_bytes));
          tma_load(slot, &mx, g0, first + i * rows, smp, &bk.full[s]);
          if (kBwd) {
            tma_load(slot + box_bytes, &mdy, g0, first + i * rows, smp,
                     &bk.full[s]);
          }
        }
      }
    }
  } else {
    const int cv = threadIdx.x & (tc - 1);
    const int prow = threadIdx.x >> a.tc_log2;
    const int rstep = kThreads >> a.tc_log2;
    const int lane = threadIdx.x & 31;
    const float n = static_cast<float>(a.HW);
    int j = 0;
    int box0 = 0;  // the tile's first box in the block's sequence
    for (int tile = cid; tile < tiles; tile += ncl, ++j, box0 += a.boxes) {
      const int smp = tile / groups;
      const int g0 = (tile - smp * groups) * cb;
      T* out = a.out + (static_cast<size_t>(smp) * a.HW + first) * a.C + g0 +
               cv * V;
      float s1[V], s2[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        s1[q] = 0.f;
        s2[q] = 0.f;
      }
      float cm[V], cr[V], cs[V], csh[V];
      if (kBwd) {
        // a thread per channel of the group: (mu, rstd, scale, shift),
        // which need not wait for the copies
        if (threadIdx.x < cb) {
          const int c = g0 + threadIdx.x;
          const int plane = smp * a.C + c;
          const float m = a.mu[plane];
          const float r = a.rstd[plane];
          float scale, shift;
          nhwc_coef(m, r, a.g[c], a.t[plane], a.b[c], scale, shift);
          bk.coef[threadIdx.x] = make_float4(m, r, scale, shift);
        }
        consumers_sync();
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float4 cf = bk.coef[cv * V + q];
          cm[q] = cf.x;
          cr[q] = cf.y;
          cs[q] = cf.z;
          csh[q] = cf.w;
        }
      }
      for (int i = 0; i < a.boxes; ++i) {
        const int s = (box0 + i) % a.S;
        mbar_wait(&bk.full[s], static_cast<unsigned>(((box0 + i) / a.S) & 1));
        const T* sx = reinterpret_cast<const T*>(ring + s * slot_bytes);
        const T* sdy =
            reinterpret_cast<const T*>(ring + s * slot_bytes + box_bytes);
        const int m = min(rows, nv - i * rows);
#pragma unroll 4
        for (int p = prow; p < m; p += rstep) {
          float xv[V];
          unpack<T>(*reinterpret_cast<const uint4*>(sx + p * cb + cv * V),
                    xv);
          if (kBwd) {
            float dv[V];
            unpack<T>(
                *reinterpret_cast<const uint4*>(sdy + p * cb + cv * V), dv);
#pragma unroll
            for (int q = 0; q < V; ++q) {
              const float d = masked(dv[q], xv[q], cs[q], csh[q], a.relu);
              s1[q] += d;
              s2[q] = fmaf(d, (xv[q] - cm[q]) * cr[q], s2[q]);
            }
          } else {
#pragma unroll
            for (int q = 0; q < V; ++q) {
              s1[q] += xv[q];
              s2[q] = fmaf(xv[q], xv[q], s2[q]);
            }
          }
        }
      }
      float ta = 0.f, tb = 0.f;
      nhwc_total<V>(s1, s2, tc, cv, K, rank, j, bk, ta, tb);
      if (threadIdx.x < cb) {
        const int c = g0 + threadIdx.x;
        const int plane = smp * a.C + c;
        if (kBwd) {
          if (a.affine && rank == 0) {
            a.dt[plane] = a.g[c] * ta;
            a.parts[plane] = ta;
            a.parts[a.B * a.C + plane] = tb + a.t[plane] * ta;
          }
          const float inv_n = 1.f / n;
          bk.k12[threadIdx.x] = make_float2(ta * inv_n, tb * inv_n);
        } else {
          const float m = ta / n;
          const float r = rsqrtf(fmaxf(tb / n - m * m, 0.f) + a.eps);
          float scale, shift;
          nhwc_coef(m, r, a.g[c], a.t[plane], a.b[c], scale, shift);
          bk.coef[threadIdx.x] = make_float4(scale, shift, 0.f, 0.f);
          if (rank == 0) {
            a.mu[plane] = m;
            a.rstd[plane] = r;
          }
        }
      }
      consumers_sync();
      float k1[V], k2[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        if (kBwd) {
          const float2 kk = bk.k12[cv * V + q];
          k1[q] = kk.x;
          k2[q] = kk.y;
        } else {
          const float4 cf = bk.coef[cv * V + q];
          cs[q] = cf.x;
          csh[q] = cf.y;
        }
      }
      for (int i = 0; i < a.boxes; ++i) {
        const int s = (box0 + i) % a.S;
        const T* sx = reinterpret_cast<const T*>(ring + s * slot_bytes);
        const T* sdy =
            reinterpret_cast<const T*>(ring + s * slot_bytes + box_bytes);
        const int m = min(rows, nv - i * rows);
#pragma unroll 4
        for (int p = prow; p < m; p += rstep) {
          float v[V];
          unpack<T>(*reinterpret_cast<const uint4*>(sx + p * cb + cv * V),
                    v);
          if (kBwd) {
            float dv[V];
            unpack<T>(
                *reinterpret_cast<const uint4*>(sdy + p * cb + cv * V), dv);
#pragma unroll
            for (int q = 0; q < V; ++q) {
              const float d = masked(dv[q], v[q], cs[q], csh[q], a.relu);
              const float xhat = (v[q] - cm[q]) * cr[q];
              v[q] = cs[q] * (d - k1[q] - xhat * k2[q]);
            }
          } else {
#pragma unroll
            for (int q = 0; q < V; ++q) {
              v[q] = fmaf(v[q], cs[q], csh[q]);
              if (a.relu) v[q] = fmaxf(v[q], 0.f);
            }
          }
          *reinterpret_cast<uint4*>(
              out + static_cast<size_t>(i * rows + p) * a.C) = pack<T>(v);
        }
        // the warp is done with the slot
        __syncwarp();
        if (lane == 0) mbar_arrive(&bk.empty[s]);
      }
    }
  }
  // no block leaves while another may still write its shared memory
  if (K > 1) {
    if (threadIdx.x >= kThreads) cluster_wait();
    cluster_arrive();
    cluster_wait();
  }
}

// The two kernels, under names of their own on the device's trace: 8
// consumer warps and one producer warp a block.
constexpr int kNhwcThreads = kThreads + 32;

template <typename T>
__global__ void __launch_bounds__(kNhwcThreads, 2)
cbinorm_fwd_nhwc_kernel(const __grid_constant__ CUtensorMap mx,
                        const NhwcArgs<T> a) {
  nhwc_body<T, false>(mx, mx, a);
}

template <typename T>
__global__ void __launch_bounds__(kNhwcThreads, 2)
cbinorm_bwd_nhwc_kernel(const __grid_constant__ CUtensorMap mx,
                        const __grid_constant__ CUtensorMap mdy,
                        const NhwcArgs<T> a) {
  nhwc_body<T, true>(mx, mdy, a);
}

// cuTensorMapEncodeTiled, looked up in the libcuda.so.1 that the process
// has loaded (this library links only the CUDA runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_LAZY);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// The (B, HW, C) tensor at p as a TMA map whose box is `rows` pixels of
// `cb` channels of one sample.
template <typename T>
bool nhwc_map(CUtensorMap* m, const void* p, int B, int HW, int C, int cb,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dim[3] = {static_cast<cuuint64_t>(C),
                             static_cast<cuuint64_t>(HW),
                             static_cast<cuuint64_t>(B)};
  const cuuint64_t stride[2] = {static_cast<cuuint64_t>(C) * sizeof(T),
                                static_cast<cuuint64_t>(HW) * C * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cb),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(m, VecOf<T>::kMap, 3, const_cast<void*>(p), dim, stride, box,
                step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Bytes of a block's ring: S slots of a box of `rows` pixels of TC 16-byte
// vectors, of x alone or of x and dy.
long nhwc_ring_bytes(int tc, int rows, int S, bool bwd) {
  return static_cast<long>(S) * rows * tc * 16 * (bwd ? 2 : 1);
}

// The clusters of K blocks with `smem` bytes each that the device holds at
// once for `fn`, asked of the runtime once per (kernel, device, K, smem).
// The first ask also lets the kernel take all of a block's shared memory
// and clusters of up to 16.
cudaError_t max_clusters(const void* fn, int K, size_t smem, int* out) {
  struct Entry {
    const void* fn;
    int dev;
    int K;
    size_t smem;
    int n;
  };
  static std::mutex lock;
  static std::vector<Entry> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  for (const Entry& e : seen) {
    if (e.fn == fn && e.dev == dev && e.K == K && e.smem == smem) {
      *out = e.n;
      return cudaSuccess;
    }
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kNhwcSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(K), 1, 1);
  cfg.blockDim = dim3(kNhwcThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(out, fn, &cfg);
  if (err == cudaSuccess) seen.push_back({fn, dev, K, smem, *out});
  return err;
}

// One persistent launch of `kernel` on `args`: as many clusters of K blocks
// as the device holds at once, at most one a tile.
template <typename... Params, typename... Args>
cudaError_t launch_persistent(void (*kernel)(Params...), int tiles, int K,
                              size_t smem, cudaStream_t stream,
                              const Args&... args) {
  int clusters = 0;
  cudaError_t err = max_clusters(reinterpret_cast<const void*>(kernel), K,
                                 smem, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(std::min(tiles, clusters) * K), 1,
                     1);
  cfg.blockDim = dim3(kNhwcThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The forward (kBwd false) or the backward on a's tensors: the TMA maps of
// x (and dy), then one persistent launch.
template <typename T, bool kBwd>
cudaError_t launch_nhwc(const NhwcArgs<T>& a, cudaStream_t stream) {
  const int tc = 1 << a.tc_log2;
  const int cb = tc * VecOf<T>::kV;
  const int tiles = a.B * (a.C / cb);
  const size_t smem = 128 + nhwc_ring_bytes(tc, a.rows, a.S, kBwd) +
                      nhwc_book_bytes(cb, a.K, a.S);
  CUtensorMap mx;
  if (!nhwc_map<T>(&mx, a.x, a.B, a.HW, a.C, cb, a.rows)) {
    return cudaErrorInvalidValue;
  }
  if (!kBwd) {
    return launch_persistent(cbinorm_fwd_nhwc_kernel<T>, tiles, a.K, smem,
                             stream, mx, a);
  }
  CUtensorMap mdy;
  if (!nhwc_map<T>(&mdy, a.dy, a.B, a.HW, a.C, cb, a.rows)) {
    return cudaErrorInvalidValue;
  }
  return launch_persistent(cbinorm_bwd_nhwc_kernel<T>, tiles, a.K, smem,
                           stream, mx, mdy, a);
}

int log2_of(int v) {
  int k = 0;
  while ((1 << k) < v) ++k;
  return k;
}

// Whether (tc, rows, boxes, K, S) is an NHWC plan for (B, HW, C) of
// `size`-byte elements at these addresses: whole 16-byte vectors along C,
// every pointer 16-byte aligned, boxes of a multiple of 8 pixels, K blocks
// of rows * boxes pixels that the sample's HW pixels need all of, and a ring
// of S > boxes slots (a tile's boxes and at least one box loading) that fits
// a block's shared memory with its bookkeeping.
bool nhwc_plan_ok(int C, int HW, int size, int tc, int rows, int boxes,
                  int K, int S, bool bwd,
                  std::initializer_list<const void*> ptrs) {
  const int V = 16 / size;
  if (tc < 1 || tc > kNhwcMaxTc || (tc & (tc - 1)) != 0) return false;
  if (C % (tc * V) != 0 || tc * V > kNhwcMaxGroup) return false;
  if (rows < 8 || rows > kNhwcMaxBoxRows || rows % 8 != 0 || boxes < 1 ||
      K < 1 || K > kNhwcMaxCluster || S <= boxes || S > kNhwcMaxSlots) {
    return false;
  }
  const long P = static_cast<long>(rows) * boxes;
  if (HW > K * P || HW <= (K - 1) * P) return false;
  if (128 + nhwc_ring_bytes(tc, rows, S, bwd) +
          nhwc_book_bytes(tc * V, K, S) > kNhwcSmem) {
    return false;
  }
  size_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<size_t>(p);
  return bits % 16 == 0;
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
// parts: (2, B, C) fp32 scratch; g, b, dg, db: (C,) fp32.  The plan (tier,
// items, vec, cluster) is srgan_tpu_torch/ops/norm.py::bwd_plan's; one that
// does not fit HW or the addresses is refused.  With affine = 0 only dx is
// written, and dt, parts, dg and db may be null.  Launches one grid, and a
// second one for dg and db under affine, on the stream; returns the
// cudaError_t of the launches (0 on success).
extern "C" int srgan_cbinorm_bwd(const void* x, const void* dy,
                                 const void* t, const void* g, const void* b,
                                 const void* mu, const void* rstd, void* dx,
                                 void* dt, void* parts, void* dg, void* db,
                                 int B, int C, int HW, int relu, int affine,
                                 int dtype, int tier, int items, int vec,
                                 int cluster, void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  if (B <= 0 || C <= 0 || HW <= 0 || (dtype != 0 && dtype != 1) ||
      !plan_ok(HW, size, tier, items, vec, cluster, x, dy, dx) ||
      (affine && (!dt || !parts || !dg || !db))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dgf = static_cast<float*>(dg);
  float* dbf = static_cast<float*>(db);
  const float* tf = static_cast<const float*>(t);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(mu);
  const float* rf = static_cast<const float*>(rstd);
  float* dtf = static_cast<float*>(dt);
  float* pf = static_cast<float*>(parts);
  cudaError_t err;
  if (dtype == 0) {
    const BwdArgs<float> a{static_cast<const float*>(x),
                           static_cast<const float*>(dy), tf, gf, bf, mf, rf,
                           static_cast<float*>(dx), dtf, pf, B * C, C, HW,
                           relu, affine};
    err = launch_bwd(a, dgf, dbf, B, tier, items, vec, cluster, s);
  } else {
    const BwdArgs<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), tf, gf, bf, mf, rf,
        static_cast<__nv_bfloat16*>(dx), dtf, pf, B * C, C, HW, relu, affine};
    err = launch_bwd(a, dgf, dbf, B, tier, items, vec, cluster, s);
  }
  return static_cast<int>(err);
}

// C entry point of the channels-last forward, bound with ctypes.  x, y:
// (B, HW, C) in dtype (0 = float32, 1 = bfloat16); t, mu, rstd: (B, C)
// fp32; g, b: (C,) fp32.  The plan (tc, rows, boxes, cluster, stages) is
// srgan_tpu_torch/ops/norm.py::nhwc_plan's; one that does not fit the shape,
// the addresses or a block's shared memory is refused.  Returns the launch's
// cudaError_t.
extern "C" int srgan_cbinorm_fwd_nhwc(const void* x, const void* t,
                                      const void* g, const void* b, void* y,
                                      void* mu, void* rstd, int B, int C,
                                      int HW, float eps, int relu, int dtype,
                                      int tc, int rows, int boxes,
                                      int cluster, int stages,
                                      void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  if (B <= 0 || C <= 0 || HW <= 0 || (dtype != 0 && dtype != 1) ||
      !nhwc_plan_ok(C, HW, size, tc, rows, boxes, cluster, stages, false,
                    {x, y})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tf = static_cast<const float*>(t);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  float* mf = static_cast<float*>(mu);
  float* rf = static_cast<float*>(rstd);
  cudaError_t err;
  if (dtype == 0) {
    const NhwcArgs<float> a{static_cast<const float*>(x), nullptr, tf, gf, bf,
                            static_cast<float*>(y), mf, rf, nullptr, nullptr,
                            B, C, HW, log2_of(tc), rows, boxes, cluster,
                            stages, relu, 0, eps};
    err = launch_nhwc<float, false>(a, s);
  } else {
    const NhwcArgs<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(x), nullptr, tf, gf, bf,
        static_cast<__nv_bfloat16*>(y), mf, rf, nullptr, nullptr, B, C, HW,
        log2_of(tc), rows, boxes, cluster, stages, relu, 0, eps};
    err = launch_nhwc<__nv_bfloat16, false>(a, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// C entry point of the channels-last backward, bound with ctypes.  x, dy,
// dx: (B, HW, C) in dtype; t, mu, rstd, dt: (B, C) fp32; parts: (2, B, C)
// fp32 scratch; g, b, dg, db: (C,) fp32.  The plan is nhwc_plan's for two
// staged tensors, checked as for the forward.  With affine = 0 only dx is
// written, and dt, parts, dg and db may be null.  Launches one grid, and
// under affine the NCHW pair's ordered batch reduction for dg and db;
// returns the cudaError_t.
extern "C" int srgan_cbinorm_bwd_nhwc(const void* x, const void* dy,
                                      const void* t, const void* g,
                                      const void* b, const void* mu,
                                      const void* rstd, void* dx, void* dt,
                                      void* parts, void* dg, void* db, int B,
                                      int C, int HW, int relu, int affine,
                                      int dtype, int tc, int rows, int boxes,
                                      int cluster, int stages, void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  if (B <= 0 || C <= 0 || HW <= 0 || (dtype != 0 && dtype != 1) ||
      !nhwc_plan_ok(C, HW, size, tc, rows, boxes, cluster, stages, true,
                    {x, dy, dx}) ||
      (affine && (!dt || !parts || !dg || !db))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tf = static_cast<const float*>(t);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  float* mf = const_cast<float*>(static_cast<const float*>(mu));
  float* rf = const_cast<float*>(static_cast<const float*>(rstd));
  float* dtf = static_cast<float*>(dt);
  float* pf = static_cast<float*>(parts);
  cudaError_t err;
  if (dtype == 0) {
    const NhwcArgs<float> a{static_cast<const float*>(x),
                            static_cast<const float*>(dy), tf, gf, bf,
                            static_cast<float*>(dx), mf, rf, dtf, pf, B, C,
                            HW, log2_of(tc), rows, boxes, cluster, stages,
                            relu, affine, 0.f};
    err = launch_nhwc<float, true>(a, s);
  } else {
    const NhwcArgs<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), tf, gf, bf,
        static_cast<__nv_bfloat16*>(dx), mf, rf, dtf, pf, B, C, HW,
        log2_of(tc), rows, boxes, cluster, stages, relu, affine, 0.f};
    err = launch_nhwc<__nv_bfloat16, true>(a, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && affine) {
    cbinorm_bwd_param_kernel<<<(C + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        pf, static_cast<float*>(dg), static_cast<float*>(db), B, C);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
