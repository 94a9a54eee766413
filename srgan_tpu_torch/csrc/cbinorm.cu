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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
