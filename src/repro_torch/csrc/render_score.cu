// Population render + score: the tracker's population evaluation (K1),
// and the edge server's evaluation of B clients' populations in one
// launch (K1b).
//
// Replaces the Pallas TPU kernels repro/kernels/render_score.py:
// render_score_sums and render_score_sums_batched (_render_score_kernel
// and _render_score_batched_kernel, tile body _score_tile).  For every
// client b and particle n it computes
//
//   sum_p mask[b,p] * min(|min_s t(ray_{b,p}, sphere_{b,n,s}) - depth[b,p]|,
//                         clamp_t)
//
// where t is the near root of the ray/sphere intersection (rays have
// d_z == 1, so t is metric depth), a hit needs disc >= 0 and t > 1e-4,
// a miss counts as `background`, and the min with clamp_t propagates a
// NaN depth as jnp.minimum does: one NaN depth, masked or not, makes
// every particle's sum NaN (NaN * 0 is NaN).
//
// What bounds it on an H100.  At the tracker's masks (the bounding box
// |depth - z_prev| < 0.25 m keeps ~4% of the 16,384 pixels) it is
// latency: the launch, the scan of the mask, the sphere tests of a few
// hundred pixels and the cluster's barrier, each a few microseconds of
// dependent steps; the sphere tests themselves need well under a
// microsecond of the card's fp32 rate.  On a dense mask it is the fp32
// work of the ~50M ray/sphere tests, with the IEEE sqrt and division of
// every hit.  The design:
//   * Only pixels whose term can be non-zero are scored.  With a finite
//     background and a finite clamp_t, rendered depth is finite and the
//     clamped term is finite, so a pixel with mask == 0 and a depth that
//     is not NaN adds exactly +0; the kernel keeps pixel p iff
//     mask[p] != 0 || isnan(depth[p]) and skips every other pixel without
//     testing a sphere.  This is exact, for any float mask.  With a
//     background or a clamp_t that is not finite a masked-out term can be
//     NaN (NaN background, inf - inf, inf * 0), as in the Pallas kernel,
//     so then every pixel is kept.
//   * A NaN background makes a pixel's depth NaN wherever a sphere
//     misses (jnp.min propagates it).  The sphere loop keeps fminf and
//     runs with -inf as the miss depth instead; a hit is > 1e-4, so a
//     rendered -inf marks a miss and becomes NaN before the term.
//   * The compaction happens in the kernel, not with host-synchronizing
//     PyTorch indexing.  The pixels are cut into 256-pixel segments dealt
//     round-robin to the 8 blocks of a (client, particle), so a band of
//     kept rows spreads evenly over them.  A block scans its segments
//     2,048 pixels at a time (16-byte loads where the rows are aligned),
//     forms a keep bit per pixel, and __ballot_sync/__popc plus a prefix
//     over its warps append the kept pixels' indices to a shared-memory
//     list in pixel order.  The list holds 4,096 indices; when the next
//     pass might not fit, the block scores what it holds and empties it,
//     so any kept count works, in windows.
//   * Scoring walks the list.  The spheres are staged in shared memory
//     as (cx, cy, cz, |c|^2 - r^2).  While more than a block's width of
//     pixels remain, a thread takes 4 of them and tests every sphere
//     (each shared load reused 4 times: the dense mask's throughput).
//     A shorter rest is split by sphere: L = 4, 2 or 1 lanes per pixel,
//     each testing every L-th sphere, and the lanes' minima are combined
//     by shuffles, so a sparse mask's dependent chain is 48 / L tests
//     long.  The min is exact, so every path renders the same depth.
//     Both sphere loops are unrolled (2 and 4 spheres), so the
//     scheduler overlaps the tests of neighbouring spheres, which depend
//     on each other only through the running min.
//     The sqrt and the IEEE division run only where disc >= 0.  Built
//     without --use_fast_math, the rounding written out with __fmaf_rn
//     and friends: approximate sqrt/division flip silhouette pixels.
//     The K=3 dot is fp32 FMAs, not tensor cores.
//   * One launch, deterministic.  The 8 blocks of a (client, particle)
//     form a thread block cluster.  Each reduces its terms in a fixed
//     order (a shuffle tree per warp, then the warp sums in warp order)
//     and stores the result into rank 0's shared memory through
//     distributed shared memory; a cluster barrier whose arrive is the
//     kernel's first instruction guarantees rank 0 has started.  After
//     cluster.sync() rank 0 adds the 8 partial sums in rank order and
//     writes the result.  No block's shared memory is read by another
//     after the barrier, so one barrier closes the sum.  No float
//     atomics, no scratch in device memory: repeated runs are
//     bit-identical.
//   * K1 is the B = 1 launch.  A block's work depends on b only through
//     the offsets of its inputs, so row b of K1b equals K1 on client b
//     bit for bit.
//   * At most 48 registers, so 5 blocks of 256 threads share an SM and
//     the card holds all of K1's 64 clusters at once
//     (render_score_max_active_clusters says how many it holds).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocksPerSm = 5;
constexpr int kClusterBlocks = 8;  // blocks per (client, particle): one cluster
constexpr int kSegment = 256;      // pixels per round-robin segment
constexpr int kSubPixels = 4 * kThreads;  // one float4 per thread and input
constexpr int kSubs = 2;                  // sub-passes per scan pass
constexpr int kPassPixels = kSubs * kSubPixels;
constexpr int kSegmentsPerSub = kSubPixels / kSegment;
constexpr int kListCapacity = 2 * kPassPixels;  // kept-pixel indices held
constexpr int kWide = 4;  // pixels per thread on a long list
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// min(a, b) that keeps a NaN from either side, as jnp.minimum does
// (CUDA's fminf drops it).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

struct Ray {
  float x, y, z, d2;
};

// The ray of pixel p; p < 0 gives a well-formed ray (d_z = 1) that adds
// nothing.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int p) {
  Ray r;
  r.x = p < 0 ? 0.0f : rays[3 * p];
  r.y = p < 0 ? 0.0f : rays[3 * p + 1];
  r.z = p < 0 ? 1.0f : rays[3 * p + 2];
  r.d2 = norm2(r.x, r.y, r.z);
  return r;
}

// min(dmin, t) for one ray and one staged sphere: t is the near root on
// a hit (disc >= 0 and t > 1e-4), else miss.  Never NaN.
__device__ __forceinline__ float render(float dmin, const Ray& r, float4 c, float miss) {
  const float dc = __fmaf_rn(r.z, c.z, __fmaf_rn(r.y, c.y, __fmul_rn(r.x, c.x)));
  const float disc = __fmaf_rn(dc, dc, -__fmul_rn(r.d2, c.w));
  float t = miss;
  if (disc >= 0.0f) {
    const float t_hit = __fdiv_rn(__fsub_rn(dc, __fsqrt_rn(disc)), r.d2);
    if (t_hit > 1e-4f) t = t_hit;
  }
  return fminf(dmin, t);
}

// The term of one pixel.  nan_background: the sphere loop ran with -inf
// as the miss depth, and a missed sphere makes the depth NaN.
__device__ __forceinline__ float term(float d_h, float d_o, float m, float clamp_t,
                                      bool nan_background) {
  if (nan_background && d_h == neg_inf()) d_h = __int_as_float(0x7fc00000);
  return __fmul_rn(nan_min(fabsf(__fsub_rn(d_h, d_o)), clamp_t), m);
}

// A long list: listed pixels base + threadIdx.x + k * kThreads, k < kWide,
// every sphere; adds their terms to acc in k order.
__device__ __forceinline__ void score_wide(const float4* __restrict__ sph, int num_spheres,
                                           const int* list, int count, int base,
                                           const float* __restrict__ rays,
                                           const float* __restrict__ depth,
                                           const float* __restrict__ mask, float clamp_t,
                                           float miss, bool nan_background, float& acc) {
  if (base + static_cast<int>(threadIdx.x & ~31u) >= count) return;  // warp idle
  int idx[kWide];
  Ray r[kWide];
  float dmin[kWide];
#pragma unroll
  for (int k = 0; k < kWide; ++k) {
    const int i = base + static_cast<int>(threadIdx.x) + k * kThreads;
    idx[k] = i < count ? list[i] : -1;
    r[k] = load_ray(rays, idx[k]);
    dmin[k] = __int_as_float(0x7f800000);  // +inf
  }
#pragma unroll 2
  for (int j = 0; j < num_spheres; ++j) {
    const float4 c = sph[j];
#pragma unroll
    for (int k = 0; k < kWide; ++k) dmin[k] = render(dmin[k], r[k], c, miss);
  }
#pragma unroll
  for (int k = 0; k < kWide; ++k) {
    if (idx[k] >= 0) acc += term(dmin[k], depth[idx[k]], mask[idx[k]], clamp_t, nan_background);
  }
}

// A short rest: listed pixel base + threadIdx.x / L, its spheres
// j = sub, sub + L, ... on lane sub = threadIdx.x % L; the L lanes' minima
// are combined and lane 0 adds the term to acc.
template <int L>
__device__ __forceinline__ void score_split(const float4* __restrict__ sph, int num_spheres,
                                            const int* list, int count, int base,
                                            const float* __restrict__ rays,
                                            const float* __restrict__ depth,
                                            const float* __restrict__ mask, float clamp_t,
                                            float miss, bool nan_background, float& acc) {
  if (base + static_cast<int>(threadIdx.x & ~31u) / L >= count) return;  // warp idle
  const int sub = threadIdx.x % L;
  const int i = base + static_cast<int>(threadIdx.x) / L;
  const int idx = i < count ? list[i] : -1;
  const Ray r = load_ray(rays, idx);
  float dmin = __int_as_float(0x7f800000);
#pragma unroll 4
  for (int j = sub; j < num_spheres; j += L) dmin = render(dmin, r, sph[j], miss);
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) dmin = fminf(dmin, __shfl_xor_sync(kFullMask, dmin, o));
  if (idx >= 0 && sub == 0) acc += term(dmin, depth[idx], mask[idx], clamp_t, nan_background);
}

// Scores the list's count pixels.  The split depends only on count, so a
// given list is always added in the same order.
__device__ __forceinline__ void score_list(const float4* __restrict__ sph, int num_spheres,
                                           const int* list, int count,
                                           const float* __restrict__ rays,
                                           const float* __restrict__ depth,
                                           const float* __restrict__ mask, float clamp_t,
                                           float miss, bool nan_background, float& acc) {
  int base = 0;
  while (count - base > kThreads) {
    score_wide(sph, num_spheres, list, count, base, rays, depth, mask, clamp_t, miss,
               nan_background, acc);
    base += kWide * kThreads;
  }
  if (base >= count) return;
  const int left = count - base;
  if (left * 4 <= kThreads) {
    score_split<4>(sph, num_spheres, list, count, base, rays, depth, mask, clamp_t, miss,
                   nan_background, acc);
  } else if (left * 2 <= kThreads) {
    score_split<2>(sph, num_spheres, list, count, base, rays, depth, mask, clamp_t, miss,
                   nan_background, acc);
  } else {
    score_split<1>(sph, num_spheres, list, count, base, rays, depth, mask, clamp_t, miss,
                   nan_background, acc);
  }
}

// Four consecutive floats from p0; those at or past num_pixels read 0.
__device__ __forceinline__ void load4(const float* __restrict__ src, int p0, int num_pixels,
                                      bool vector_loads, float (&v)[4]) {
  if (vector_loads && p0 < num_pixels) {  // p0 % 4 == 0 and num_pixels % 4 == 0
    const float4 x = *reinterpret_cast<const float4*>(src + p0);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = p0 + k < num_pixels ? src[p0 + k] : 0.0f;
  }
}

// Grid (kClusterBlocks, N, B) in clusters of (kClusterBlocks, 1, 1).
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
render_score_kernel(const float* __restrict__ spheres,  // (B, N, S, 4)
                    const float* __restrict__ rays,     // (B, P, 3)
                    const float* __restrict__ depth,    // (B, P)
                    const float* __restrict__ mask,     // (B, P)
                    float* __restrict__ out,            // (B, N)
                    int num_particles, int num_spheres, int num_pixels,
                    float clamp_t, float background) {
  extern __shared__ float4 sph[];  // (S,): cx, cy, cz, |c|^2 - r^2
  __shared__ int list[kListCapacity];
  __shared__ int warp_counts[kSubs][kWarps];
  __shared__ float warp_sums[kWarps];
  __shared__ float partials[kClusterBlocks];  // rank 0's: each rank's sum

  // Phase 0 of the cluster barrier: once it completes, every block of
  // the cluster has started, so rank 0's shared memory may be written.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z;
  const size_t row = static_cast<size_t>(b) * num_particles + blockIdx.y;
  const float* sp = spheres + row * num_spheres * 4;
  rays += static_cast<size_t>(b) * num_pixels * 3;
  depth += static_cast<size_t>(b) * num_pixels;
  mask += static_cast<size_t>(b) * num_pixels;
  for (int i = threadIdx.x; i < num_spheres; i += kThreads) {
    const float cx = sp[4 * i], cy = sp[4 * i + 1], cz = sp[4 * i + 2], r = sp[4 * i + 3];
    sph[i] = make_float4(cx, cy, cz, __fsub_rn(norm2(cx, cy, cz), __fmul_rn(r, r)));
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const bool vector_loads =
      num_pixels % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(depth) | reinterpret_cast<uintptr_t>(mask)) & 15) == 0;
  // This block's segments are rank, rank + 8, rank + 16, ...  In a
  // sub-pass, thread t reads pixels 4 (t % 64) .. 4 (t % 64) + 3 of the
  // sub-pass's segment t / 64, so warp w reads 128 consecutive pixels,
  // warps run in pixel order, and sub-pass 0 precedes sub-pass 1.
  const int segments = (num_pixels + kSegment - 1) / kSegment;
  const int own_segments =
      segments > rank ? (segments - rank + kClusterBlocks - 1) / kClusterBlocks : 0;
  const int slot = threadIdx.x / (kSegment / 4);
  const int offset = 4 * (threadIdx.x % (kSegment / 4));
  // The skip of masked-out pixels is exact only while both are finite.
  const bool keep_all = !(isfinite(background) && isfinite(clamp_t));
  const bool nan_background = background != background;
  const float miss = nan_background ? neg_inf() : background;

  float acc = 0.0f;
  int count = 0;  // pixels in the list; the same in every thread
  for (int first = 0; first < own_segments; first += kSubs * kSegmentsPerSub) {
    int p0[kSubs];
    float m[kSubs][4], d[kSubs][4];
#pragma unroll
    for (int s = 0; s < kSubs; ++s) {  // both sub-passes' loads go out first
      const int local = first + s * kSegmentsPerSub + slot;
      p0[s] = local < own_segments ? (rank + kClusterBlocks * local) * kSegment + offset
                                   : num_pixels;
      load4(mask, p0[s], num_pixels, vector_loads, m[s]);
      load4(depth, p0[s], num_pixels, vector_loads, d[s]);
    }
    bool keep[kSubs][4];
    int below[kSubs];
#pragma unroll
    for (int s = 0; s < kSubs; ++s) {
      unsigned under = 0, warp_kept = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        keep[s][k] = keep_all ? p0[s] + k < num_pixels
                              : m[s][k] != 0.0f || d[s][k] != d[s][k];  // a missing pixel reads 0, 0
        const unsigned votes = __ballot_sync(kFullMask, keep[s][k]);
        under += __popc(votes & lanes_below);
        warp_kept += __popc(votes);
      }
      below[s] = static_cast<int>(under);
      if (lane == 0) warp_counts[s][warp] = static_cast<int>(warp_kept);
    }
    __syncthreads();  // also: the spheres are staged
    int kept = 0;
#pragma unroll
    for (int s = 0; s < kSubs; ++s) {
      int pos = count + kept + below[s];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        pos += w < warp ? warp_counts[s][w] : 0;
        kept += warp_counts[s][w];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (keep[s][k]) list[pos++] = p0[s] + k;
      }
    }
    count += kept;
    __syncthreads();  // the list is written; warp_counts may be reused
    const bool last = first + kSubs * kSegmentsPerSub >= own_segments;
    if (count > kListCapacity - kPassPixels || (last && count > 0)) {
      score_list(sph, num_spheres, list, count, rays, depth, mask, clamp_t, miss,
                 nan_background, acc);
      count = 0;
      __syncthreads();  // the list may be refilled
    }
  }

  // Fixed-order block reduction: a shuffle tree in each warp, then the
  // warp sums in warp order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFullMask, acc, off);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // phase 0
  if (threadIdx.x == 0) {
    float sum = warp_sums[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += warp_sums[w];
    *cluster.map_shared_rank(&partials[rank], 0) = sum;
  }
  cluster.sync();  // phase 1: every rank's sum is in rank 0's partials
  if (rank == 0 && threadIdx.x == 0) {
    float total = partials[0];
#pragma unroll
    for (int r = 1; r < kClusterBlocks; ++r) total += partials[r];
    out[row] = total;
  }
}

}  // namespace

namespace {

cudaLaunchConfig_t launch_config(int num_clients, int num_particles, int num_spheres,
                                 cudaStream_t stream, cudaLaunchAttribute* cluster) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kClusterBlocks, num_particles, num_clients);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(num_spheres) * sizeof(float4);
  config.stream = stream;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = kClusterBlocks;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  return config;
}

}  // namespace

// Launches the kernel on `stream` for `num_clients` clients (1 for K1;
// at most 65535, as are num_particles) as clusters of 8 blocks.  `out`
// is (num_clients, num_particles).  Returns the launch's error, or
// cudaGetLastError() after it (0 on success); a cluster launch the card
// refuses returns its error and never falls back.
extern "C" int render_score_sums_launch(const float* spheres, const float* rays,
                                        const float* depth, const float* mask,
                                        float* out, int num_clients,
                                        int num_particles, int num_spheres,
                                        int num_pixels, float clamp_t,
                                        float background, void* stream) {
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t config = launch_config(
      num_clients, num_particles, num_spheres, static_cast<cudaStream_t>(stream), &cluster);
  const cudaError_t err = cudaLaunchKernelEx(
      &config, render_score_kernel, spheres, rays, depth, mask, out,
      num_particles, num_spheres, num_pixels, clamp_t, background);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// How many of the kernel's clusters the card holds at once for this
// launch shape (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int render_score_max_active_clusters(int num_particles, int num_spheres) {
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t config =
      launch_config(1, num_particles, num_spheres, nullptr, &cluster);
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, render_score_kernel, &config);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
