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
// and a miss counts as `background`.
//
// What bounds it on an H100: operations.  At the tracker's shapes
// (N = 64 particles, P = 16384 pixels, S = 48 spheres) it does ~50M
// ray/sphere tests on 2.8 KB of spheres and 256 KB of pixel data, so the
// fp32 pipes, not memory, set the floor.  The design follows from that:
//   * Each block stages one particle's spheres in shared memory as
//     (cx, cy, cz, |c|^2 - r^2); all lanes read the same sphere, so every
//     shared load is a broadcast.  Each thread keeps 4 pixels' rays in
//     registers, reusing each sphere load 4 times.
//   * The sqrt and the IEEE division run only where disc >= 0; most
//     (pixel, sphere) pairs miss, so the common path is 7 instructions
//     (5 for the dot and the discriminant, a compare, a min).
//     Built without --use_fast_math: approximate sqrt/division flip
//     silhouette pixels.  The K=3 dot is fp32 FMAs, not tensor cores.
//   * The Pallas kernel carries its sum across the sequential pixel-tile
//     grid axis.  Blocks on Hopper run in parallel, so here a (pixel
//     tile, particle, client) grid writes one partial sum per block, and
//     a second kernel adds each (client, particle)'s partials in tile
//     order.  No float atomics: repeated runs are bit-identical.
//   * K1 is the B = 1 launch.  A block's work depends on b only through
//     the offsets of its inputs, so row b of K1b equals K1 on client b
//     bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;
constexpr int kTilePixels = kThreads * kPixelsPerThread;

__global__ void __launch_bounds__(kThreads)
render_score_partial_kernel(const float* __restrict__ spheres,  // (B, N, S, 4)
                            const float* __restrict__ rays,     // (B, P, 3)
                            const float* __restrict__ depth,    // (B, P)
                            const float* __restrict__ mask,     // (B, P)
                            float* __restrict__ partial,  // (B, N, tiles)
                            int num_particles, int num_spheres,
                            int num_pixels, int tiles, float clamp_t,
                            float background) {
  extern __shared__ float4 sph[];  // (S,): cx, cy, cz, |c|^2 - r^2
  __shared__ float warp_sums[kThreads / 32];

  const int b = blockIdx.z;
  const size_t row = static_cast<size_t>(b) * num_particles + blockIdx.y;
  const int tile = blockIdx.x;
  const float* sp = spheres + row * num_spheres * 4;
  rays += static_cast<size_t>(b) * num_pixels * 3;
  depth += static_cast<size_t>(b) * num_pixels;
  mask += static_cast<size_t>(b) * num_pixels;
  for (int i = threadIdx.x; i < num_spheres; i += kThreads) {
    const float cx = sp[4 * i], cy = sp[4 * i + 1], cz = sp[4 * i + 2];
    const float r = sp[4 * i + 3];
    sph[i] = make_float4(cx, cy, cz, (cx * cx + cy * cy + cz * cz) - r * r);
  }

  // Neighbouring threads take neighbouring pixels.  Pixels past the end
  // get a well-formed ray (d_z = 1) and contribute nothing.
  float rx[kPixelsPerThread], ry[kPixelsPerThread], rz[kPixelsPerThread];
  float d2[kPixelsPerThread], dmin[kPixelsPerThread];
  const int first = tile * kTilePixels + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPixelsPerThread; ++k) {
    const int p = first + k * kThreads;
    const bool in = p < num_pixels;
    rx[k] = in ? rays[3 * p] : 0.0f;
    ry[k] = in ? rays[3 * p + 1] : 0.0f;
    rz[k] = in ? rays[3 * p + 2] : 1.0f;
    d2[k] = rx[k] * rx[k] + ry[k] * ry[k] + rz[k] * rz[k];
    dmin[k] = __int_as_float(0x7f800000);  // +inf
  }
  __syncthreads();

  for (int j = 0; j < num_spheres; ++j) {
    const float4 c = sph[j];
#pragma unroll
    for (int k = 0; k < kPixelsPerThread; ++k) {
      const float dc = rx[k] * c.x + ry[k] * c.y + rz[k] * c.z;
      const float disc = dc * dc - d2[k] * c.w;
      float t = background;
      if (disc >= 0.0f) {
        const float t_hit = (dc - sqrtf(disc)) / d2[k];
        if (t_hit > 1e-4f) t = t_hit;
      }
      dmin[k] = fminf(dmin[k], t);
    }
  }

  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kPixelsPerThread; ++k) {
    const int p = first + k * kThreads;
    if (p < num_pixels) {
      acc += fminf(fabsf(dmin[k] - depth[p]), clamp_t) * mask[p];
    }
  }

  // Fixed-order block reduction: a shuffle tree in each warp, then the
  // first warp folds the warp sums.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) partial[row * tiles + tile] = acc;
  }
}

// One thread per (client, particle) row of partial sums, added in tile
// order.
__global__ void render_score_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out, int rows,
                                           int tiles) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= rows) return;
  const float* row = partial + static_cast<size_t>(n) * tiles;
  float acc = 0.0f;
  for (int t = 0; t < tiles; ++t) acc += row[t];
  out[n] = acc;
}

}  // namespace

extern "C" int render_score_tile_pixels() { return kTilePixels; }

// Launches both kernels on `stream` for `num_clients` clients (1 for
// K1; at most 65535, as are num_particles).  `partial` is scratch of
// num_clients * num_particles * ceil(num_pixels / render_score_tile_pixels())
// floats; `out` is (num_clients, num_particles).  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int render_score_sums_launch(const float* spheres, const float* rays,
                                        const float* depth, const float* mask,
                                        float* partial, float* out,
                                        int num_clients, int num_particles,
                                        int num_spheres, int num_pixels,
                                        float clamp_t, float background,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (num_pixels + kTilePixels - 1) / kTilePixels;
  const dim3 grid(tiles, num_particles, num_clients);
  const size_t smem = static_cast<size_t>(num_spheres) * sizeof(float4);
  render_score_partial_kernel<<<grid, kThreads, smem, s>>>(
      spheres, rays, depth, mask, partial, num_particles, num_spheres,
      num_pixels, tiles, clamp_t, background);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int rows = num_clients * num_particles;
  const int reduce_threads = 128;
  render_score_reduce_kernel<<<(rows + reduce_threads - 1) / reduce_threads,
                               reduce_threads, 0, s>>>(partial, out, rows,
                                                       tiles);
  return static_cast<int>(cudaGetLastError());
}
