// Temporal delta codec of the depth uplink: per-tile change mask + XOR of
// the float32 bit patterns (K3, and K3b over B clients' frames), and its
// inverse (K4).
//
// Replaces the Pallas TPU kernels repro/codec/kernels.py:delta_encode,
// delta_encode_batched (both _delta_encode_kernel) and delta_decode
// (_delta_decode_kernel).  For each (block_h, block_w) tile of each
// client's (H, W) plane:
//
//   changed = max |f - r| > threshold
//   delta   = changed ? bits(f) XOR bits(r) : 0       (int32)
//   mask    = changed ? 1.0f : 0.0f                   (one float per tile)
//
// and the decode is out = float(bits(r) XOR delta), one word at a time.
//
// What bounds them on an H100: bytes (two float planes read, one int
// plane written, a handful of integer and compare operations per word),
// and at one 128x128 plane the launch itself.  The design:
//   * One block per tile (8x128 by default, 4 KB of each input); its
//     threads take neighbouring columns, so loads and stores coalesce.
//     The block reads the tile once for the max and once more for the
//     XOR; the second read hits L1/L2.
//   * The max propagates NaN as jnp.max does (CUDA's fmaxf drops it):
//     a tile holding a NaN compares NaN > threshold, which is false, so
//     it stays unchanged.  |-0.0 - +0.0| is 0, so a tile that differs
//     only in the sign of a zero stays unchanged too.  The test is a
//     strict >.
//   * The reference zero-pads the plane to whole tiles.  Here the block
//     masks the ragged edge instead: a padded pixel has |0 - 0| = 0,
//     which cannot raise a max of absolute values, so the masks are the
//     same, and the delta is written straight at (H, W).
//   * K3 is the B = 1 launch of the same kernel: row b of K3b equals K3
//     on client b bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDecodeThreads = 256;

// max(m, a) that keeps a NaN from either side, as jnp.max does.
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

__global__ void __launch_bounds__(kThreads)
delta_encode_kernel(const float* __restrict__ frames,  // (B, H, W)
                    const float* __restrict__ refs,    // (B, H, W)
                    int* __restrict__ delta,           // (B, H, W)
                    float* __restrict__ mask,          // (B, tiles_h, tiles_w)
                    int height, int width, int block_h, int block_w,
                    int tiles_h, int tiles_w, float threshold) {
  __shared__ float warp_max[kThreads / 32];
  __shared__ int changed_s;

  const int tiles = tiles_h * tiles_w;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int row0 = (tile / tiles_w) * block_h;
  const int col0 = (tile % tiles_w) * block_w;
  const size_t plane = static_cast<size_t>(b) * height * width;
  const float* f = frames + plane;
  const float* r = refs + plane;
  const int rows = min(block_h, height - row0);
  const int cols = min(block_w, width - col0);
  const int pixels = rows * cols;

  float m = 0.0f;  // every |f - r| is >= 0 or NaN
  for (int k = threadIdx.x; k < pixels; k += kThreads) {
    const size_t idx = static_cast<size_t>(row0 + k / cols) * width + col0 + k % cols;
    m = nan_max(m, fabsf(f[idx] - r[idx]));
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
    const bool changed = m > threshold;  // false for NaN
    changed_s = changed;
    mask[static_cast<size_t>(b) * tiles + tile] = changed ? 1.0f : 0.0f;
  }
  __syncthreads();

  const bool changed = changed_s;
  int* d = delta + plane;
  for (int k = threadIdx.x; k < pixels; k += kThreads) {
    const size_t idx = static_cast<size_t>(row0 + k / cols) * width + col0 + k % cols;
    d[idx] = changed ? (__float_as_int(f[idx]) ^ __float_as_int(r[idx])) : 0;
  }
}

__global__ void __launch_bounds__(kDecodeThreads)
delta_decode_kernel(const int* __restrict__ delta, const float* __restrict__ ref,
                    float* __restrict__ out, int n) {
  const int i = blockIdx.x * kDecodeThreads + threadIdx.x;
  if (i < n) out[i] = __int_as_float(__float_as_int(ref[i]) ^ delta[i]);
}

}  // namespace

// K3 (num_clients = 1) and K3b on `stream`.  The tile grid is
// ceil(height / block_h) x ceil(width / block_w) per client; the caller
// keeps num_clients * tiles below 2^31.  Returns cudaGetLastError().
extern "C" int delta_encode_launch(const float* frames, const float* refs,
                                   int* delta, float* mask, int num_clients,
                                   int height, int width, int block_h,
                                   int block_w, float threshold, void* stream) {
  const int tiles_h = (height + block_h - 1) / block_h;
  const int tiles_w = (width + block_w - 1) / block_w;
  delta_encode_kernel<<<num_clients * tiles_h * tiles_w, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      frames, refs, delta, mask, height, width, block_h, block_w, tiles_h,
      tiles_w, threshold);
  return static_cast<int>(cudaGetLastError());
}

// K4 over n words on `stream`.  Returns cudaGetLastError().
extern "C" int delta_decode_launch(const int* delta, const float* ref,
                                   float* out, int n, void* stream) {
  delta_decode_kernel<<<(n + kDecodeThreads - 1) / kDecodeThreads,
                        kDecodeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      delta, ref, out, n);
  return static_cast<int>(cudaGetLastError());
}
