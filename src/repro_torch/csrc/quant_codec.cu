// The quantized half of the depth uplink's codec: uniform quantization +
// bit-packing (K6, and K6b over B clients' planes), its inverse (K7), and
// the entropy stage's per-tile significant-bit widths (K5, and K5b).
//
// Replaces the Pallas TPU kernels repro/codec/kernels.py:quantize_pack and
// quantize_pack_batched (both _quantize_pack_kernel), unpack_dequantize
// (_unpack_dequantize_kernel), and significant_bit_widths and
// significant_bit_widths_batched (both _sig_width_kernel):
//
//   K6   code  = clip(rint((clip(x, lo, hi) - lo) / step), 0, 2^bits - 1)
//        word  = OR over k < 32/bits of code[k] << (k * bits)     (LSB first)
//   K7   value = lo + code * step                                  (two roundings)
//   K5   width = bit length of the tile's max word read as uint32  (in [0, 32])
//
// What bounds them on an H100: bytes.  K6 and K7 read one plane and write
// the other, at bits 8 and 128x128 81,920 B, 0.024 us at 3.35 TB/s; K5
// reads the residual plane once (65,600 B at 128x128).  A handful of
// operations per pixel sits far below the compute bound, and at one
// 128x128 plane the launch itself costs more than either.  The design:
//   * K6/K7: one thread per packed word, on a flat grid over all B*H*W/ratio
//     words.  Since W is a multiple of the pack ratio, word i holds pixels
//     [i*ratio, (i+1)*ratio) of the flat plane: neighbouring threads touch
//     neighbouring addresses, and where the ratio is a multiple of 4 and
//     the plane 16-byte aligned they move 16-byte vectors.  A word depends
//     only on its own pixels, so the reference's zero-padding to (8, 128)
//     tiles never reaches a kept word; nothing is padded here.
//   * K5: one block per (block_h, block_w) tile, an unsigned max in
//     registers, __reduce_max_sync across each warp, one shared-memory
//     pass across warps, and 32 - __clz(m) (__clz(0) = 32, so a zero
//     tile reads 0).  The ragged edge is masked: a padded word would be 0
//     and change no max.
//   * Rounding is the reference oracle's (codec/ref.py), bit for bit:
//     __fsub_rn, a true division __fdiv_rn (never a reciprocal multiply,
//     which moves half-step ties), rintf (half to even) after the clip,
//     and the dequantization as __fmul_rn then __fadd_rn, so nvcc cannot
//     contract it into a fused multiply-add.  fmaxf/fminf send a NaN pixel
//     to lo, which gives code 0, as the reference's saturating cast does;
//     +-inf clip to the ends of the range.
//   * K6/K5 with one client are the B = 1 launches of K6b/K5b: row b of a
//     batched call equals the single call on that plane bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t quantize(float x, float lo, float hi,
                                             float step, float top) {
  x = fminf(fmaxf(x, lo), hi);  // NaN -> lo
  float q = rintf(__fdiv_rn(__fsub_rn(x, lo), step));
  q = fminf(fmaxf(q, 0.0f), top);
  return static_cast<uint32_t>(q);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ x, int* __restrict__ words,
                     int n_words, float lo, float hi, float step, bool vec4) {
  constexpr int kRatio = 32 / BITS;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_words) return;
  const float top = static_cast<float>((1u << BITS) - 1u);
  const float* px = x + static_cast<size_t>(i) * kRatio;
  uint32_t word = 0;
  if constexpr (kRatio % 4 == 0) {
    if (vec4) {
      const float4* p4 = reinterpret_cast<const float4*>(px);
#pragma unroll
      for (int v = 0; v < kRatio / 4; ++v) {
        const float4 f = p4[v];
        word |= quantize(f.x, lo, hi, step, top) << ((4 * v + 0) * BITS);
        word |= quantize(f.y, lo, hi, step, top) << ((4 * v + 1) * BITS);
        word |= quantize(f.z, lo, hi, step, top) << ((4 * v + 2) * BITS);
        word |= quantize(f.w, lo, hi, step, top) << ((4 * v + 3) * BITS);
      }
      words[i] = static_cast<int>(word);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kRatio; ++k) {
    word |= quantize(px[k], lo, hi, step, top) << (k * BITS);
  }
  words[i] = static_cast<int>(word);
}

__device__ __forceinline__ float dequantize(uint32_t code, float lo, float step) {
  return __fadd_rn(lo, __fmul_rn(static_cast<float>(code), step));
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
unpack_dequantize_kernel(const int* __restrict__ words, float* __restrict__ out,
                         int n_words, float lo, float step, bool vec4) {
  constexpr int kRatio = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_words) return;
  const uint32_t word = static_cast<uint32_t>(words[i]);
  float* po = out + static_cast<size_t>(i) * kRatio;
  if constexpr (kRatio % 4 == 0) {
    if (vec4) {
      float4* p4 = reinterpret_cast<float4*>(po);
#pragma unroll
      for (int v = 0; v < kRatio / 4; ++v) {
        float4 f;
        f.x = dequantize((word >> ((4 * v + 0) * BITS)) & kMask, lo, step);
        f.y = dequantize((word >> ((4 * v + 1) * BITS)) & kMask, lo, step);
        f.z = dequantize((word >> ((4 * v + 2) * BITS)) & kMask, lo, step);
        f.w = dequantize((word >> ((4 * v + 3) * BITS)) & kMask, lo, step);
        p4[v] = f;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kRatio; ++k) {
    po[k] = dequantize((word >> (k * BITS)) & kMask, lo, step);
  }
}

__global__ void __launch_bounds__(kThreads)
sig_width_kernel(const int* __restrict__ words,  // (B, H, W)
                 int* __restrict__ widths,       // (B, tiles_h, tiles_w)
                 int height, int width, int block_h, int block_w,
                 int tiles_h, int tiles_w) {
  __shared__ uint32_t warp_max[kThreads / 32];

  const int tiles = tiles_h * tiles_w;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int row0 = (tile / tiles_w) * block_h;
  const int col0 = (tile % tiles_w) * block_w;
  const uint32_t* d = reinterpret_cast<const uint32_t*>(words) +
                      static_cast<size_t>(b) * height * width;
  const int rows = min(block_h, height - row0);
  const int cols = min(block_w, width - col0);
  const int n = rows * cols;

  uint32_t m = 0;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    m = max(m, d[static_cast<size_t>(row0 + k / cols) * width + col0 + k % cols]);
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    widths[static_cast<size_t>(b) * tiles + tile] = 32 - __clz(static_cast<int>(m));
  }
}

template <int BITS>
cudaError_t launch_quantize(const float* x, int* words, int n_words, float lo,
                            float hi, float step, cudaStream_t stream) {
  const bool vec4 = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  quantize_pack_kernel<BITS><<<(n_words + kThreads - 1) / kThreads, kThreads, 0,
                               stream>>>(x, words, n_words, lo, hi, step, vec4);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_dequantize(const int* words, float* out, int n_words, float lo,
                              float step, cudaStream_t stream) {
  const bool vec4 = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  unpack_dequantize_kernel<BITS><<<(n_words + kThreads - 1) / kThreads, kThreads,
                                   0, stream>>>(words, out, n_words, lo, step, vec4);
  return cudaGetLastError();
}

}  // namespace

// K6 (one plane) and K6b (B planes) on `stream`: n_words packed words from
// n_words * 32 / bits pixels.  The caller keeps the pixel count below 2^31.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for bits outside
// {1, 2, 4, 8, 16}.
extern "C" int quantize_pack_launch(const float* x, int* words, int n_words,
                                    int bits, float lo, float hi, float step,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch_quantize<1>(x, words, n_words, lo, hi, step, s);
    case 2: return launch_quantize<2>(x, words, n_words, lo, hi, step, s);
    case 4: return launch_quantize<4>(x, words, n_words, lo, hi, step, s);
    case 8: return launch_quantize<8>(x, words, n_words, lo, hi, step, s);
    case 16: return launch_quantize<16>(x, words, n_words, lo, hi, step, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7 over n_words words on `stream`, writing n_words * 32 / bits floats.
extern "C" int unpack_dequantize_launch(const int* words, float* out, int n_words,
                                        int bits, float lo, float step,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch_dequantize<1>(words, out, n_words, lo, step, s);
    case 2: return launch_dequantize<2>(words, out, n_words, lo, step, s);
    case 4: return launch_dequantize<4>(words, out, n_words, lo, step, s);
    case 8: return launch_dequantize<8>(words, out, n_words, lo, step, s);
    case 16: return launch_dequantize<16>(words, out, n_words, lo, step, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K5 (num_planes = 1) and K5b on `stream`: one width per tile of the
// ceil(height / block_h) x ceil(width / block_w) grid of each plane.  The
// caller keeps num_planes * tiles below 2^31.  Returns cudaGetLastError().
extern "C" int significant_bit_widths_launch(const int* words, int* widths,
                                             int num_planes, int height, int width,
                                             int block_h, int block_w,
                                             void* stream) {
  const int tiles_h = (height + block_h - 1) / block_h;
  const int tiles_w = (width + block_w - 1) / block_w;
  sig_width_kernel<<<num_planes * tiles_h * tiles_w, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      words, widths, height, width, block_h, block_w, tiles_h, tiles_w);
  return static_cast<int>(cudaGetLastError());
}
