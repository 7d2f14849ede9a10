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
//   * A keyframe launch (recon != nullptr) is K6 built with a second store:
//     each thread dequantizes the codes it just packed, from registers, as
//     K7 does, and writes K7's values of its word (float4 stores on the
//     vector path).  The closed loop's next reference comes from the same
//     launch as the words; K7 does not run.
//   * K5: one warp per (block_h, block_w) tile and one tile a block, no
//     shared memory and no barrier.  Rows go in batches of kRowsInFlight
//     outside a lane-strided column loop, which replaces per-word
//     division; a lane loads a batch's words of its column into registers
//     before their max, so they are in flight together (an 8x128 tile is
//     4 batches of 8 loads a lane); then one __reduce_max_sync over the
//     unsigned words and 32 - __clz(m) (__clz(0) = 32, so a zero tile
//     reads 0).  The ragged edge is masked: a padded word would be 0 and
//     change no max.  The max of unsigned words does not depend on order.
//   * Rounding is the reference oracle's (codec/ref.py), bit for bit:
//     __fsub_rn, a true division __fdiv_rn (never a reciprocal multiply,
//     which moves half-step ties), rintf (half to even) after the clip,
//     and the dequantization as __fmul_rn then __fadd_rn, so nvcc cannot
//     contract it into a fused multiply-add.  fmaxf/fminf send a NaN pixel
//     to lo, which gives code 0, as the reference's saturating cast does;
//     +-inf clip to the ends of the range.
//   * K6/K5 with one client are the B = 1 launches of K6b/K5b: row b of a
//     batched call equals the single call on that plane bit for bit.
//
// The quantized wire format (wire.encode_frame/decode_frame) runs two more
// kernels here, K7's dequantization fused into the launches around it:
//
//   encode  words = K6(frame)
//           mask  = nan_max over the tile of |K7(K6(frame)) - K7(K6(ref))|
//                   > threshold (the caller's float32 step/2)
//   decode  out   = mask > 0 ? K7(words) : ref            (per tile)
//
// They replace five launches (K6, K7, K6, K7, then K3's mask-only launch)
// and K7 plus four eager ops of the mask select.  Each is one block per
// (block_h, block_w) tile, and neither dequantized plane reaches device
// memory.  At one 128x128 plane each is bound by the launch, as K6 and
// K7 are; their bytes at bits 8 are 147,520 B (0.044 us at 3.35 TB/s).
//   * The encode takes whole tiles only (the wrapper checks, as the
//     reference's encode_frame does).  On its vector path (plane and tile
//     widths multiples of 4 and of the pack ratio, planes 16-byte aligned)
//     a thread loads one float4 of each plane per 1,024-pixel chunk,
//     quantizes and dequantizes both in registers and packs its 4 codes:
//     one word at bits 8, two words in one 8-byte store at bits 16, and at
//     bits 4, 2 and 1 a part of a word that the 2, 4 or 8 lanes sharing
//     the word OR together with __shfl_xor_sync.  Every other launch takes
//     the scalar path, one word a thread: a block writes the words whose
//     first pixel lies in its tile, reading the pixels of a word that
//     straddles the tile's right edge (block_w not a multiple of the
//     ratio) from the next tile, and adds to its max only its own pixels,
//     the few at a row's start that belong to the word before included.
//     The max is K3's: nan_max, shuffles in each warp, one shared-memory
//     step, and the strict > (false for NaN).
//   * The decode reads the tile's mask value once (mask > 0, so a NaN
//     mask keeps the reference, as the reference's where does), then on
//     that block-uniform branch either dequantizes the tile's words or
//     copies the reference's bits; neither reads the other's input.  The
//     mask is indexed with its own strides, so any mask that covers the
//     tile grid decodes as the reference's cropped repeat does.  Ragged
//     edge tiles are masked; the vector rule is K3's.

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

__device__ __forceinline__ float dequantize(uint32_t code, float lo, float step) {
  return __fadd_rn(lo, __fmul_rn(static_cast<float>(code), step));
}

template <int BITS, bool kWriteRecon = false>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ x, int* __restrict__ words,
                     float* __restrict__ recon,  // K7's values; if kWriteRecon
                     int n_words, float lo, float hi, float step, bool vec4) {
  constexpr int kRatio = 32 / BITS;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_words) return;
  const float top = static_cast<float>((1u << BITS) - 1u);
  const float* px = x + static_cast<size_t>(i) * kRatio;
  float* pr = recon + static_cast<size_t>(i) * kRatio;
  uint32_t word = 0;
  if constexpr (kRatio % 4 == 0) {
    if (vec4) {
      const float4* p4 = reinterpret_cast<const float4*>(px);
#pragma unroll
      for (int v = 0; v < kRatio / 4; ++v) {
        const float4 f = p4[v];
        const uint32_t c0 = quantize(f.x, lo, hi, step, top);
        const uint32_t c1 = quantize(f.y, lo, hi, step, top);
        const uint32_t c2 = quantize(f.z, lo, hi, step, top);
        const uint32_t c3 = quantize(f.w, lo, hi, step, top);
        word |= c0 << ((4 * v + 0) * BITS);
        word |= c1 << ((4 * v + 1) * BITS);
        word |= c2 << ((4 * v + 2) * BITS);
        word |= c3 << ((4 * v + 3) * BITS);
        if constexpr (kWriteRecon) {
          reinterpret_cast<float4*>(pr)[v] =
              make_float4(dequantize(c0, lo, step), dequantize(c1, lo, step),
                          dequantize(c2, lo, step), dequantize(c3, lo, step));
        }
      }
      words[i] = static_cast<int>(word);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kRatio; ++k) {
    const uint32_t c = quantize(px[k], lo, hi, step, top);
    word |= c << (k * BITS);
    if constexpr (kWriteRecon) pr[k] = dequantize(c, lo, step);
  }
  words[i] = static_cast<int>(word);
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

constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4 * kThreads;  // tile pixels a block handles in one pass

// max(m, a) that keeps a NaN from either side, as jnp.max does.
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

// |K7(cf) - K7(cr)|, the value-space gap of two codes, as K3 takes it.
__device__ __forceinline__ float code_gap(uint32_t cf, uint32_t cr, float lo, float step) {
  return fabsf(__fsub_rn(dequantize(cf, lo, step), dequantize(cr, lo, step)));
}

// The block's nan_max of every thread's m, valid in thread 0.
__device__ __forceinline__ float block_nan_max(float m, float (&warp_max)[kWarps]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_down_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = nan_max(m, warp_max[w]);
  return m;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quant_encode_kernel(const float* __restrict__ frame,  // (H, W), whole tiles
                    const float* __restrict__ ref,    // (H, W)
                    int* __restrict__ words,          // (H, W / ratio)
                    float* __restrict__ mask,         // (H / block_h, W / block_w)
                    int width, int block_h, int block_w, int tiles_w, float lo,
                    float hi, float step, float threshold, bool vector) {
  constexpr int kRatio = 32 / BITS;
  __shared__ float warp_max[kWarps];

  const int row0 = (blockIdx.x / tiles_w) * block_h;
  const int col0 = (blockIdx.x % tiles_w) * block_w;
  const float top = static_cast<float>((1u << BITS) - 1u);
  float m = 0.0f;  // every gap is >= 0
  if (vector) {
    const int pixels = block_h * block_w;
    for (int first = 0; first < pixels; first += kChunk) {
      const int k = first + 4 * static_cast<int>(threadIdx.x);
      const bool in = k < pixels;
      const int off = in ? (row0 + k / block_w) * width + col0 + k % block_w : 0;
      uint32_t cf[4] = {0u, 0u, 0u, 0u};
      if (in) {
        const float4 a = *reinterpret_cast<const float4*>(frame + off);
        const float4 c = *reinterpret_cast<const float4*>(ref + off);
        const float fv[4] = {a.x, a.y, a.z, a.w};
        const float rv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cf[j] = quantize(fv[j], lo, hi, step, top);
          m = nan_max(m, code_gap(cf[j], quantize(rv[j], lo, hi, step, top), lo, step));
        }
      }
      if constexpr (kRatio == 2) {
        if (in) {
          *reinterpret_cast<int2*>(words + off / 2) =
              make_int2(static_cast<int>(cf[0] | (cf[1] << 16)),
                        static_cast<int>(cf[2] | (cf[3] << 16)));
        }
      } else {
        // this thread's 4 codes in their place in the word; off % kRatio
        // is the pixel's column in the word, as W is a multiple of kRatio
        const int shift = (off % kRatio) * BITS;
        uint32_t part = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) part |= cf[j] << (shift + j * BITS);
        // the kRatio / 4 lanes of one word are neighbours, aligned, and all
        // in or all out of the tile (its width is a multiple of kRatio)
#pragma unroll
        for (int s = 1; s < kRatio / 4; s <<= 1) part |= __shfl_xor_sync(0xffffffffu, part, s);
        if (in && shift == 0) words[off / kRatio] = static_cast<int>(part);
      }
    }
  } else {
    const int words_per_row = width / kRatio;
    const int first = (col0 + kRatio - 1) / kRatio;  // the first word starting in the tile
    const int count = (col0 + block_w + kRatio - 1) / kRatio - first;
    const int head = min(first * kRatio - col0, block_w);  // the word before's pixels
    for (int k = threadIdx.x; k < block_h * head; k += kThreads) {
      const int off = (row0 + k / head) * width + col0 + k % head;
      m = nan_max(m, code_gap(quantize(frame[off], lo, hi, step, top),
                              quantize(ref[off], lo, hi, step, top), lo, step));
    }
    for (int q = threadIdx.x; q < block_h * count; q += kThreads) {
      const int row = row0 + q / count;
      const int word = first + q % count;
      const int off = row * width + word * kRatio;
      const int mine = min(kRatio, col0 + block_w - word * kRatio);  // pixels in the tile
      uint32_t packed = 0;
#pragma unroll
      for (int i = 0; i < kRatio; ++i) {
        const uint32_t c = quantize(frame[off + i], lo, hi, step, top);
        packed |= c << (i * BITS);
        if (i < mine) {
          m = nan_max(m, code_gap(c, quantize(ref[off + i], lo, hi, step, top), lo, step));
        }
      }
      words[row * words_per_row + word] = static_cast<int>(packed);
    }
  }
  m = block_nan_max(m, warp_max);
  if (threadIdx.x == 0) mask[blockIdx.x] = m > threshold ? 1.0f : 0.0f;  // false for NaN
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
quant_decode_kernel(const int* __restrict__ words,  // (H, W / ratio)
                    const float* __restrict__ mask,  // covers the tile grid
                    const int* __restrict__ ref,     // (H, W) float bits
                    int* __restrict__ out,           // (H, W) float bits
                    int height, int width, int block_h, int block_w, int tiles_w,
                    int mask_row_stride, int mask_col_stride, float lo, float step,
                    bool vector) {
  constexpr int kRatio = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const int tile_row = blockIdx.x / tiles_w;
  const int tile_col = blockIdx.x % tiles_w;
  const int row0 = tile_row * block_h;
  const int col0 = tile_col * block_w;
  const int cols = min(block_w, width - col0);
  const int pixels = min(block_h, height - row0) * cols;
  const bool changed = mask[tile_row * mask_row_stride + tile_col * mask_col_stride] > 0.0f;
  if (vector) {
    for (int k = 4 * static_cast<int>(threadIdx.x); k < pixels; k += kChunk) {
      const int off = (row0 + k / cols) * width + col0 + k % cols;
      int4 v;
      if (!changed) {
        v = *reinterpret_cast<const int4*>(ref + off);
      } else if constexpr (kRatio == 2) {
        const int2 w = *reinterpret_cast<const int2*>(words + off / 2);
        const uint32_t lo_word = static_cast<uint32_t>(w.x);
        const uint32_t hi_word = static_cast<uint32_t>(w.y);
        v = make_int4(__float_as_int(dequantize(lo_word & kMask, lo, step)),
                      __float_as_int(dequantize(lo_word >> 16, lo, step)),
                      __float_as_int(dequantize(hi_word & kMask, lo, step)),
                      __float_as_int(dequantize(hi_word >> 16, lo, step)));
      } else {
        // 4 neighbouring codes of one word (off is a multiple of 4)
        const uint32_t w = static_cast<uint32_t>(words[off / kRatio]);
        const int shift = (off % kRatio) * BITS;
        v = make_int4(__float_as_int(dequantize((w >> shift) & kMask, lo, step)),
                      __float_as_int(dequantize((w >> (shift + BITS)) & kMask, lo, step)),
                      __float_as_int(dequantize((w >> (shift + 2 * BITS)) & kMask, lo, step)),
                      __float_as_int(dequantize((w >> (shift + 3 * BITS)) & kMask, lo, step)));
      }
      *reinterpret_cast<int4*>(out + off) = v;
    }
  } else {
    for (int k = threadIdx.x; k < pixels; k += kThreads) {
      const int off = (row0 + k / cols) * width + col0 + k % cols;
      if (changed) {
        const uint32_t w = static_cast<uint32_t>(words[off / kRatio]);
        out[off] = __float_as_int(dequantize((w >> ((off % kRatio) * BITS)) & kMask, lo, step));
      } else {
        out[off] = ref[off];
      }
    }
  }
}

constexpr int kRowsInFlight = 8;  // K5's rows a lane loads before their max

// K5b (K5 at B = 1): one warp per tile of each plane, one tile a block.
// Block t of the flat (B, tiles_h, tiles_w) grid writes widths[t].
__global__ void __launch_bounds__(32)
sig_width_kernel(const int* __restrict__ words,  // (B, H, W)
                 int* __restrict__ widths,       // (B, tiles_h, tiles_w)
                 int height, int width, int block_h, int block_w, int tiles_h,
                 int tiles_w) {
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int tiles = tiles_h * tiles_w;
  const int b = t / tiles;
  const int tile = t % tiles;
  const int row0 = (tile / tiles_w) * block_h;
  const int col0 = (tile % tiles_w) * block_w;
  const int rows = min(block_h, height - row0);
  const int cols = min(block_w, width - col0);
  const uint32_t* d = reinterpret_cast<const uint32_t*>(words) +
                      (static_cast<size_t>(b) * height + row0) * width + col0;

  uint32_t m = 0;
  for (int r = 0; r < rows; r += kRowsInFlight) {
    const uint32_t* batch = d + static_cast<size_t>(r) * width;
    for (int c = lane; c < cols; c += 32) {
      uint32_t v[kRowsInFlight];
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        v[j] = r + j < rows ? batch[static_cast<size_t>(j) * width + c] : 0u;
      }
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) m = max(m, v[j]);
    }
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) widths[t] = 32 - __clz(static_cast<int>(m));
}

template <int BITS>
cudaError_t launch_quantize(const float* x, int* words, float* recon, int n_words, float lo,
                            float hi, float step, cudaStream_t stream) {
  const bool vec4 = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(recon)) &
                     15) == 0;
  const int blocks = (n_words + kThreads - 1) / kThreads;
  if (recon != nullptr) {
    quantize_pack_kernel<BITS, true><<<blocks, kThreads, 0, stream>>>(x, words, recon, n_words,
                                                                      lo, hi, step, vec4);
  } else {
    quantize_pack_kernel<BITS><<<blocks, kThreads, 0, stream>>>(x, words, recon, n_words, lo,
                                                                hi, step, vec4);
  }
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

template <int BITS>
cudaError_t launch_encode(const float* frame, const float* ref, int* words, float* mask,
                          int height, int width, int block_h, int block_w, float lo,
                          float hi, float step, float threshold, cudaStream_t stream) {
  constexpr int kRatio = 32 / BITS;
  if (height % block_h != 0 || width % block_w != 0 || width % kRatio != 0) {
    return cudaErrorInvalidValue;
  }
  const uintptr_t planes = reinterpret_cast<uintptr_t>(frame) | reinterpret_cast<uintptr_t>(ref);
  const bool vector = width % 4 == 0 && block_w % 4 == 0 && block_w % kRatio == 0 &&
                      (planes & 15) == 0 && (reinterpret_cast<uintptr_t>(words) & 7) == 0;
  const int tiles_w = width / block_w;
  quant_encode_kernel<BITS><<<(height / block_h) * tiles_w, kThreads, 0, stream>>>(
      frame, ref, words, mask, width, block_h, block_w, tiles_w, lo, hi, step, threshold,
      vector);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_decode(const int* words, const float* mask, const float* ref,
                          float* out, int height, int width, int block_h, int block_w,
                          int mask_row_stride, int mask_col_stride, float lo, float step,
                          cudaStream_t stream) {
  if (width % (32 / BITS) != 0) return cudaErrorInvalidValue;
  const uintptr_t planes = reinterpret_cast<uintptr_t>(ref) | reinterpret_cast<uintptr_t>(out);
  const bool vector = width % 4 == 0 && block_w % 4 == 0 && (planes & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(words) & 7) == 0;
  const int tiles_w = (width + block_w - 1) / block_w;
  const int tiles_h = (height + block_h - 1) / block_h;
  quant_decode_kernel<BITS><<<tiles_h * tiles_w, kThreads, 0, stream>>>(
      words, mask, reinterpret_cast<const int*>(ref), reinterpret_cast<int*>(out), height,
      width, block_h, block_w, tiles_w, mask_row_stride, mask_col_stride, lo, step, vector);
  return cudaGetLastError();
}

}  // namespace

// K6 (one plane) and K6b (B planes) on `stream`: n_words packed words from
// n_words * 32 / bits pixels; unless recon is null, also K7's values of
// those words into recon (the keyframe launch).  The caller keeps the pixel
// count below 2^31.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for bits outside {1, 2, 4, 8, 16}.
extern "C" int quantize_pack_launch(const float* x, int* words, float* recon, int n_words,
                                    int bits, float lo, float hi, float step,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch_quantize<1>(x, words, recon, n_words, lo, hi, step, s);
    case 2: return launch_quantize<2>(x, words, recon, n_words, lo, hi, step, s);
    case 4: return launch_quantize<4>(x, words, recon, n_words, lo, hi, step, s);
    case 8: return launch_quantize<8>(x, words, recon, n_words, lo, hi, step, s);
    case 16: return launch_quantize<16>(x, words, recon, n_words, lo, hi, step, s);
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
// ceil(height / block_h) x ceil(width / block_w) grid of each plane, one
// warp a tile.  The caller keeps num_planes * height * width below 2^31.
// Returns cudaGetLastError().
extern "C" int significant_bit_widths_launch(const int* words, int* widths,
                                             int num_planes, int height, int width,
                                             int block_h, int block_w, void* stream) {
  const int tiles_h = (height + block_h - 1) / block_h;
  const int tiles_w = (width + block_w - 1) / block_w;
  sig_width_kernel<<<num_planes * tiles_h * tiles_w, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      words, widths, height, width, block_h, block_w, tiles_h, tiles_w);
  return cudaGetLastError();
}

// wire.encode_frame's one launch on `stream`: the words of the (height,
// width) frame and the change mask of its whole (block_h, block_w) tiles
// against ref, at `threshold` in value space.  Returns
// cudaErrorInvalidValue for a plane that is not whole tiles or bits
// outside {1, 2, 4, 8, 16}, else cudaGetLastError().  The caller keeps
// height * width below 2^31.
extern "C" int quant_encode_launch(const float* frame, const float* ref, int* words,
                                   float* mask, int height, int width, int block_h,
                                   int block_w, int bits, float lo, float hi, float step,
                                   float threshold, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ENCODE(B)                                                            \
  launch_encode<B>(frame, ref, words, mask, height, width, block_h, block_w, lo, hi, \
                   step, threshold, s)
  switch (bits) {
    case 1: return REPRO_ENCODE(1);
    case 2: return REPRO_ENCODE(2);
    case 4: return REPRO_ENCODE(4);
    case 8: return REPRO_ENCODE(8);
    case 16: return REPRO_ENCODE(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_ENCODE
}

// wire.decode_frame's one launch on `stream`: out (height, width) takes
// the dequantized words on the tiles whose mask value is > 0 and ref's
// bits elsewhere.  The mask, read at [i * mask_row_stride + j *
// mask_col_stride] for tile (i, j), covers the ceil(height / block_h) x
// ceil(width / block_w) grid.  Returns cudaErrorInvalidValue for bits
// outside {1, 2, 4, 8, 16} or a width not a multiple of 32 / bits, else
// cudaGetLastError().
extern "C" int quant_decode_launch(const int* words, const float* mask, const float* ref,
                                   float* out, int height, int width, int block_h,
                                   int block_w, int mask_row_stride, int mask_col_stride,
                                   int bits, float lo, float step, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_DECODE(B)                                                           \
  launch_decode<B>(words, mask, ref, out, height, width, block_h, block_w,         \
                   mask_row_stride, mask_col_stride, lo, step, s)
  switch (bits) {
    case 1: return REPRO_DECODE(1);
    case 2: return REPRO_DECODE(2);
    case 4: return REPRO_DECODE(4);
    case 8: return REPRO_DECODE(8);
    case 16: return REPRO_DECODE(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE
}
