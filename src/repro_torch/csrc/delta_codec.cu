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
// and at one 128x128 plane the launch itself.  The encode's design:
//   * One block of 256 threads per tile (8x128 by default, 4 KB of each
//     input).  Each thread loads its share of the tile once, into
//     registers: on the vector path one float4 of the frame and one of
//     the reference, both issued before either is used, and the XOR is
//     stored from the same registers with one 16-byte store.  The vector
//     path takes a launch whose width and tile width are multiples of 4
//     and whose planes are 16-byte aligned (so every tile's rows start on
//     a float4, the ragged last column of tiles included); any other
//     launch takes the scalar path, 4 pixels a thread strided by the
//     block's width.  A thread computes its row and column once per 4
//     pixels on the vector path.  A tile of more than 1,024 pixels is
//     read in chunks of 1,024, and a chunk after the first is read again
//     for the XOR.
//   * The tile max: nan_max over the thread's pixels, shuffles in each
//     warp, and one shared-memory step in which every thread reads the 8
//     warp maxima, so the store of the XOR needs no second barrier.
//   * The max propagates NaN as jnp.max does (CUDA's fmaxf drops it):
//     a tile holding a NaN compares NaN > threshold, which is false, so
//     it stays unchanged.  |-0.0 - +0.0| is 0, so a tile that differs
//     only in the sign of a zero stays unchanged too.  The test is a
//     strict >.
//   * The reference zero-pads the plane to whole tiles.  Here the block
//     masks the ragged edge instead: a padded pixel has |0 - 0| = 0,
//     which cannot raise a max of absolute values, so the masks are the
//     same, and the delta is written straight at (H, W).
//   * A mask-only launch (delta == nullptr) is the same kernel built
//     without the XOR's store: a caller that reads only the mask
//     (wire.change_density) moves two planes instead of three.
//   * A launch with a reconstruction (recon != nullptr) is the same kernel
//     built with a second store from the same registers: changed ? bits(f)
//     : bits(r), which is K4's decode of this delta against r bit for bit
//     (NaN payloads and signed zeros included, as the bits are stored, not
//     floats).  The stream encoder's closed loop takes its next reference
//     from it instead of launching K4.
//   * A launch with widths (widths != nullptr, with a delta) is the same
//     kernel built with K5's work: each thread keeps the unsigned max of
//     the XOR words it computes, in the same pass as the tile max, carried
//     through the same barrier beside it, and thread 0 writes changed ? 32
//     - __clz(max) : 0, the bit length of the tile's largest stored delta
//     word (0 on an unchanged tile, whose stored delta is 0 even where the
//     XOR is not: a signed-zero or a NaN tile).  The entropy stage takes
//     the residual and its widths from one launch instead of K3 then K5.
//   * Each output is a template flag: the launches without it compile to
//     the code they had without the flag.
//   * K3 is the B = 1 launch of the same kernel: row b of K3b equals K3
//     on client b bit for bit.
//
// K4 is one word a thread.  At the port's 128x128 planes it runs at the
// card's floor for a launch; a 16-byte vector body was slower there and
// faster only on planes of 240x320 and up, which no path runs.  A second
// output (out2 != nullptr) receives the same bits: the stream decoder's
// state and the copy it hands out, from one read of the inputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4 * kThreads;  // tile pixels a block holds in registers
constexpr int kDecodeThreads = 256;

// max(m, a) that keeps a NaN from either side, as jnp.max does.
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

// Where this thread's 4 pixels of the tile chunk starting at pixel
// `first` (in the tile's row-major order) lie in the plane; -1 for a
// pixel past the tile's end.  Vector path: pixels first + 4t .. + 3, one
// row (the tile's width is a multiple of 4), so only off[0] is set.
// Scalar path: pixels first + t + j * kThreads.
__device__ __forceinline__ void chunk_offsets(int first, int pixels, int cols, int width,
                                              int row0, int col0, bool vector, int (&off)[4]) {
  if (vector) {
    const int k = first + 4 * static_cast<int>(threadIdx.x);
    off[0] = k < pixels ? (row0 + k / cols) * width + col0 + k % cols : -1;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = first + static_cast<int>(threadIdx.x) + j * kThreads;
      off[j] = k < pixels ? (row0 + k / cols) * width + col0 + k % cols : -1;
    }
  }
}

// The chunk's frame and reference values; a pixel past the tile reads
// 0, 0, which cannot raise the max.
__device__ __forceinline__ void load_chunk(const float* __restrict__ f,
                                           const float* __restrict__ r, const int (&off)[4],
                                           bool vector, float (&fv)[4], float (&rv)[4]) {
  if (vector) {
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), c = a;
    if (off[0] >= 0) {
      a = *reinterpret_cast<const float4*>(f + off[0]);
      c = *reinterpret_cast<const float4*>(r + off[0]);
    }
    fv[0] = a.x; fv[1] = a.y; fv[2] = a.z; fv[3] = a.w;
    rv[0] = c.x; rv[1] = c.y; rv[2] = c.z; rv[3] = c.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fv[j] = off[j] >= 0 ? f[off[j]] : 0.0f;
      rv[j] = off[j] >= 0 ? r[off[j]] : 0.0f;
    }
  }
}

__device__ __forceinline__ void store_words(int* __restrict__ d, const int (&off)[4], bool vector,
                                            const int (&x)[4]) {
  if (vector) {
    if (off[0] >= 0) *reinterpret_cast<int4*>(d + off[0]) = make_int4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (off[j] >= 0) d[off[j]] = x[j];
    }
  }
}

__device__ __forceinline__ void store_chunk(int* __restrict__ d, const int (&off)[4], bool vector,
                                            bool changed, const float (&fv)[4],
                                            const float (&rv)[4]) {
  int x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = changed ? (__float_as_int(fv[j]) ^ __float_as_int(rv[j])) : 0;
  store_words(d, off, vector, x);
}

// The new reference: the frame's bits on a changed tile, the old
// reference's elsewhere.
__device__ __forceinline__ void store_recon(int* __restrict__ d, const int (&off)[4], bool vector,
                                            bool changed, const float (&fv)[4],
                                            const float (&rv)[4]) {
  int x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = changed ? __float_as_int(fv[j]) : __float_as_int(rv[j]);
  store_words(d, off, vector, x);
}

// The XOR words' unsigned max over the 4 pixels (0 for a pixel past the
// tile, which reads 0 and 0).
__device__ __forceinline__ uint32_t xor_max(uint32_t m, const float (&fv)[4],
                                            const float (&rv)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m = max(m, static_cast<uint32_t>(__float_as_int(fv[j]) ^ __float_as_int(rv[j])));
  }
  return m;
}

template <bool kWriteDelta, bool kWriteRecon = false, bool kWriteWidths = false>
__global__ void __launch_bounds__(kThreads)
delta_encode_kernel(const float* __restrict__ frames,  // (B, H, W)
                    const float* __restrict__ refs,    // (B, H, W)
                    int* __restrict__ delta,           // (B, H, W); unused if !kWriteDelta
                    int* __restrict__ recon,           // (B, H, W) float bits; if kWriteRecon
                    float* __restrict__ mask,          // (B, tiles_h, tiles_w)
                    int* __restrict__ widths,          // (B, tiles_h, tiles_w); if kWriteWidths
                    int height, int width, int block_h, int block_w,
                    int tiles_h, int tiles_w, float threshold, bool vector) {
  static_assert(kWriteDelta || !kWriteWidths, "the widths are those of the stored delta");
  __shared__ float warp_max[kWarps];
  __shared__ uint32_t warp_xor_max[kWriteWidths ? kWarps : 1];

  const int tiles = tiles_h * tiles_w;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int row0 = (tile / tiles_w) * block_h;
  const int col0 = (tile % tiles_w) * block_w;
  const size_t plane = static_cast<size_t>(b) * height * width;
  const float* f = frames + plane;
  const float* r = refs + plane;
  const int cols = min(block_w, width - col0);
  const int pixels = min(block_h, height - row0) * cols;

  int off[4];
  float fv[4], rv[4];
  chunk_offsets(0, pixels, cols, width, row0, col0, vector, off);
  load_chunk(f, r, off, vector, fv, rv);
  float m = 0.0f;  // every |f - r| is >= 0 or NaN
  uint32_t xm = 0;  // the XOR words' max; if kWriteWidths
#pragma unroll
  for (int j = 0; j < 4; ++j) m = nan_max(m, fabsf(fv[j] - rv[j]));
  if constexpr (kWriteWidths) xm = xor_max(xm, fv, rv);
  for (int first = kChunk; first < pixels; first += kChunk) {  // tiles over 1,024 pixels
    int o[4];
    float fx[4], rx[4];
    chunk_offsets(first, pixels, cols, width, row0, col0, vector, o);
    load_chunk(f, r, o, vector, fx, rx);
#pragma unroll
    for (int j = 0; j < 4; ++j) m = nan_max(m, fabsf(fx[j] - rx[j]));
    if constexpr (kWriteWidths) xm = xor_max(xm, fx, rx);
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_down_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[threadIdx.x >> 5] = m;
  if constexpr (kWriteWidths) {
    xm = __reduce_max_sync(0xffffffffu, xm);
    if (lane == 0) warp_xor_max[threadIdx.x >> 5] = xm;
  }
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = nan_max(m, warp_max[w]);
  const bool changed = m > threshold;  // false for NaN
  if (threadIdx.x == 0) mask[static_cast<size_t>(b) * tiles + tile] = changed ? 1.0f : 0.0f;
  if constexpr (kWriteWidths) {
    if (threadIdx.x == 0) {
      xm = warp_xor_max[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) xm = max(xm, warp_xor_max[w]);
      widths[static_cast<size_t>(b) * tiles + tile] =
          changed ? 32 - __clz(static_cast<int>(xm)) : 0;
    }
  }
  if (!kWriteDelta) return;

  int* d = delta + plane;
  store_chunk(d, off, vector, changed, fv, rv);
  if constexpr (kWriteRecon) store_recon(recon + plane, off, vector, changed, fv, rv);
  for (int first = kChunk; first < pixels; first += kChunk) {
    chunk_offsets(first, pixels, cols, width, row0, col0, vector, off);
    load_chunk(f, r, off, vector, fv, rv);
    store_chunk(d, off, vector, changed, fv, rv);
    if constexpr (kWriteRecon) store_recon(recon + plane, off, vector, changed, fv, rv);
  }
}

// out = ref XOR delta, on float bits; the same into out2 unless it is null.
__global__ void __launch_bounds__(kDecodeThreads)
delta_decode_kernel(const int* __restrict__ delta, const int* __restrict__ ref,
                    int* __restrict__ out, int* __restrict__ out2, int n) {
  const int i = blockIdx.x * kDecodeThreads + threadIdx.x;
  if (i < n) {
    const int o = ref[i] ^ delta[i];
    out[i] = o;
    if (out2 != nullptr) out2[i] = o;
  }
}

}  // namespace

// K3 (num_clients = 1) and K3b on `stream`.  The tile grid is
// ceil(height / block_h) x ceil(width / block_w) per client; the caller
// keeps num_clients * height * width below 2^31.  delta == nullptr
// launches the mask-only kernel; recon != nullptr (with a delta) the
// kernel that also writes the new reference; widths != nullptr (with a
// delta) the kernel that also writes each tile's bit width.  Returns
// cudaErrorInvalidValue for a recon or widths without a delta, or both,
// else cudaGetLastError().
extern "C" int delta_encode_launch(const float* frames, const float* refs,
                                   int* delta, float* recon, float* mask, int* widths,
                                   int num_clients, int height, int width,
                                   int block_h, int block_w, float threshold,
                                   void* stream) {
  if ((recon != nullptr || widths != nullptr) && delta == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (recon != nullptr && widths != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_h = (height + block_h - 1) / block_h;
  const int tiles_w = (width + block_w - 1) / block_w;
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(frames) |
                              reinterpret_cast<uintptr_t>(refs) |
                              reinterpret_cast<uintptr_t>(delta) |
                              reinterpret_cast<uintptr_t>(recon);
  const bool vector = width % 4 == 0 && block_w % 4 == 0 && (addresses & 15) == 0;
  const dim3 grid(num_clients * tiles_h * tiles_w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* recon_bits = reinterpret_cast<int*>(recon);
  if (recon != nullptr) {
    delta_encode_kernel<true, true><<<grid, kThreads, 0, s>>>(
        frames, refs, delta, recon_bits, mask, widths, height, width, block_h, block_w,
        tiles_h, tiles_w, threshold, vector);
  } else if (widths != nullptr) {
    delta_encode_kernel<true, false, true><<<grid, kThreads, 0, s>>>(
        frames, refs, delta, recon_bits, mask, widths, height, width, block_h, block_w,
        tiles_h, tiles_w, threshold, vector);
  } else if (delta != nullptr) {
    delta_encode_kernel<true><<<grid, kThreads, 0, s>>>(
        frames, refs, delta, recon_bits, mask, widths, height, width, block_h, block_w,
        tiles_h, tiles_w, threshold, vector);
  } else {
    delta_encode_kernel<false><<<grid, kThreads, 0, s>>>(
        frames, refs, delta, recon_bits, mask, widths, height, width, block_h, block_w,
        tiles_h, tiles_w, threshold, vector);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 over n words on `stream`, into out and, unless it is null, out2.
// Returns cudaGetLastError().
extern "C" int delta_decode_launch(const int* delta, const float* ref, float* out,
                                   float* out2, int n, void* stream) {
  delta_decode_kernel<<<(n + kDecodeThreads - 1) / kDecodeThreads, kDecodeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      delta, reinterpret_cast<const int*>(ref), reinterpret_cast<int*>(out),
      reinterpret_cast<int*>(out2), n);
  return static_cast<int>(cudaGetLastError());
}
