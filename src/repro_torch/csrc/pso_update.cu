// Fused PSO velocity/position update (K2, and K2b over B swarms).
//
// Replaces the Pallas TPU kernels repro/kernels/pso_update.py:pso_update
// and pso_update_batched (both _pso_update_kernel).  Elementwise over
// the (B, N, D) swarm planes, with each swarm's (D,) row gbest[b] and
// the rows lo and hi (one shared row, or one per swarm) broadcast over
// its particles:
//
//   v' = clip(w v + c1 r1 (pbest - x) + c2 r2 (gbest - x), +-vclip (hi - lo))
//   x' = clip(x + v', lo, hi)
//
// The velocity is clipped first, then the position, as in the reference.
// What bounds it on an H100: bytes (five (B, N, D) planes read, two
// written, ~3 flops per byte), and at the tracker's N = 64, D = 27 the
// launch itself.  One thread per element; the ragged edge is masked, so
// any N works without padding.  K2 is the B = 1 launch of this same
// kernel, and an element's arithmetic does not depend on b, so row b of
// K2b equals K2 on swarm b bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pso_update_kernel(const float* __restrict__ x, const float* __restrict__ v,
                  const float* __restrict__ pbest,
                  const float* __restrict__ gbest,  // (B, D)
                  const float* __restrict__ r1, const float* __restrict__ r2,
                  const float* __restrict__ lo,  // (D,) or (B, D)
                  const float* __restrict__ hi,  // like lo
                  float* __restrict__ x_out, float* __restrict__ v_out,
                  int total, int swarm_size, int dims, int bound_stride,
                  float inertia, float cognitive, float social,
                  float velocity_clip) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / swarm_size;
  const int d = i % dims;
  const float xi = x[i];
  const float lo_d = lo[b * bound_stride + d], hi_d = hi[b * bound_stride + d];
  float vel = inertia * v[i] + cognitive * r1[i] * (pbest[i] - xi) +
              social * r2[i] * (gbest[b * dims + d] - xi);
  const float vmax = velocity_clip * (hi_d - lo_d);
  vel = fminf(fmaxf(vel, -vmax), vmax);
  x_out[i] = fminf(fmaxf(xi + vel, lo_d), hi_d);
  v_out[i] = vel;
}

}  // namespace

// Launches on `stream` over `num_swarms` swarms of num_particles x dims;
// `bound_stride` is 0 when lo and hi are one row shared by every swarm,
// dims when they hold one row per swarm.  Returns cudaGetLastError()
// (0 on success).
extern "C" int pso_update_launch(const float* x, const float* v,
                                 const float* pbest, const float* gbest,
                                 const float* r1, const float* r2,
                                 const float* lo, const float* hi,
                                 float* x_out, float* v_out, int num_swarms,
                                 int num_particles, int dims, int bound_stride,
                                 float inertia, float cognitive, float social,
                                 float velocity_clip, void* stream) {
  const int swarm_size = num_particles * dims;
  const int total = num_swarms * swarm_size;
  pso_update_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, v, pbest, gbest, r1, r2, lo, hi, x_out, v_out, total, swarm_size,
      dims, bound_stride, inertia, cognitive, social, velocity_clip);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
