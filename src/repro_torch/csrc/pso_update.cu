// Fused PSO velocity/position update (K2).
//
// Replaces the Pallas TPU kernel repro/kernels/pso_update.py:pso_update
// (_pso_update_kernel).  Elementwise over the (N, D) swarm plane, with
// the (D,) rows gbest, lo and hi broadcast over particles:
//
//   v' = clip(w v + c1 r1 (pbest - x) + c2 r2 (gbest - x), +-vclip (hi - lo))
//   x' = clip(x + v', lo, hi)
//
// The velocity is clipped first, then the position, as in the reference.
// What bounds it on an H100: bytes (five (N, D) planes read, two
// written, ~3 flops per byte), and at the tracker's N = 64, D = 27 the
// launch itself.  One thread per element; the ragged edge is masked, so
// any N works without padding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
pso_update_kernel(const float* __restrict__ x, const float* __restrict__ v,
                  const float* __restrict__ pbest,
                  const float* __restrict__ gbest,  // (D,)
                  const float* __restrict__ r1, const float* __restrict__ r2,
                  const float* __restrict__ lo,  // (D,)
                  const float* __restrict__ hi,  // (D,)
                  float* __restrict__ x_out, float* __restrict__ v_out,
                  int total, int dims, float inertia, float cognitive,
                  float social, float velocity_clip) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int d = i % dims;
  const float xi = x[i];
  const float lo_d = lo[d], hi_d = hi[d];
  float vel = inertia * v[i] + cognitive * r1[i] * (pbest[i] - xi) +
              social * r2[i] * (gbest[d] - xi);
  const float vmax = velocity_clip * (hi_d - lo_d);
  vel = fminf(fmaxf(vel, -vmax), vmax);
  x_out[i] = fminf(fmaxf(xi + vel, lo_d), hi_d);
  v_out[i] = vel;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pso_update_launch(const float* x, const float* v,
                                 const float* pbest, const float* gbest,
                                 const float* r1, const float* r2,
                                 const float* lo, const float* hi,
                                 float* x_out, float* v_out, int num_particles,
                                 int dims, float inertia, float cognitive,
                                 float social, float velocity_clip,
                                 void* stream) {
  const int total = num_particles * dims;
  pso_update_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, v, pbest, gbest, r1, r2, lo, hi, x_out, v_out, total, dims, inertia,
      cognitive, social, velocity_clip);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
