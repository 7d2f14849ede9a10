// Fused PSO velocity/position update (K2, and K2b over B swarms), with
// the quaternion projection that follows it in a tracker generation.
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
// With the projection on, each particle's quaternion columns [3, 7) of x'
// (handmodel.QUAT_SLICE) are then replaced by q / (|q| + 1e-12), which is
// handmodel.normalize_configuration in the tracker
// (repro/core/pso.py:swarm_step's project_fn), so a generation's update
// and projection are one launch instead of the update and four or more
// eager kernels.
//
// What bounds it on an H100: bytes (five (B, N, D) planes read, two
// written, ~3 flops per byte: 48.7 KB at the tracker's 64 x 27, 0.015 us
// at 3.35 TB/s), and far above that the launch itself.  The design keeps
// the launch's own work short:
//   * One warp per particle row, lanes striding over D (D = 27 is one
//     pass), 8 rows per block, one flat grid over the B * N rows.  The
//     row and the column come from the warp and lane index: no integer
//     division per element.  gbest, lo and hi are read once per lane.
//   * The projection needs no shared memory and no barrier: the warp
//     gathers the four quaternion values with shuffles, every lane sums
//     q0^2 + q1^2 + q2^2 + q3^2 in that order, takes IEEE sqrtf and
//     divides (no fast math), and the lane that owns a quaternion column
//     stores its normalized value in place of the unprojected one.
//   * The projection is a template flag, so the launch without it
//     (pso_update, pso_update_batched) runs an instance with no
//     projection code: a runtime flag made that launch about 0.3 us
//     slower on an H100.
//   * K2 is the B = 1 launch of this same kernel, and a row's arithmetic
//     does not depend on b, so row b of K2b equals K2 on swarm b bit for
//     bit, with the projection on or off.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per particle row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kQuat = 3;  // handmodel.QUAT_SLICE = [3, 7): in the first pass

template <bool kProject>
__global__ void __launch_bounds__(kThreads)
pso_update_kernel(const float* __restrict__ x, const float* __restrict__ v,
                  const float* __restrict__ pbest,
                  const float* __restrict__ gbest,  // (B, D)
                  const float* __restrict__ r1, const float* __restrict__ r2,
                  const float* __restrict__ lo,  // (D,) or (B, D)
                  const float* __restrict__ hi,  // like lo
                  float* __restrict__ x_out, float* __restrict__ v_out,
                  int rows, int num_particles, int dims, int bound_stride,
                  float inertia, float cognitive, float social,
                  float velocity_clip) {
  const int row = blockIdx.x * kRowsPerBlock + static_cast<int>(threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int b = row / num_particles;  // once per warp
  const size_t base = static_cast<size_t>(row) * dims;
  const float* g = gbest + static_cast<size_t>(b) * dims;
  const float* lo_b = lo + static_cast<size_t>(b) * bound_stride;
  const float* hi_b = hi + static_cast<size_t>(b) * bound_stride;

  // The quaternion (every lane gathers it), and the lane's own
  // quaternion column and value, if it owns one.  A column past dims
  // gathers 0, as the plain version's shorter quaternion does.
  float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float mine = 0.0f;
  int mine_col = -1;
  for (int d0 = 0; d0 < dims; d0 += 32) {
    const int d = d0 + lane;
    float pos = 0.0f;
    if (d < dims) {
      const size_t i = base + d;
      const float xi = x[i];
      const float lo_d = lo_b[d], hi_d = hi_b[d];
      float vel = inertia * v[i] + cognitive * r1[i] * (pbest[i] - xi) +
                  social * r2[i] * (g[d] - xi);
      const float vmax = velocity_clip * (hi_d - lo_d);
      vel = fminf(fmaxf(vel, -vmax), vmax);
      pos = fminf(fmaxf(xi + vel, lo_d), hi_d);
      v_out[i] = vel;
      const bool quat = kProject && d >= kQuat && d < kQuat + 4;
      if (quat) {
        mine = pos;
        mine_col = d;
      } else {
        x_out[i] = pos;
      }
    }
    if (kProject && d0 == 0) {  // warp-uniform
#pragma unroll
      for (int k = 0; k < 4; ++k) q[k] = __shfl_sync(kFullMask, pos, kQuat + k);
    }
  }
  if (mine_col >= 0) {
    const float ss = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(q[0], q[0]), __fmul_rn(q[1], q[1])),
                                         __fmul_rn(q[2], q[2])),
                               __fmul_rn(q[3], q[3]));
    x_out[base + mine_col] = __fdiv_rn(mine, __fadd_rn(__fsqrt_rn(ss), 1e-12f));
  }
}

}  // namespace

// Launches on `stream` over `num_swarms` swarms of num_particles x dims;
// `bound_stride` is 0 when lo and hi are one row shared by every swarm,
// dims when they hold one row per swarm.  `project` != 0 renormalizes
// the quaternion columns [3, 7) of every new position; 0 leaves the
// update alone.  Returns
// cudaGetLastError() (0 on success).
extern "C" int pso_update_launch(const float* x, const float* v,
                                 const float* pbest, const float* gbest,
                                 const float* r1, const float* r2,
                                 const float* lo, const float* hi,
                                 float* x_out, float* v_out, int num_swarms,
                                 int num_particles, int dims, int bound_stride,
                                 int project, float inertia, float cognitive,
                                 float social, float velocity_clip, void* stream) {
  const int rows = num_swarms * num_particles;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (project) {
    pso_update_kernel<true><<<blocks, kThreads, 0, s>>>(
        x, v, pbest, gbest, r1, r2, lo, hi, x_out, v_out, rows, num_particles,
        dims, bound_stride, inertia, cognitive, social, velocity_clip);
  } else {
    pso_update_kernel<false><<<blocks, kThreads, 0, s>>>(
        x, v, pbest, gbest, r1, r2, lo, hi, x_out, v_out, rows, num_particles,
        dims, bound_stride, inertia, cognitive, social, velocity_clip);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
