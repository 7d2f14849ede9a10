// Forward kinematics: the hand's 48 spheres for every configuration of a
// population, in one launch.
//
// Replaces no TPU kernel: the reference's forward kinematics is jnp ops
// in repro/core/handmodel.py (pack_spheres), which XLA fuses inside its
// jitted frame.  The port's eager handmodel.pack_spheres is ~182 small
// PyTorch kernels a call, and the tracker calls it once a population
// evaluation (31 times a frame).  This kernel computes the same
// (M, 27) -> (M, 48, 4) [cx, cy, cz, r] for M configurations:
//
//   * the 20 angles clamped to [angle_lo, angle_hi];
//   * per finger, the abduction quaternion about z, then per bone
//     q = q * q_flex(bone), dir = rotate(normalize(q), rest_dir), the
//     bone's two spheres at pos + dir * offset, pos advanced by the bone
//     length; the fingertip sphere at pos + dir * tip_offset;
//   * the 9 palm spheres, and 4 padding spheres at the local origin;
//   * every local center rotated by h's normalized quaternion and moved
//     by h's position; the radii are the constant table.
//
// What bounds it on an H100: the launch.  It reads 27 floats and writes
// 48 float4 a configuration ((27 + 192) * 4 B * 64 = 56 KB at the
// tracker's M = 64, 0.017 us at 3.35 TB/s), and the arithmetic is a few
// thousand flops a configuration.  What is left is the dependent chain
// of one finger: 3 bones of sinf/cosf, a quaternion product, a
// normalization (IEEE sqrt, 4 divisions) and two cross products, then 7
// world transforms.  The design keeps that chain short and the launch
// one:
//   * 8 lanes a configuration: lane f < 5 walks finger f's chain and
//     stages its 7 spheres; lanes 5, 6 and 7 stage the 9 palm spheres
//     and the 4 padding spheres (5, 4 and 4).  Each lane normalizes h's
//     quaternion itself, which costs less than sharing it.
//   * A block of 128 threads holds 16 configurations.  The lanes stage
//     their spheres in shared memory and the block writes its
//     configurations' 16 * 768 B out as coalesced float4 stores.
//   * The geometry comes from one small float32 buffer on the device
//     (kGeo* below), packed by the wrapper from handmodel._geometry; no
//     number of the hand is written here.
//
// Rounding follows the eager ops, so the spheres equal handmodel's on
// the card to a few ulps, and bit for bit wherever the orders agree.
// Each PyTorch elementwise op rounds once, so products and sums that
// were separate kernels are __fmul_rn / __fadd_rn, never contracted into
// an fma.  A cross product is one PyTorch kernel whose a * b - c * d
// nvcc contracts to fma(a, b, -(c * d)), written so here.  A norm over
// a last dimension of 4 is PyTorch's reduction: one square a lane of a
// 4-wide row, folded by shuffles at offsets 2 then 1, so
// (x0^2 + x2^2) + (x1^2 + x3^2); then IEEE sqrtf, + 1e-12 and IEEE
// division.  sinf and cosf are the full-precision functions (the build
// has no --use_fast_math).

#include <cuda_runtime.h>

namespace {

constexpr int kParams = 27;  // handmodel.NUM_PARAMS
constexpr int kQuat = 3;     // handmodel.QUAT_SLICE = [3, 7)
constexpr int kAngles = 7;   // handmodel.ANGLES_SLICE = [7, 27)
constexpr int kSpheres = 48;
constexpr int kFingers = 5;
constexpr int kBones = 3;
constexpr int kPerBone = 2;
constexpr int kPerFinger = kBones * kPerBone + 1;  // and the tip
constexpr int kPalm = 9;
constexpr int kPad = kPalm + kFingers * kPerFinger;  // first padding sphere, 44
constexpr int kOthers = kPalm + (kSpheres - kPad);   // palm and padding, 13
constexpr int kLanes = 8;  // a configuration's lanes
constexpr int kThreads = 128;
constexpr int kConfigsPerBlock = kThreads / kLanes;

// The packed geometry (231 floats): each of handmodel._Geometry's
// fields in its order, flattened, then the unit axes as
// quat_from_axis_angle normalizes them.  The parts the kernel reads, at
// the offsets kernels/hand_spheres.geometry_offsets() gives them (a CPU
// test holds the two equal); the raw flexion and z axes at 105 and 120
// are read in their unit form.
constexpr int kGeoPalmCenters = 0;      // (9, 3)
constexpr int kGeoRadii = 27;           // (48,)
constexpr int kGeoBases = 75;           // (5, 3)
constexpr int kGeoRestDirs = 90;        // (5, 3)
constexpr int kGeoSphereOffsets = 123;  // (5, 3, 2)
constexpr int kGeoBoneLengths = 153;    // (5, 3)
constexpr int kGeoTipOffsets = 168;     // (5,)
constexpr int kGeoAngleLo = 173;        // (20,)
constexpr int kGeoAngleHi = 193;        // (20,)
constexpr int kGeoFlexUnits = 213;      // (5, 3)
constexpr int kGeoZUnit = 228;          // (3,)

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ Vec3 load3(const float* p) { return {p[0], p[1], p[2]}; }

// One component of torch.linalg.cross, a * b - c * d, as its kernel rounds.
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {cross_term(a.y, b.z, a.z, b.y), cross_term(a.z, b.x, a.x, b.z),
          cross_term(a.x, b.y, a.y, b.x)};
}

// quat_normalize: q / (|q| + 1e-12), |q| summed as PyTorch's reduction.
__device__ __forceinline__ void normalize(float q[4]) {
  const float ss = add(add(mul(q[0], q[0]), mul(q[2], q[2])),
                       add(mul(q[1], q[1]), mul(q[3], q[3])));
  const float d = add(__fsqrt_rn(ss), 1e-12f);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = __fdiv_rn(q[k], d);
}

// quat_rotate: v + 2 (w (u x v) + u x (u x v)).
__device__ __forceinline__ Vec3 rotate(const float q[4], Vec3 v) {
  const Vec3 u{q[1], q[2], q[3]};
  const Vec3 uv = cross(u, v);
  const Vec3 uuv = cross(u, uv);
  return {add(v.x, mul(2.0f, add(mul(q[0], uv.x), uuv.x))),
          add(v.y, mul(2.0f, add(mul(q[0], uv.y), uuv.y))),
          add(v.z, mul(2.0f, add(mul(q[0], uv.z), uuv.z)))};
}

// quat_multiply: a * b, each component's terms added left to right.
__device__ __forceinline__ void multiply(const float a[4], const float b[4], float out[4]) {
  out[0] = sub(sub(sub(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2])), mul(a[3], b[3]));
  out[1] = sub(add(add(mul(a[0], b[1]), mul(a[1], b[0])), mul(a[2], b[3])), mul(a[3], b[2]));
  out[2] = add(add(sub(mul(a[0], b[2]), mul(a[1], b[3])), mul(a[2], b[0])), mul(a[3], b[1]));
  out[3] = add(sub(add(mul(a[0], b[3]), mul(a[1], b[2])), mul(a[2], b[1])), mul(a[3], b[0]));
}

// quat_from_axis_angle about a unit axis: [cos(a/2), axis sin(a/2)].
__device__ __forceinline__ void axis_angle(const float* axis, float angle, float q[4]) {
  const float half = mul(angle, 0.5f);
  const float s = sinf(half);
  q[0] = cosf(half);
  q[1] = mul(axis[0], s);
  q[2] = mul(axis[1], s);
  q[3] = mul(axis[2], s);
}

// torch.minimum(torch.maximum(a, lo), hi), a NaN kept as PyTorch keeps it.
__device__ __forceinline__ float clamp_angle(float a, float lo, float hi) {
  return a != a ? a : fminf(fmaxf(a, lo), hi);
}

// A local center along a bone: pos + dir * length.
__device__ __forceinline__ Vec3 along(Vec3 pos, Vec3 dir, float length) {
  return {add(pos.x, mul(dir.x, length)), add(pos.y, mul(dir.y, length)),
          add(pos.z, mul(dir.z, length))};
}

// A local center in the camera frame, with its radius.
__device__ __forceinline__ float4 world(const float qh[4], Vec3 pos, Vec3 c, float r) {
  const Vec3 w = rotate(qh, c);
  return make_float4(add(w.x, pos.x), add(w.y, pos.y), add(w.z, pos.z), r);
}

__global__ void __launch_bounds__(kThreads)
hand_spheres_kernel(const float* __restrict__ h, const float* __restrict__ geo,
                    float4* __restrict__ out, int num_configs) {
  __shared__ float4 staged[kConfigsPerBlock][kSpheres];
  const int slot = static_cast<int>(threadIdx.x) / kLanes;
  const int lane = static_cast<int>(threadIdx.x) % kLanes;
  const int first = blockIdx.x * kConfigsPerBlock;
  const int m = first + slot;

  if (m < num_configs) {
    const float* hm = h + static_cast<size_t>(m) * kParams;
    const Vec3 pos = load3(hm);
    float qh[4] = {hm[kQuat], hm[kQuat + 1], hm[kQuat + 2], hm[kQuat + 3]};
    normalize(qh);
    float4* mine = staged[slot];
    if (lane < kFingers) {
      const int f = lane;
      float a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * f + j;
        a[j] = clamp_angle(hm[kAngles + i], geo[kGeoAngleLo + i], geo[kGeoAngleHi + i]);
      }
      const float* flex = geo + kGeoFlexUnits + 3 * f;
      const Vec3 rest = load3(geo + kGeoRestDirs + 3 * f);
      float q[4];
      axis_angle(geo + kGeoZUnit, a[0], q);
      Vec3 p = load3(geo + kGeoBases + 3 * f);
      Vec3 dir{};
      const int base = kPalm + kPerFinger * f;
#pragma unroll
      for (int b = 0; b < kBones; ++b) {
        float q_flex[4], qb[4];
        axis_angle(flex, a[1 + b], q_flex);
        multiply(q, q_flex, qb);
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = qb[k];
        normalize(qb);
        dir = rotate(qb, rest);
#pragma unroll
        for (int k = 0; k < kPerBone; ++k) {
          const int s = base + kPerBone * b + k;
          const float offset = geo[kGeoSphereOffsets + (kBones * f + b) * kPerBone + k];
          mine[s] = world(qh, pos, along(p, dir, offset), geo[kGeoRadii + s]);
        }
        p = along(p, dir, geo[kGeoBoneLengths + kBones * f + b]);
      }
      const int tip = base + kPerFinger - 1;
      mine[tip] = world(qh, pos, along(p, dir, geo[kGeoTipOffsets + f]), geo[kGeoRadii + tip]);
    } else {
      // palm spheres 0..8 and padding 44..47, dealt round-robin to lanes 5..7
      for (int j = lane - kFingers; j < kOthers; j += kLanes - kFingers) {
        const int s = j < kPalm ? j : kPad + (j - kPalm);
        const Vec3 c = j < kPalm ? load3(geo + kGeoPalmCenters + 3 * j) : Vec3{0.0f, 0.0f, 0.0f};
        mine[s] = world(qh, pos, c, geo[kGeoRadii + s]);
      }
    }
  }
  __syncthreads();
  const int configs = min(kConfigsPerBlock, num_configs - first);
  float4* dst = out + static_cast<size_t>(first) * kSpheres;
  const float4* src = &staged[0][0];
  for (int i = threadIdx.x; i < configs * kSpheres; i += kThreads) dst[i] = src[i];
}

}  // namespace

// Launches on `stream` over `num_configs` configurations (h is
// (num_configs, 27), `geometry` the wrapper's packed buffer, `out` (num_configs, 48, 4), 16-byte aligned).  Returns
// cudaGetLastError() (0 on success).
extern "C" int hand_spheres_launch(const float* h, const float* geometry, float* out,
                                   int num_configs, void* stream) {
  const int blocks = (num_configs + kConfigsPerBlock - 1) / kConfigsPerBlock;
  hand_spheres_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      h, geometry, reinterpret_cast<float4*>(out), num_configs);
  return static_cast<int>(cudaGetLastError());
}
