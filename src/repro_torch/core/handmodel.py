"""27-DoF kinematic hand model (paper §3.1, "Hand model").

The hand configuration vector ``h`` has 27 kinematic parameters:

* ``h[0:3]``   — 3D location of the hand root (palm center), meters.
* ``h[3:7]``   — 3D orientation as a unit quaternion ``(w, x, y, z)``.
* ``h[7:27]``  — 20 bone angles, radians: 4 per finger ``(abduction,
  mcp_flex, pip_flex, dip_flex)``, and ``(tm_abd, tm_flex, mcp_flex,
  ip_flex)`` for the thumb.

The hand is a union of spheres: ``SPHERES_PER_BONE`` along each bone, a
fingertip sphere per finger, and a 3x3 palm slab, padded with
zero-radius spheres to ``NUM_SPHERES``.

Every function takes a leading batch of configurations ``(..., 27)``:
forward kinematics runs for a whole particle population as tensor ops,
with the five fingers as one more tensor axis, so a population costs the
same number of launches as one configuration.  The geometry constants
live on the device of the configurations they are applied to, built once
per device (``_geometry``), so no host-to-device copy happens per call.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------

NUM_PARAMS = 27
POS_SLICE = slice(0, 3)
QUAT_SLICE = slice(3, 7)
ANGLES_SLICE = slice(7, 27)

FINGER_NAMES = ("thumb", "index", "middle", "ring", "pinky")
ANGLES_PER_FINGER = 4

# Geometry constants (meters). Proportions of an average adult hand.
PALM_WIDTH = 0.085
PALM_LENGTH = 0.095
PALM_THICKNESS = 0.030

# Finger attachment points on the palm, in the hand local frame:
#   +x: thumb side (radial), +y: from wrist towards fingers, +z: out of the
#   back of the hand (towards the camera when the palm faces away).
_FINGER_BASES = (
    # thumb attaches low on the radial side
    (0.040, 0.005, -0.010),
    (0.032, 0.048, 0.0),   # index
    (0.010, 0.052, 0.0),   # middle
    (-0.012, 0.050, 0.0),  # ring
    (-0.033, 0.044, 0.0),  # pinky
)

# Per-finger bone lengths (proximal, middle, distal), meters.
_BONE_LENGTHS = (
    (0.046, 0.035, 0.028),  # thumb (metacarpal treated as proximal)
    (0.040, 0.026, 0.018),  # index
    (0.044, 0.029, 0.019),  # middle
    (0.041, 0.027, 0.018),  # ring
    (0.032, 0.021, 0.016),  # pinky
)

# Per-finger base radii, meters (tapers towards the tip).
_FINGER_RADII = (0.011, 0.009, 0.009, 0.0085, 0.0075)

# Resting direction of each finger in the palm frame (normalized in
# code). The thumb points sideways+forward.
_FINGER_DIRS = (
    (0.8, 0.5, -0.2),
    (0.05, 1.0, 0.0),
    (0.0, 1.0, 0.0),
    (-0.05, 1.0, 0.0),
    (-0.12, 1.0, 0.0),
)

SPHERES_PER_BONE = 2
NUM_BONES_PER_FINGER = 3
# palm spheres: 3 columns x 3 rows
_PALM_GRID = (3, 3)
NUM_PALM_SPHERES = _PALM_GRID[0] * _PALM_GRID[1]
NUM_FINGER_SPHERES = (
    len(FINGER_NAMES) * NUM_BONES_PER_FINGER * SPHERES_PER_BONE
)
NUM_SPHERES_RAW = NUM_PALM_SPHERES + NUM_FINGER_SPHERES + len(FINGER_NAMES)
# pad to a multiple of 8 so kernel tiles stay aligned
NUM_SPHERES = ((NUM_SPHERES_RAW + 7) // 8) * 8
_SPHERES_PER_FINGER = NUM_BONES_PER_FINGER * SPHERES_PER_BONE + 1

# Per-dimension articulation limits (radians), used both to clamp FK inputs
# and as PSO search bounds.
_ABD_LIMIT = 0.35
_FLEX_LO, _FLEX_HI = -0.26, 1.9


def _angle_bounds_np() -> Tuple[np.ndarray, np.ndarray]:
    lo, hi = [], []
    for _ in FINGER_NAMES:
        lo.extend([-_ABD_LIMIT, _FLEX_LO, _FLEX_LO, _FLEX_LO])
        hi.extend([_ABD_LIMIT, _FLEX_HI, _FLEX_HI, _FLEX_HI])
    return np.asarray(lo, np.float32), np.asarray(hi, np.float32)


def angle_lower_bounds(device: torch.device | str = "cuda") -> torch.Tensor:
    return torch.as_tensor(_angle_bounds_np()[0], device=device)


def angle_upper_bounds(device: torch.device | str = "cuda") -> torch.Tensor:
    return torch.as_tensor(_angle_bounds_np()[1], device=device)


# ---------------------------------------------------------------------------
# Quaternion utilities (w, x, y, z convention)
# ---------------------------------------------------------------------------


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q (shapes broadcast)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    # v' = v + 2 w (u x v) + 2 (u x (u x v))
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-12)
    half = angle * 0.5
    s = torch.sin(half)
    return torch.cat(
        [torch.cos(half)[..., None], axis * s[..., None]], dim=-1
    )


# ---------------------------------------------------------------------------
# Geometry constants on a device
# ---------------------------------------------------------------------------


def _palm_spheres_local() -> Tuple[np.ndarray, np.ndarray]:
    """Palm sphere centers + radii in the hand local frame (numpy)."""
    xs = np.linspace(-PALM_WIDTH / 2 * 0.7, PALM_WIDTH / 2 * 0.7, _PALM_GRID[0])
    ys = np.linspace(-PALM_LENGTH / 2 * 0.55, PALM_LENGTH / 2 * 0.75, _PALM_GRID[1])
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    centers = np.stack(
        [gx.reshape(-1), gy.reshape(-1), np.zeros(NUM_PALM_SPHERES)], axis=-1
    )
    radii = np.full((NUM_PALM_SPHERES,), PALM_THICKNESS * 0.75)
    return centers.astype(np.float32), radii.astype(np.float32)


def _sphere_radii_np() -> np.ndarray:
    """(NUM_SPHERES,) radii: palm, then per finger 2 per bone + the tip,
    then zero-radius padding (never hit)."""
    radii = [_palm_spheres_local()[1]]
    for radius in _FINGER_RADII:
        r = []
        for bone_idx in range(NUM_BONES_PER_FINGER):
            r.extend([radius * (1.0 - 0.15 * bone_idx)] * SPHERES_PER_BONE)
        r.append(radius * 0.85)
        radii.append(np.asarray(r, np.float32))
    radii.append(np.zeros(NUM_SPHERES - NUM_SPHERES_RAW, np.float32))
    return np.concatenate(radii)


class _Geometry(NamedTuple):
    palm_centers: torch.Tensor  # (9, 3)
    radii: torch.Tensor  # (NUM_SPHERES,)
    bases: torch.Tensor  # (5, 3) finger attachment points
    rest_dirs: torch.Tensor  # (5, 3) unit resting directions
    flex_axes: torch.Tensor  # (5, 3) unit flexion axes z x rest_dir
    z_axis: torch.Tensor  # (3,) abduction axis
    # (5, 3, SPHERES_PER_BONE) offsets of each bone's spheres along it,
    # length * (k + 1) / SPHERES_PER_BONE
    sphere_offsets: torch.Tensor
    bone_lengths: torch.Tensor  # (5, 3)
    tip_offsets: torch.Tensor  # (5,) radius * 0.5
    angle_lo: torch.Tensor  # (20,)
    angle_hi: torch.Tensor  # (20,)


@functools.lru_cache(maxsize=None)
def _geometry(device: torch.device) -> _Geometry:
    """The hand's constant tensors on ``device``, built once per device."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    z_axis = f32([0.0, 0.0, 1.0])
    rest = f32(_FINGER_DIRS)
    rest = rest / torch.linalg.vector_norm(rest, dim=-1, keepdim=True)
    flex = torch.linalg.cross(z_axis.expand_as(rest), rest, dim=-1)
    flex = flex / (torch.linalg.vector_norm(flex, dim=-1, keepdim=True) + 1e-12)
    lengths = np.asarray(_BONE_LENGTHS, np.float64)
    fracs = (np.arange(SPHERES_PER_BONE) + 1.0) / SPHERES_PER_BONE
    lo, hi = _angle_bounds_np()
    return _Geometry(
        palm_centers=f32(_palm_spheres_local()[0]),
        radii=f32(_sphere_radii_np()),
        bases=f32(_FINGER_BASES),
        rest_dirs=rest,
        flex_axes=flex,
        z_axis=z_axis,
        sphere_offsets=f32(lengths[:, :, None] * fracs),
        bone_lengths=f32(lengths),
        tip_offsets=f32(np.asarray(_FINGER_RADII) * 0.5),
        angle_lo=f32(lo),
        angle_hi=f32(hi),
    )


# ---------------------------------------------------------------------------
# Forward kinematics -> sphere primitives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HandGeometry:
    """Static geometry description (non-traced constants)."""

    num_spheres: int = NUM_SPHERES
    palm_width: float = PALM_WIDTH
    palm_length: float = PALM_LENGTH


def hand_spheres_local(angles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All sphere primitives in the hand local frame.

    Args:
      angles: (..., 20) articulation angles.

    Returns:
      centers (..., NUM_SPHERES, 3), radii (..., NUM_SPHERES) — zero-radius
      padding spheres at the end.
    """
    g = _geometry(angles.device)
    angles = torch.minimum(torch.maximum(angles, g.angle_lo), g.angle_hi)
    batch = angles.shape[:-1]
    fa = angles.reshape(*batch, len(FINGER_NAMES), ANGLES_PER_FINGER)

    # All five fingers at once: the finger is one more tensor axis.
    q = quat_from_axis_angle(g.z_axis, fa[..., 0])  # (..., 5, 4)
    pos = g.bases.expand(*batch, -1, -1)
    centers = []
    for bone_idx in range(NUM_BONES_PER_FINGER):
        q_flex = quat_from_axis_angle(g.flex_axes, fa[..., 1 + bone_idx])
        q = quat_multiply(q, q_flex)
        direction = quat_rotate(quat_normalize(q), g.rest_dirs)  # (..., 5, 3)
        for k in range(SPHERES_PER_BONE):
            centers.append(pos + direction * g.sphere_offsets[:, bone_idx, k, None])
        pos = pos + direction * g.bone_lengths[:, bone_idx, None]
    centers.append(pos + direction * g.tip_offsets[:, None])  # fingertip
    fingers = torch.stack(centers, dim=-2)  # (..., 5, 7, 3)
    fingers = fingers.reshape(*batch, len(FINGER_NAMES) * _SPHERES_PER_FINGER, 3)

    palm = g.palm_centers.expand(*batch, -1, -1)
    pad = fingers.new_zeros(*batch, NUM_SPHERES - NUM_SPHERES_RAW, 3)
    centers = torch.cat([palm, fingers, pad], dim=-2)
    return centers, g.radii.expand(*batch, -1)


def hand_spheres_world(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere primitives in camera/world coordinates for configurations h.

    Args:
      h: (..., 27) hand configurations.

    Returns:
      centers (..., NUM_SPHERES, 3) in camera frame, radii (..., NUM_SPHERES).
    """
    pos = h[..., POS_SLICE]
    quat = quat_normalize(h[..., QUAT_SLICE])
    centers_l, radii = hand_spheres_local(h[..., ANGLES_SLICE])
    centers_w = quat_rotate(quat[..., None, :], centers_l) + pos[..., None, :]
    return centers_w, radii


def pack_spheres(h: torch.Tensor) -> torch.Tensor:
    """(..., NUM_SPHERES, 4) packed [cx, cy, cz, r] — the kernel input."""
    c, r = hand_spheres_world(h)
    return torch.cat([c, r[..., None]], dim=-1)


def default_pose(
    distance: float = 0.55, device: torch.device | str = "cuda"
) -> torch.Tensor:
    """A neutral open hand facing the camera at `distance` meters."""
    h = torch.zeros((NUM_PARAMS,), dtype=torch.float32, device=device)
    h[2] = distance
    h[3] = 1.0  # identity quaternion
    return h


def configuration_from_numpy(
    h: np.ndarray, device: torch.device | str = "cuda"
) -> torch.Tensor:
    """A configuration (or a batch of them) given as numpy — e.g. the
    reference's ``np.asarray(h)`` — as a float32 tensor on ``device``."""
    return torch.as_tensor(np.array(h, dtype=np.float32), device=device)


def parameter_lower_bounds(center: torch.Tensor, pos_range: float = 0.12,
                           quat_range: float = 0.25) -> torch.Tensor:
    """PSO lower bounds: a box around `center` (the previous-frame solution).

    The paper: "particles are initialized around the solution of the
    previous frame. The space around that solution is made large enough to
    include the current frame estimation."
    """
    g = _geometry(center.device)
    return torch.cat([
        center[POS_SLICE] - pos_range,
        center[QUAT_SLICE] - quat_range,
        torch.maximum(center[ANGLES_SLICE] - 0.6, g.angle_lo),
    ])


def parameter_upper_bounds(center: torch.Tensor, pos_range: float = 0.12,
                           quat_range: float = 0.25) -> torch.Tensor:
    g = _geometry(center.device)
    return torch.cat([
        center[POS_SLICE] + pos_range,
        center[QUAT_SLICE] + quat_range,
        torch.minimum(center[ANGLES_SLICE] + 0.6, g.angle_hi),
    ])


def normalize_configuration(h: torch.Tensor) -> torch.Tensor:
    """Renormalize the quaternion block (PSO moves particles off the
    unit-quaternion manifold; this projects back)."""
    q = quat_normalize(h[..., QUAT_SLICE])
    return torch.cat([h[..., POS_SLICE], q, h[..., ANGLES_SLICE]], dim=-1)
