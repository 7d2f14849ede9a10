"""The 27-DoF hand as a union of spheres: forward kinematics in plain
torch, for any float dtype.

A frozen copy of the program's hand model (paper §3.1, "Hand model"),
kept beside the benchmark so that no change to the program can move the
yardstick.  ``h`` is (..., 27): the root position (meters), a (w, x, y, z)
quaternion, and 4 angles for each of the five fingers.  The hand is 9
palm spheres, 2 spheres along each of a finger's 3 bones and one at its
tip, padded with zero-radius spheres to 48.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

NUM_PARAMS = 27
POS = slice(0, 3)
QUAT = slice(3, 7)
ANGLES = slice(7, 27)

FINGERS = 5
ANGLES_PER_FINGER = 4
PALM_WIDTH, PALM_LENGTH, PALM_THICKNESS = 0.085, 0.095, 0.030
FINGER_BASES = ((0.040, 0.005, -0.010), (0.032, 0.048, 0.0), (0.010, 0.052, 0.0),
                (-0.012, 0.050, 0.0), (-0.033, 0.044, 0.0))
BONE_LENGTHS = ((0.046, 0.035, 0.028), (0.040, 0.026, 0.018), (0.044, 0.029, 0.019),
                (0.041, 0.027, 0.018), (0.032, 0.021, 0.016))
FINGER_RADII = (0.011, 0.009, 0.009, 0.0085, 0.0075)
FINGER_DIRS = ((0.8, 0.5, -0.2), (0.05, 1.0, 0.0), (0.0, 1.0, 0.0), (-0.05, 1.0, 0.0),
               (-0.12, 1.0, 0.0))
SPHERES_PER_BONE = 2
BONES = 3
PALM_GRID = (3, 3)
PALM_SPHERES = PALM_GRID[0] * PALM_GRID[1]
SPHERES_RAW = PALM_SPHERES + FINGERS * BONES * SPHERES_PER_BONE + FINGERS
NUM_SPHERES = ((SPHERES_RAW + 7) // 8) * 8
ABD_LIMIT = 0.35
FLEX_LO, FLEX_HI = -0.26, 1.9


class Geometry(NamedTuple):
    """The hand's constants on one device, in one dtype."""

    palm_centers: torch.Tensor  # (9, 3)
    radii: torch.Tensor  # (48,)
    bases: torch.Tensor  # (5, 3)
    rest_dirs: torch.Tensor  # (5, 3), unit
    flex_axes: torch.Tensor  # (5, 3), unit: z x rest_dir
    z_axis: torch.Tensor  # (3,)
    sphere_offsets: torch.Tensor  # (5, 3, 2): length * (k + 1) / 2 along each bone
    bone_lengths: torch.Tensor  # (5, 3)
    tip_offsets: torch.Tensor  # (5,)
    angle_lo: torch.Tensor  # (20,)
    angle_hi: torch.Tensor  # (20,)


def _angle_bounds() -> Tuple[np.ndarray, np.ndarray]:
    lo = [-ABD_LIMIT, FLEX_LO, FLEX_LO, FLEX_LO] * FINGERS
    hi = [ABD_LIMIT, FLEX_HI, FLEX_HI, FLEX_HI] * FINGERS
    return np.asarray(lo, np.float32), np.asarray(hi, np.float32)


def _palm_centers() -> np.ndarray:
    xs = np.linspace(-PALM_WIDTH / 2 * 0.7, PALM_WIDTH / 2 * 0.7, PALM_GRID[0])
    ys = np.linspace(-PALM_LENGTH / 2 * 0.55, PALM_LENGTH / 2 * 0.75, PALM_GRID[1])
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1), np.zeros(PALM_SPHERES)],
                    axis=-1).astype(np.float32)


def _radii() -> np.ndarray:
    radii = [np.full((PALM_SPHERES,), PALM_THICKNESS * 0.75, np.float32)]
    for radius in FINGER_RADII:
        r = []
        for bone in range(BONES):
            r.extend([radius * (1.0 - 0.15 * bone)] * SPHERES_PER_BONE)
        r.append(radius * 0.85)
        radii.append(np.asarray(r, np.float32))
    radii.append(np.zeros(NUM_SPHERES - SPHERES_RAW, np.float32))
    return np.concatenate(radii)


def geometry(device: torch.device | str, dtype: torch.dtype = torch.float32) -> Geometry:
    """The constants, worked out in float32 and then held in ``dtype``."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    z_axis = f32([0.0, 0.0, 1.0])
    rest = f32(FINGER_DIRS)
    rest = rest / torch.linalg.vector_norm(rest, dim=-1, keepdim=True)
    flex = torch.linalg.cross(z_axis.expand_as(rest), rest, dim=-1)
    flex = flex / (torch.linalg.vector_norm(flex, dim=-1, keepdim=True) + 1e-12)
    lengths = np.asarray(BONE_LENGTHS, np.float64)
    fracs = (np.arange(SPHERES_PER_BONE) + 1.0) / SPHERES_PER_BONE
    lo, hi = _angle_bounds()
    geo = Geometry(
        palm_centers=f32(_palm_centers()), radii=f32(_radii()), bases=f32(FINGER_BASES),
        rest_dirs=rest, flex_axes=flex, z_axis=z_axis,
        sphere_offsets=f32(lengths[:, :, None] * fracs), bone_lengths=f32(lengths),
        tip_offsets=f32(np.asarray(FINGER_RADII) * 0.5), angle_lo=f32(lo), angle_hi=f32(hi))
    return Geometry(*(t.to(dtype) for t in geo))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v rotated by the unit quaternion q: v + 2 w (u x v) + 2 u x (u x v)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    axis = axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-12)
    half = angle * 0.5
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1)


def spheres(h: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(..., 48, 4) packed [cx, cy, cz, r] in camera coordinates for the
    configurations h (..., 27); the quaternion is normalized first."""
    angles = torch.minimum(torch.maximum(h[..., ANGLES], geo.angle_lo), geo.angle_hi)
    batch = angles.shape[:-1]
    fa = angles.reshape(*batch, FINGERS, ANGLES_PER_FINGER)
    q = quat_from_axis_angle(geo.z_axis, fa[..., 0])  # abduction, (..., 5, 4)
    pos = geo.bases.expand(*batch, -1, -1)
    centers = []
    for bone in range(BONES):
        q = quat_multiply(q, quat_from_axis_angle(geo.flex_axes, fa[..., 1 + bone]))
        direction = quat_rotate(quat_normalize(q), geo.rest_dirs)  # (..., 5, 3)
        for k in range(SPHERES_PER_BONE):
            centers.append(pos + direction * geo.sphere_offsets[:, bone, k, None])
        pos = pos + direction * geo.bone_lengths[:, bone, None]
    centers.append(pos + direction * geo.tip_offsets[:, None])
    fingers = torch.stack(centers, dim=-2).reshape(*batch, FINGERS * (BONES * SPHERES_PER_BONE + 1), 3)
    palm = geo.palm_centers.expand(*batch, -1, -1)
    pad = fingers.new_zeros(*batch, NUM_SPHERES - SPHERES_RAW, 3)
    local = torch.cat([palm, fingers, pad], dim=-2)
    quat = quat_normalize(h[..., QUAT])
    world = quat_rotate(quat[..., None, :], local) + h[..., None, POS]
    return torch.cat([world, geo.radii.expand(*batch, -1)[..., None]], dim=-1)


def normalize_configuration(h: torch.Tensor) -> torch.Tensor:
    """h with its quaternion block renormalized."""
    return torch.cat([h[..., POS], quat_normalize(h[..., QUAT]), h[..., ANGLES]], dim=-1)


def search_box(center: torch.Tensor, geo: Geometry, pos_range: float,
               quat_range: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The PSO's (lo, hi) around the previous frame's solution."""
    lo = torch.cat([center[POS] - pos_range, center[QUAT] - quat_range,
                    torch.maximum(center[ANGLES] - 0.6, geo.angle_lo)])
    hi = torch.cat([center[POS] + pos_range, center[QUAT] + quat_range,
                    torch.minimum(center[ANGLES] + 0.6, geo.angle_hi)])
    return lo, hi
