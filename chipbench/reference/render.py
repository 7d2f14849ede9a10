"""The paper's objective E_D (Eq. 2) in plain torch: sphere ray-casting
and the masked, clamped L1 distance to the observed depth.

    E_D(h, d_o) = sum_{p in B} min(|d_h(p) - d_o(p)|, T) / max(|B|, 1)

A frozen copy of the program's objective.  It scores the pixels of the
bounding box B only: with a finite depth, a finite clamp T and a finite
background, a pixel outside B adds exactly +0 to the program's sum over
all pixels, so the two are the same function.  A frame with a depth that
is not finite is refused (``ValueError``), since there the two differ.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from chipbench.reference import hand


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole intrinsics; the rays have d_z = 1, so t is metric depth."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    def rays(self, device: torch.device | str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(H * W, 3) ray directions, in row-major pixel order."""
        u = (torch.arange(self.width, dtype=torch.float32, device=device) - self.cx) / self.fx
        v = (torch.arange(self.height, dtype=torch.float32, device=device) - self.cy) / self.fy
        gu, gv = torch.meshgrid(u, v, indexing="xy")
        return torch.stack([gu, gv, torch.ones_like(gu)], dim=-1).reshape(-1, 3).to(dtype)


def sphere_depth(rays: torch.Tensor, spheres: torch.Tensor, background: float) -> torch.Tensor:
    """Depth of the nearest sphere along each ray: rays (P, 3), spheres
    (..., S, 4) -> (..., P); ``background`` where no sphere is hit.  The
    near root t = (d.c - sqrt((d.c)^2 - |d|^2 (|c|^2 - r^2))) / |d|^2 of
    a hit with a non-negative discriminant and t > 1e-4."""
    d2 = torch.sum(rays * rays, dim=-1)[:, None]  # (P, 1)
    c = spheres[..., None, :, :3]  # (..., 1, S, 3)
    r = spheres[..., None, :, 3]  # (..., 1, S)
    dc = (rays[:, 0, None] * c[..., 0] + rays[:, 1, None] * c[..., 1]
          + rays[:, 2, None] * c[..., 2])  # (..., P, S)
    c2r2 = torch.sum(c * c, dim=-1) - r * r
    disc = dc * dc - d2 * c2r2
    t = (dc - torch.sqrt(torch.clamp(disc, min=0.0))) / d2
    hit = (disc >= 0.0) & (t > 1e-4)
    t = torch.where(hit, t, background)
    return torch.amin(t, dim=-1)


class Objective:
    """E_D on one frame: the box B of pixels within ``half_width`` of the
    previous solution's depth, and the rays and depths of those pixels."""

    def __init__(self, rays: torch.Tensor, depth: torch.Tensor, center_depth: torch.Tensor,
                 half_width: float, clamp_t: float, background: float):
        depth = depth.reshape(-1)
        if not bool(torch.isfinite(depth).all()):
            raise ValueError("a depth that is not finite: E_D is then not a sum over B")
        keep = torch.abs(depth - center_depth) < half_width
        self.count = int(keep.sum())
        self.rays = rays[keep]
        self.depth = depth[keep].to(rays.dtype)
        self.clamp_t, self.background = clamp_t, background

    def __call__(self, h: torch.Tensor, geo: hand.Geometry) -> torch.Tensor:
        """E_D of configurations h (..., 27) -> (...)."""
        d_h = sphere_depth(self.rays, hand.spheres(h, geo), self.background)
        err = torch.clamp(torch.abs(d_h - self.depth), max=self.clamp_t)
        return torch.sum(err, dim=-1) / max(self.count, 1)


def clip_depth(rays: torch.Tensor, truth: torch.Tensor, geo: hand.Geometry, background: float,
               shape: Tuple[int, int], block: int = 8) -> torch.Tensor:
    """Noiseless depth maps (T, H, W) of configurations truth (T, 27),
    rendered ``block`` frames at a time."""
    maps = [sphere_depth(rays, hand.spheres(h, geo), background) for h in truth.split(block)]
    return torch.cat(maps).reshape(truth.shape[0], *shape)
