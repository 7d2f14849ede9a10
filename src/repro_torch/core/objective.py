"""The paper's objective function E_D (Eq. 2) and depth rendering.

    E_D(h, d^o) = (1 / N_P) * sum_{p in B} C(|d_p^h - d_p^o|, T)

where C(x, T) clamps at T = 30 cm to keep outliers from dominating, and B
is a bounding box containing the hand. The render is analytic sphere
ray-casting.

This module is the plain PyTorch version; the CUDA kernel behind
``repro_torch.kernels.render_score`` computes the same quantity, and
``repro_torch.kernels.ref`` builds the kernel's oracle from these
functions.  Every function takes leading batch dimensions: a population
``(N, 27)`` renders to ``(N, H, W)`` and scores to ``(N,)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import handmodel
from repro_torch.core.camera import BACKGROUND_DEPTH, Camera

CLAMP_T = 0.30  # meters — the paper sets T = 30 cm.


def sphere_depth(rays: torch.Tensor, spheres: torch.Tensor) -> torch.Tensor:
    """Analytic depth of the nearest sphere along each ray.

    Args:
      rays: (P, 3) ray directions with d_z == 1 (so t == metric depth).
      spheres: (..., S, 4) packed [cx, cy, cz, r].

    Returns:
      (..., P) depth map; BACKGROUND_DEPTH where no sphere is hit.

    Math: for ray x = t*d and sphere (c, r):
      t = [ (d.c) - sqrt((d.c)^2 - |d|^2 (|c|^2 - r^2)) ] / |d|^2
    The near root is taken; a negative discriminant or a behind-camera
    hit maps to BACKGROUND_DEPTH.  The K=3 dot is written as products
    and sums, not a matrix product, so no TF32 path can round it.
    """
    return _sphere_depth(rays, spheres, BACKGROUND_DEPTH)


def _sphere_depth(rays: torch.Tensor, spheres: torch.Tensor, background: float) -> torch.Tensor:
    """``sphere_depth`` with the miss depth as an argument, as the Pallas
    render/score kernel's ``_score_tile`` takes it (the plain versions in
    ``kernels/ref.py`` honour it).  ``torch.amin`` propagates a NaN
    background as ``jnp.min`` does."""
    d2 = torch.sum(rays * rays, dim=-1)[:, None]  # (P, 1)
    c = spheres[..., None, :, :3]  # (..., 1, S, 3)
    r = spheres[..., None, :, 3]  # (..., 1, S)
    dc = (rays[:, 0, None] * c[..., 0] + rays[:, 1, None] * c[..., 1]
          + rays[:, 2, None] * c[..., 2])  # (..., P, S)
    c2r2 = torch.sum(c * c, dim=-1) - r * r  # (..., 1, S)
    disc = dc * dc - d2 * c2r2
    t = (dc - torch.sqrt(torch.clamp(disc, min=0.0))) / d2
    hit = (disc >= 0.0) & (t > 1e-4)
    t = torch.where(hit, t, background)
    return torch.amin(t, dim=-1)


def render_depth(h: torch.Tensor, camera: Camera) -> torch.Tensor:
    """Depth maps (..., H, W) of hand configurations h (..., 27)."""
    spheres = handmodel.pack_spheres(h)
    depth = sphere_depth(camera.rays_flat(h.device), spheres)
    return depth.reshape(*h.shape[:-1], camera.height, camera.width)


def clamped_l1(d_h: torch.Tensor, d_o: torch.Tensor, t: float = CLAMP_T) -> torch.Tensor:
    """C(|d_h - d_o|, T) elementwise."""
    return torch.clamp(torch.abs(d_h - d_o), max=t)


def discrepancy(
    d_h: torch.Tensor,
    d_o: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    t: float = CLAMP_T,
) -> torch.Tensor:
    """E_D for rendered depth d_h against observed depth d_o.

    Args:
      d_h: (..., *d_o.shape) rendered depth; leading dims are a batch.
      d_o: observed depth map (flattened or 2D).
      mask: optional boolean bounding-box mask B shaped like d_o; True =
        inside B. When None, the whole frame is B.

    Returns:
      E_D over the trailing ``d_o.dim()`` axes: a scalar for one map,
      (N,) for a batch.
    """
    err = clamped_l1(d_h, d_o, t)
    dims = tuple(range(-d_o.dim(), 0))
    if mask is None:
        return torch.mean(err, dim=dims)
    msk = mask.to(err.dtype)
    return torch.sum(err * msk, dim=dims) / torch.clamp(torch.sum(msk), min=1.0)


def objective(
    h: torch.Tensor,
    d_o: torch.Tensor,
    camera: Camera,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """E_D(h, o): render h (..., 27) and score against the observation."""
    return discrepancy(render_depth(h, camera), d_o, mask)


def batched_objective(
    hs: torch.Tensor,
    d_o: torch.Tensor,
    camera: Camera,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """E_D over a particle population. hs: (N, 27) -> (N,).

    This is the population evaluation the paper offloads; the CUDA
    kernel path (``repro_torch.kernels.ops.render_score``) computes the
    same thing without the (N, P, S) intermediates.
    """
    return objective(hs, d_o, camera, mask)


def bounding_box_mask(
    d_o: torch.Tensor, center_depth: torch.Tensor | float, half_width: float = 0.25
) -> torch.Tensor:
    """Bounding-box B extraction: pixels whose observed depth lies within
    ``half_width`` meters of the previous solution's depth."""
    return torch.abs(d_o - center_depth) < half_width
