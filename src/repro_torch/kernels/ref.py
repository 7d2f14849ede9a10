"""Plain PyTorch oracles for the render_score kernels K1 and K1b.

Re-derive the quantity the kernels compute from the objective in
``repro_torch.core.objective``.  The wrappers in ``render_score`` run
them for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernels
against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.camera import BACKGROUND_DEPTH
from repro_torch.core.objective import CLAMP_T, _sphere_depth


def render_score_sums(
    spheres: torch.Tensor,  # (N, S, 4)
    rays: torch.Tensor,  # (P, 3)
    depth_obs: torch.Tensor,  # (P,)
    mask: torch.Tensor,  # (P,)
    *,
    clamp_t: float = CLAMP_T,
    background: float = BACKGROUND_DEPTH,
) -> torch.Tensor:
    """Unnormalized masked clamped-L1 sums per particle, shape (N,).  A
    ray that hits no sphere renders ``background``."""
    d_h = _sphere_depth(rays.float(), spheres.float(), background)  # (N, P)
    err = torch.clamp(torch.abs(d_h - depth_obs.float()), max=clamp_t)
    return torch.sum(err * mask.float(), dim=-1)


def render_score_sums_batched(
    spheres: torch.Tensor,  # (B, N, S, 4)
    rays: torch.Tensor,  # (B, P, 3)
    depth_obs: torch.Tensor,  # (B, P)
    mask: torch.Tensor,  # (B, P)
    *,
    clamp_t: float = CLAMP_T,
    background: float = BACKGROUND_DEPTH,
) -> torch.Tensor:
    """Unnormalized sums per (client, particle), shape (B, N): each
    client's row is ``render_score_sums`` on that client alone."""
    return torch.stack([render_score_sums(*args, clamp_t=clamp_t, background=background)
                        for args in zip(spheres, rays, depth_obs, mask)])


def render_score(
    spheres: torch.Tensor,
    rays: torch.Tensor,
    depth_obs: torch.Tensor,
    mask: torch.Tensor,
    *,
    clamp_t: float = CLAMP_T,
) -> torch.Tensor:
    """Normalized E_D per particle (mean over bbox pixels), shape (N,)."""
    sums = render_score_sums(spheres, rays, depth_obs, mask, clamp_t=clamp_t)
    return sums / torch.clamp(torch.sum(mask.float()), min=1.0)
