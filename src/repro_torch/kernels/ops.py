"""Public wrapper around the render_score kernel.

Keeps the reference wrapper's behaviour that callers can observe:
particles are padded with zeros to a multiple of ``block_n``, pixels to
a multiple of ``block_p`` with well-formed rays (d_z = 1) and mask 0,
the sums are cropped back to N, and each is divided by
``max(sum(mask), 1)`` over the unpadded mask.  This is the drop-in for
``objective.batched_objective`` that the tracker takes on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.objective import CLAMP_T
from repro_torch.kernels import render_score as _kernel

# The reference kernel's tile sizes, kept as the padding granularity.
DEFAULT_BLOCK_N = 8
DEFAULT_BLOCK_P = 512


def _pad_to(x: torch.Tensor, size: int, value: float = 0.0) -> torch.Tensor:
    """Pad axis 0 of x with ``value`` up to ``size``."""
    pad = size - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_full((pad, *x.shape[1:]), value)])


def render_score(
    spheres: torch.Tensor,  # (N, S, 4)
    rays: torch.Tensor,  # (P, 3)
    depth_obs: torch.Tensor,  # (P,)
    mask: torch.Tensor,  # (P,)
    *,
    block_n: int = DEFAULT_BLOCK_N,
    block_p: int = DEFAULT_BLOCK_P,
    clamp_t: float = CLAMP_T,
) -> torch.Tensor:
    """Normalized E_D per particle, shape (N,). Matches ref.render_score."""
    n = spheres.shape[0]
    p = rays.shape[0]
    mask = mask.to(torch.float32)
    n_pad = -(-n // block_n) * block_n
    p_pad = -(-p // block_p) * block_p
    spheres_p = _pad_to(spheres, n_pad)
    if p_pad != p:
        pad_rays = rays.new_zeros((p_pad - p, 3))
        pad_rays[:, 2] = 1.0
        rays_p = torch.cat([rays, pad_rays])
    else:
        rays_p = rays
    sums = _kernel.render_score_sums(
        spheres_p, rays_p, _pad_to(depth_obs, p_pad), _pad_to(mask, p_pad),
        clamp_t=clamp_t,
    )[:n]
    return sums / torch.clamp(torch.sum(mask), min=1.0)
