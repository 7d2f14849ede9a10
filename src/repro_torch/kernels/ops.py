"""Public wrappers around the render_score kernels.

Keep the reference wrappers' behaviour that callers can observe:
particles are padded with zeros to a multiple of ``block_n``, pixels to
a multiple of ``block_p`` with well-formed rays (d_z = 1) and mask 0,
the sums are cropped back to N, and each is divided by
``max(sum(mask), 1)`` over the unpadded mask (per client, in the
batched wrapper).  ``render_score`` is the drop-in for
``objective.batched_objective`` that the tracker takes on the card;
``render_score_batched`` scores B clients' populations in one launch,
as the edge server does.
"""

from __future__ import annotations

import torch

from repro_torch.core.objective import CLAMP_T
from repro_torch.kernels import render_score as _kernel

# The reference kernel's tile sizes, kept as the padding granularity.
DEFAULT_BLOCK_N = 8
DEFAULT_BLOCK_P = 512


def _pad_to(x: torch.Tensor, size: int, axis: int, value: float = 0.0) -> torch.Tensor:
    """Pad ``axis`` of x with ``value`` up to ``size``."""
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def _pad_render_inputs(spheres, rays, depth_obs, mask, block_n, block_p):
    """Pad particles and pixels to block multiples.  The particle and
    pixel axes are found from the trailing dimensions, so the unbatched
    (N, ...)/(P, ...) and batched (B, N, ...)/(B, P, ...) wrappers share
    one copy of the padding rules."""
    n_axis = spheres.dim() - 3  # (..., N, S, 4)
    p_axis = rays.dim() - 2  # (..., P, 3)
    n_pad = -(-spheres.shape[n_axis] // block_n) * block_n
    p_pad = -(-rays.shape[p_axis] // block_p) * block_p
    # Padding rays are well-formed directions (d_z = 1), so the kernel
    # never divides by |d|^2 = 0; their mask is 0, so they score nothing.
    if p_pad != rays.shape[p_axis]:
        pad_rays = rays.new_zeros((*rays.shape[:p_axis], p_pad - rays.shape[p_axis], 3))
        pad_rays[..., 2] = 1.0
        rays = torch.cat([rays, pad_rays], dim=p_axis)
    return (_pad_to(spheres, n_pad, n_axis), rays,
            _pad_to(depth_obs, p_pad, p_axis), _pad_to(mask, p_pad, p_axis))


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
    mask = mask.to(torch.float32)
    sums = _kernel.render_score_sums(
        *_pad_render_inputs(spheres, rays, depth_obs, mask, block_n, block_p),
        clamp_t=clamp_t,
    )[:n]
    return sums / torch.clamp(torch.sum(mask), min=1.0)


def render_score_batched(
    spheres: torch.Tensor,  # (B, N, S, 4)
    rays: torch.Tensor,  # (B, P, 3)
    depth_obs: torch.Tensor,  # (B, P)
    mask: torch.Tensor,  # (B, P)
    *,
    block_n: int = DEFAULT_BLOCK_N,
    block_p: int = DEFAULT_BLOCK_P,
    clamp_t: float = CLAMP_T,
) -> torch.Tensor:
    """Normalized E_D per (client, particle), shape (B, N): B clients'
    populations scored in one kernel launch.  Each row divides by its
    own client's mask count, so row b equals ``render_score`` on client
    b alone."""
    n = spheres.shape[1]
    mask = mask.to(torch.float32)
    sums = _kernel.render_score_sums_batched(
        *_pad_render_inputs(spheres, rays, depth_obs, mask, block_n, block_p),
        clamp_t=clamp_t,
    )[:, :n]
    denom = torch.clamp(torch.sum(mask, dim=1, keepdim=True), min=1.0)
    return sums / denom
