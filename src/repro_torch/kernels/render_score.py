"""Population render + E_D scoring: the CUDA kernel K1 and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/render_score.py:
render_score_sums``.  For every particle it renders the hand's spheres
along every camera ray and sums the masked clamped-L1 distance to the
observed depth: spheres (N, S, 4), rays (P, 3), depth (P,), mask (P,)
give sums (N,).

The kernel is ``csrc/render_score.cu``, which says what bounds it on an
H100 (operations) and how its design answers that.  For a CUDA tensor
the wrapper launches it, or raises; for a CPU tensor it runs the plain
version, ``render_score_sums_plain`` (the oracle in ``kernels/ref.py``).
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.camera import BACKGROUND_DEPTH
from repro_torch.core.objective import CLAMP_T
from repro_torch.kernels import _build
from repro_torch.kernels.ref import render_score_sums as render_score_sums_plain

# Launches of the CUDA kernel since the count was last set to 0.
launches = 0

# Spheres per particle a block stages in shared memory (16 B each).
MAX_SPHERES = 2048


def render_score_sums(
    spheres: torch.Tensor,  # (N, S, 4)
    rays: torch.Tensor,  # (P, 3)
    depth_obs: torch.Tensor,  # (P,)
    mask: torch.Tensor,  # (P,) float or bool
    *,
    clamp_t: float = CLAMP_T,
) -> torch.Tensor:
    """Unnormalized masked score sums per particle, shape (N,), float32.

    Any N and P: the kernel masks the ragged pixel edge itself
    (``ops.render_score`` pads as the reference does before it calls
    this).
    """
    if not spheres.is_cuda:
        return render_score_sums_plain(spheres, rays, depth_obs, mask, clamp_t=clamp_t)
    global launches
    device = spheres.device
    n, s, four = spheres.shape
    p = rays.shape[0]
    if four != 4 or rays.shape != (p, 3) or depth_obs.shape != (p,) or mask.shape != (p,):
        raise ValueError(
            f"shapes spheres {tuple(spheres.shape)}, rays {tuple(rays.shape)}, "
            f"depth {tuple(depth_obs.shape)}, mask {tuple(mask.shape)}: expected "
            "(N, S, 4), (P, 3), (P,), (P,)"
        )
    if not 0 < s <= MAX_SPHERES or n > 65535:
        raise ValueError(f"the kernel takes 1..{MAX_SPHERES} spheres and <= 65535 particles")
    out = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0 or p == 0:
        return out.zero_()
    if mask.dtype == torch.bool:
        mask = mask.to(torch.float32)
    args = [_build.kernel_input(name, t, device) for name, t in (
        ("spheres", spheres), ("rays", rays), ("depth_obs", depth_obs), ("mask", mask))]
    lib = _build.library()
    tiles = -(-p // lib.render_score_tile_pixels())
    partial = torch.empty((n, tiles), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = lib.render_score_sums_launch(
            *(t.data_ptr() for t in args), partial.data_ptr(), out.data_ptr(),
            n, s, p, clamp_t, BACKGROUND_DEPTH, _build.stream_handle(device))
    _build.check(err, "render_score_sums")
    launches += 1
    return out
