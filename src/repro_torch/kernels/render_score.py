"""Population render + E_D scoring: the CUDA kernels K1 and K1b and their
wrappers.

Replaces the Pallas TPU kernels ``repro/kernels/render_score.py:
render_score_sums`` and ``render_score_sums_batched``.  For every
particle it renders the hand's spheres along every camera ray and sums
the masked clamped-L1 distance to the observed depth: spheres (N, S, 4),
rays (P, 3), depth (P,), mask (P,) give sums (N,); with a leading client
axis, (B, N, S, 4), (B, P, 3), (B, P), (B, P) give (B, N).

The kernel is ``csrc/render_score.cu``, which says what bounds it on an
H100 (the launch and the mask scan at the tracker's masks, fp32
operations on a dense one) and how its design answers that: it scores
only the pixels whose term can be non-zero (mask != 0, or a NaN depth,
which makes the sum NaN as in the reference; every pixel when
``background`` or ``clamp_t`` is not finite, since a masked-out term
can then be NaN), and closes each sum in one launch inside a cluster of
8 blocks.  K1 is its B = 1 launch, so each client's row of K1b equals
K1 on that client bit for bit.  For a
CUDA tensor a wrapper launches it, or raises; for a CPU tensor it runs
the plain version, ``render_score_sums_plain`` or
``render_score_sums_batched_plain`` (the oracles in ``kernels/ref.py``).
``launches`` counts K1's launches and ``launches_batched`` K1b's.
"""

from __future__ import annotations

import torch

from repro_torch.core.camera import BACKGROUND_DEPTH
from repro_torch.core.objective import CLAMP_T
from repro_torch.kernels import _build
from repro_torch.kernels.ref import render_score_sums as render_score_sums_plain
from repro_torch.kernels.ref import (
    render_score_sums_batched as render_score_sums_batched_plain,
)

# Launches of the CUDA kernel since the count was last set to 0: by
# render_score_sums (K1) and by render_score_sums_batched (K1b).  A
# launch made while a CUDA graph captures counts once, here; the graph's
# replays run it without the wrapper (``core.tracker.FrameGraphs``).
launches = 0
launches_batched = 0

# Spheres per particle a block stages in shared memory (16 B each),
# beside the kernel's 16.5 KB kept-pixel list, within the 48 KB a block
# gets without opting in to more.
MAX_SPHERES = 2000
# The kernel's grid puts particles on its y axis and clients on its z.
MAX_GRID_YZ = 65535


def _launch(spheres, rays, depth_obs, mask, clamp_t, background):
    """One launch over (B, N, S, 4), (B, P, 3), (B, P), (B, P) inputs;
    returns the (B, N) sums."""
    device = spheres.device
    b, n, s, four = spheres.shape
    p = rays.shape[1]
    if (four != 4 or rays.shape != (b, p, 3) or depth_obs.shape != (b, p)
            or mask.shape != (b, p)):
        raise ValueError(
            f"shapes spheres {tuple(spheres.shape)}, rays {tuple(rays.shape)}, "
            f"depth {tuple(depth_obs.shape)}, mask {tuple(mask.shape)}: expected "
            "(N, S, 4), (P, 3), (P,), (P,) with a common leading client axis "
            "for the batched kernel"
        )
    if not 0 < s <= MAX_SPHERES or n > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"the kernel takes 1..{MAX_SPHERES} spheres, and at most "
                         f"{MAX_GRID_YZ} particles and {MAX_GRID_YZ} clients")
    out = torch.empty((b, n), dtype=torch.float32, device=device)
    if b * n == 0 or p == 0:
        return out.zero_(), False
    if mask.dtype == torch.bool:
        mask = mask.to(torch.float32)
    args = [_build.kernel_input(name, t, device) for name, t in (
        ("spheres", spheres), ("rays", rays), ("depth_obs", depth_obs), ("mask", mask))]
    with torch.cuda.device(device):
        err = _build.library().render_score_sums_launch(
            *(t.data_ptr() for t in args), out.data_ptr(),
            b, n, s, p, clamp_t, background, _build.stream_handle(device))
    _build.check(err, "render_score_sums")
    return out, True


def render_score_sums(
    spheres: torch.Tensor,  # (N, S, 4)
    rays: torch.Tensor,  # (P, 3)
    depth_obs: torch.Tensor,  # (P,)
    mask: torch.Tensor,  # (P,) float or bool
    *,
    clamp_t: float = CLAMP_T,
    background: float = BACKGROUND_DEPTH,
) -> torch.Tensor:
    """Unnormalized masked score sums per particle, shape (N,), float32.
    A ray that hits no sphere renders ``background``.

    Any N and P: the kernel masks the ragged pixel edge itself
    (``ops.render_score`` pads as the reference does before it calls
    this).
    """
    if not spheres.is_cuda:
        return render_score_sums_plain(spheres, rays, depth_obs, mask, clamp_t=clamp_t,
                                       background=background)
    global launches
    if spheres.dim() != 3 or rays.dim() != 2:
        raise ValueError(f"shapes spheres {tuple(spheres.shape)}, rays "
                         f"{tuple(rays.shape)}: expected (N, S, 4), (P, 3)")
    out, launched = _launch(spheres[None], rays[None], depth_obs[None], mask[None],
                            clamp_t, background)
    launches += launched
    return out[0]


def render_score_sums_batched(
    spheres: torch.Tensor,  # (B, N, S, 4): one population per client
    rays: torch.Tensor,  # (B, P, 3)
    depth_obs: torch.Tensor,  # (B, P)
    mask: torch.Tensor,  # (B, P) float or bool
    *,
    clamp_t: float = CLAMP_T,
    background: float = BACKGROUND_DEPTH,
) -> torch.Tensor:
    """B clients' populations scored in one launch: unnormalized sums,
    shape (B, N), float32.  Any N and P, as ``render_score_sums``."""
    if not spheres.is_cuda:
        return render_score_sums_batched_plain(spheres, rays, depth_obs, mask,
                                               clamp_t=clamp_t, background=background)
    global launches_batched
    if spheres.dim() != 4:
        raise ValueError(f"spheres has shape {tuple(spheres.shape)}, "
                         "expected (B, N, S, 4)")
    out, launched = _launch(spheres, rays, depth_obs, mask, clamp_t, background)
    launches_batched += launched
    return out
