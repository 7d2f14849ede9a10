"""Fused PSO swarm update: the CUDA kernels K2 and K2b and their wrappers.

Replaces the Pallas TPU kernels ``repro/kernels/pso_update.py:
pso_update`` and ``pso_update_batched``: the Clerc–Kennedy velocity and
position update over the (N, D) swarm plane, or over B swarms at once,

    v' = clip(w v + c1 r1 (pbest - x) + c2 r2 (gbest - x), +-vclip (hi - lo))
    x' = clip(x + v', lo, hi)

The kernel is ``csrc/pso_update.cu``, which says what bounds it on an
H100 (bytes, and at the tracker's 64 x 27 the launch).  K2 is its B = 1
launch, so each swarm of K2b equals K2 on that swarm bit for bit.
``pso_update_projected`` and ``pso_update_projected_batched`` launch the
same kernel with the tracker's quaternion projection fused after the
update: the quaternion columns of x' (``handmodel.QUAT_SLICE``)
renormalized, as ``handmodel.normalize_configuration`` does, so a
generation's update is one launch.  For a CUDA tensor a wrapper
launches the kernel, or raises; for a CPU tensor it runs the plain
version (the oracles in ``kernels/pso_ref.py``).  The reference asserts ``N % block_n == 0``;
here any N works, since the kernel masks the ragged edge and so needs
no padding.  ``launches`` counts K2's launches, ``launches_batched``
K2b's, and ``launches_projected`` those of either with the projection.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pso_ref import pso_update as pso_update_plain
from repro_torch.kernels.pso_ref import pso_update_batched as pso_update_batched_plain
from repro_torch.kernels.pso_ref import pso_update_projected as pso_update_projected_plain
from repro_torch.kernels.pso_ref import (
    pso_update_projected_batched as pso_update_projected_batched_plain,
)

# Launches of the CUDA kernel since the count was last set to 0: by
# pso_update and pso_update_projected (K2), by the grid paths of
# pso_update_batched and pso_update_projected_batched (K2b), and, of
# those, the launches with the quaternion projection.  A launch made
# while a CUDA graph captures counts once, here; the graph's replays run
# it without the wrapper (``core.tracker.FrameGraphs``).
launches = 0
launches_batched = 0
launches_projected = 0


def _check_shape(name: str, t: torch.Tensor, *shapes) -> None:
    if tuple(t.shape) not in shapes:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         + " or ".join(str(s) for s in shapes))


def _check_batched(x, v, pbest, gbest, r1, r2, lo, hi) -> None:
    b, n, d = x.shape
    for name, t in (("v", v), ("pbest", pbest), ("r1", r1), ("r2", r2)):
        _check_shape(name, t, (b, n, d))
    _check_shape("gbest", gbest, (b, d))
    _check_shape("lo", lo, (d,), (b, d))
    _check_shape("hi", hi, tuple(lo.shape))


def _launch(x, v, pbest, gbest, r1, r2, lo, hi, bound_stride, consts, project):
    """One launch over x's (B, N, D) swarms; every input already checked
    against that shape; ``project`` renormalizes the quaternion columns.
    Returns (x', v')."""
    device = x.device
    b, n, d = x.shape
    if b * n * d >= 2**31:
        raise ValueError("the kernel indexes the swarm planes with 32-bit ints")
    x_out = torch.empty((b, n, d), dtype=torch.float32, device=device)
    v_out = torch.empty_like(x_out)
    if b * n * d == 0:
        return x_out, v_out
    args = [_build.kernel_input(name, t, device) for name, t in (
        ("x", x), ("v", v), ("pbest", pbest), ("gbest", gbest), ("r1", r1),
        ("r2", r2), ("lo", lo), ("hi", hi))]
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.pso_update_launch(
            *(t.data_ptr() for t in args), x_out.data_ptr(), v_out.data_ptr(),
            b, n, d, bound_stride, int(project), consts["inertia"], consts["cognitive"],
            consts["social"], consts["velocity_clip"], _build.stream_handle(device))
    _build.check(err, "pso_update")
    return x_out, v_out


def _launch_one(args, consts, project):
    """K2: one launch over the (N, D) swarm of ``args`` = (x, v, pbest,
    gbest, r1, r2, lo, hi), counted.  Returns (x', v')."""
    global launches, launches_projected
    x, v, pbest, gbest, r1, r2, lo, hi = args
    n, d = x.shape
    for name, t in (("v", v), ("pbest", pbest), ("r1", r1), ("r2", r2)):
        _check_shape(name, t, (n, d))
    for name, t in (("gbest", gbest), ("lo", lo), ("hi", hi)):
        _check_shape(name, t, (d,))
    x_out, v_out = _launch(*(t[None] for t in args[:6]), lo, hi, 0, consts, project)
    if n * d:
        launches += 1
        launches_projected += project
    return x_out[0], v_out[0]


def _launch_batched(args, consts, project):
    """K2b: one launch over the (B, N, D) swarms of ``args``, already
    checked, counted.  Returns (x', v')."""
    global launches_batched, launches_projected
    b, n, d = args[0].shape
    x_out, v_out = _launch(*args, d if args[6].dim() == 2 else 0, consts, project)
    if b * n * d:
        launches_batched += 1
        launches_projected += project
    return x_out, v_out


def pso_update(
    x: torch.Tensor,  # (N, D)
    v: torch.Tensor,
    pbest: torch.Tensor,
    gbest: torch.Tensor,  # (D,)
    r1: torch.Tensor,
    r2: torch.Tensor,
    lo: torch.Tensor,  # (D,)
    hi: torch.Tensor,
    *,
    inertia: float,
    cognitive: float,
    social: float,
    velocity_clip: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (new_positions, new_velocities), both (N, D) float32."""
    consts = dict(inertia=inertia, cognitive=cognitive, social=social,
                  velocity_clip=velocity_clip)
    if not x.is_cuda:
        return pso_update_plain(x, v, pbest, gbest, r1, r2, lo, hi, **consts)
    return _launch_one((x, v, pbest, gbest, r1, r2, lo, hi), consts, False)


def pso_update_projected(
    x: torch.Tensor,  # (N, D)
    v: torch.Tensor,
    pbest: torch.Tensor,
    gbest: torch.Tensor,  # (D,)
    r1: torch.Tensor,
    r2: torch.Tensor,
    lo: torch.Tensor,  # (D,)
    hi: torch.Tensor,
    *,
    inertia: float,
    cognitive: float,
    social: float,
    velocity_clip: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pso_update``, then the quaternion columns of the new positions
    renormalized (``handmodel.normalize_configuration``), in one launch.  Returns (new_positions,
    new_velocities), both (N, D) float32."""
    consts = dict(inertia=inertia, cognitive=cognitive, social=social,
                  velocity_clip=velocity_clip)
    if not x.is_cuda:
        return pso_update_projected_plain(x, v, pbest, gbest, r1, r2, lo, hi, **consts)
    return _launch_one((x, v, pbest, gbest, r1, r2, lo, hi), consts, True)


def pso_update_batched(
    x: torch.Tensor,  # (B, N, D)
    v: torch.Tensor,
    pbest: torch.Tensor,
    gbest: torch.Tensor,  # (B, D): one global best per swarm
    r1: torch.Tensor,
    r2: torch.Tensor,
    lo: torch.Tensor,  # (D,) or (B, D)
    hi: torch.Tensor,
    *,
    inertia: float,
    cognitive: float,
    social: float,
    velocity_clip: float,
    path: str = "grid",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B swarms updated together: (new_positions, new_velocities), both
    (B, N, D) float32.

    ``path="grid"`` is one launch of the kernel over all B swarms (K2b);
    ``path="vmap"`` runs ``pso_update`` on each swarm and stacks the
    results (``torch.vmap`` cannot map a ctypes launch), the reference's
    comparison path.  On the CPU both run the plain versions.
    """
    consts = dict(inertia=inertia, cognitive=cognitive, social=social,
                  velocity_clip=velocity_clip)
    if path not in ("grid", "vmap"):
        raise ValueError(f"unknown path {path!r}")
    _check_batched(x, v, pbest, gbest, r1, r2, lo, hi)
    b, n, d = x.shape
    if path == "vmap":
        lo_b, hi_b = torch.broadcast_to(lo, (b, d)), torch.broadcast_to(hi, (b, d))
        outs = [pso_update(x[i], v[i], pbest[i], gbest[i], r1[i], r2[i],
                           lo_b[i], hi_b[i], **consts) for i in range(b)]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    if not x.is_cuda:
        return pso_update_batched_plain(x, v, pbest, gbest, r1, r2, lo, hi, **consts)
    return _launch_batched((x, v, pbest, gbest, r1, r2, lo, hi), consts, False)


def pso_update_projected_batched(
    x: torch.Tensor,  # (B, N, D)
    v: torch.Tensor,
    pbest: torch.Tensor,
    gbest: torch.Tensor,  # (B, D)
    r1: torch.Tensor,
    r2: torch.Tensor,
    lo: torch.Tensor,  # (D,) or (B, D)
    hi: torch.Tensor,
    *,
    inertia: float,
    cognitive: float,
    social: float,
    velocity_clip: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pso_update_batched`` with the quaternion projection of
    ``pso_update_projected``, all B swarms in one launch (K2b); each
    swarm equals ``pso_update_projected`` on that swarm bit for bit."""
    consts = dict(inertia=inertia, cognitive=cognitive, social=social,
                  velocity_clip=velocity_clip)
    _check_batched(x, v, pbest, gbest, r1, r2, lo, hi)
    if not x.is_cuda:
        return pso_update_projected_batched_plain(x, v, pbest, gbest, r1, r2, lo, hi,
                                                  **consts)
    return _launch_batched((x, v, pbest, gbest, r1, r2, lo, hi), consts, True)
