"""Fused PSO swarm update: the CUDA kernel K2 and its wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/pso_update.py:
pso_update``: the Clerc–Kennedy velocity and position update over the
(N, D) swarm plane,

    v' = clip(w v + c1 r1 (pbest - x) + c2 r2 (gbest - x), +-vclip (hi - lo))
    x' = clip(x + v', lo, hi)

The kernel is ``csrc/pso_update.cu``, which says what bounds it on an
H100 (bytes, and at the tracker's 64 x 27 the launch).  For a CUDA
tensor the wrapper launches it, or raises; for a CPU tensor it runs the
plain version, ``pso_update_plain`` (the oracle in ``kernels/pso_ref.py``).
The reference asserts ``N % block_n == 0``; here any N works, since the
kernel masks the ragged edge and so needs no padding.  ``launches``
counts the kernel's launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pso_ref import pso_update as pso_update_plain

# Launches of the CUDA kernel since the count was last set to 0.
launches = 0


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
    global launches
    device = x.device
    n, d = x.shape
    for name, t in (("v", v), ("pbest", pbest), ("r1", r1), ("r2", r2)):
        if t.shape != (n, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(n, d)}")
    for name, t in (("gbest", gbest), ("lo", lo), ("hi", hi)):
        if t.shape != (d,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(d,)}")
    if n * d >= 2**31:
        raise ValueError("the kernel indexes the swarm plane with 32-bit ints")
    x_out = torch.empty((n, d), dtype=torch.float32, device=device)
    v_out = torch.empty_like(x_out)
    if n * d == 0:
        return x_out, v_out
    args = [_build.kernel_input(name, t, device) for name, t in (
        ("x", x), ("v", v), ("pbest", pbest), ("gbest", gbest), ("r1", r1),
        ("r2", r2), ("lo", lo), ("hi", hi))]
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.pso_update_launch(
            *(t.data_ptr() for t in args), x_out.data_ptr(), v_out.data_ptr(),
            n, d, inertia, cognitive, social, velocity_clip,
            _build.stream_handle(device))
    _build.check(err, "pso_update")
    launches += 1
    return x_out, v_out
