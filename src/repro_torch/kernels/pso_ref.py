"""Plain PyTorch oracle for the pso_update kernel (mirrors the swarm
update of ``repro.core.pso.swarm_step``)."""

from __future__ import annotations

import torch


def pso_update(
    x, v, pbest, gbest, r1, r2, lo, hi,
    *, inertia: float, cognitive: float, social: float, velocity_clip: float,
):
    """(x, v, pbest, r1, r2) (N, D); (gbest, lo, hi) (D,) -> (x', v')."""
    x = x.float()
    lo = lo.float()
    hi = hi.float()
    vel = (
        inertia * v.float()
        + cognitive * r1.float() * (pbest.float() - x)
        + social * r2.float() * (gbest[None].float() - x)
    )
    vmax = velocity_clip * (hi - lo)
    vel = torch.minimum(torch.maximum(vel, -vmax[None]), vmax[None])
    pos = torch.minimum(torch.maximum(x + vel, lo[None]), hi[None])
    return pos, vel
