"""Plain PyTorch oracles for the pso_update kernels K2 and K2b (mirror
the swarm update of ``repro.core.pso.swarm_step``), and for their
launches with the quaternion projection (the update followed by
``handmodel.normalize_configuration``, as the tracker's generation
runs it)."""

from __future__ import annotations

import torch

from repro_torch.core import handmodel


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


def pso_update_batched(
    x, v, pbest, gbest, r1, r2, lo, hi,
    *, inertia: float, cognitive: float, social: float, velocity_clip: float,
):
    """(x, v, pbest, r1, r2) (B, N, D); gbest (B, D); (lo, hi) (D,) or
    (B, D) -> (x', v'), both (B, N, D).  The unbatched math per swarm."""
    b, _, d = x.shape
    x = x.float()
    lo = torch.broadcast_to(lo.float(), (b, d))[:, None, :]
    hi = torch.broadcast_to(hi.float(), (b, d))[:, None, :]
    vel = (
        inertia * v.float()
        + cognitive * r1.float() * (pbest.float() - x)
        + social * r2.float() * (gbest[:, None].float() - x)
    )
    vmax = velocity_clip * (hi - lo)
    vel = torch.minimum(torch.maximum(vel, -vmax), vmax)
    pos = torch.minimum(torch.maximum(x + vel, lo), hi)
    return pos, vel


def pso_update_projected(
    x, v, pbest, gbest, r1, r2, lo, hi,
    *, inertia: float, cognitive: float, social: float, velocity_clip: float,
):
    """``pso_update`` followed by ``handmodel.normalize_configuration`` of x'."""
    pos, vel = pso_update(x, v, pbest, gbest, r1, r2, lo, hi, inertia=inertia,
                          cognitive=cognitive, social=social, velocity_clip=velocity_clip)
    return handmodel.normalize_configuration(pos), vel


def pso_update_projected_batched(
    x, v, pbest, gbest, r1, r2, lo, hi,
    *, inertia: float, cognitive: float, social: float, velocity_clip: float,
):
    """``pso_update_batched`` followed by ``handmodel.normalize_configuration`` of x'."""
    pos, vel = pso_update_batched(x, v, pbest, gbest, r1, r2, lo, hi, inertia=inertia,
                                  cognitive=cognitive, social=social,
                                  velocity_clip=velocity_clip)
    return handmodel.normalize_configuration(pos), vel
