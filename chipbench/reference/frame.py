"""One frame of the hand tracker in plain torch (paper §3.1, Fig. 2):
the bounding-box mask, the swarm spawned around the previous pose, the
PSO generations, and the smoothing step.

A frozen copy of the program's frame on given draws.  It takes the
inputs the benchmark hands the program (the previous pose, the depth map
and the frame's uniform draws) and works out the mask, the spheres and
the whole swarm again.  Every op runs in the dtype it is built with:
float32, the configuration's precision, for the reference; a lower one
for the control.

The draws of one frame are a tensor (1 + G, 2, N, 27): the spawn's
(u_pos, u_vel), then each generation's (r1, r2).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from chipbench.reference import hand, render


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    camera: render.Camera
    num_particles: int
    num_generations: int
    inertia: float
    cognitive: float
    social: float
    velocity_clip: float
    pos_range: float
    quat_range: float
    smoothing: float
    bbox_half_width: float
    clamp_t: float
    background: float

    @classmethod
    def from_file(cls, cfg: dict) -> "FrameConfig":
        """From a configuration file's groups: ``camera``, ``pso``,
        ``tracker`` and ``hand``.  Raises ``ValueError`` on what this
        frame does not compute."""
        pso, hand_cfg = cfg["pso"], cfg["hand"]
        if pso["restart_fraction"] != 0.0:
            raise ValueError("the reference frame has no stochastic restart")
        if (hand_cfg["num_params"], hand_cfg["num_spheres"]) != (hand.NUM_PARAMS, hand.NUM_SPHERES):
            raise ValueError(f"a hand of {hand_cfg['num_params']} parameters and "
                             f"{hand_cfg['num_spheres']} spheres; this one has "
                             f"{hand.NUM_PARAMS} and {hand.NUM_SPHERES}")
        return cls(camera=render.Camera(**cfg["camera"]),
                   num_particles=pso["num_particles"], num_generations=pso["num_generations"],
                   inertia=pso["inertia"], cognitive=pso["cognitive"], social=pso["social"],
                   velocity_clip=pso["velocity_clip"], clamp_t=hand_cfg["clamp_t"],
                   background=hand_cfg["background_depth"], **cfg["tracker"])

    @property
    def draws_shape(self) -> Tuple[int, ...]:
        return (1 + self.num_generations, 2, self.num_particles, hand.NUM_PARAMS)


class Reference:
    """The plain frame and E_D for one configuration, on one device and
    in one dtype."""

    def __init__(self, cfg: FrameConfig, device: torch.device | str,
                 dtype: torch.dtype = torch.float32):
        self.cfg, self.dtype = cfg, dtype
        self.geo = hand.geometry(device, dtype)
        self.rays = cfg.camera.rays(device, dtype)

    def objective(self, h_prev: torch.Tensor, depth: torch.Tensor) -> render.Objective:
        """E_D on ``depth`` in the box around ``h_prev``'s depth."""
        c = self.cfg
        return render.Objective(self.rays, depth.to(self.dtype), h_prev[2].to(self.dtype),
                                c.bbox_half_width, c.clamp_t, c.background)

    def frame(self, h_prev: torch.Tensor, depth: torch.Tensor,
              draws: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(h_next (27,), score ()) of one frame."""
        c, geo = self.cfg, self.geo
        h_prev, draws = h_prev.to(self.dtype), draws.to(self.dtype)
        if tuple(draws.shape) != c.draws_shape:
            raise ValueError(f"draws of shape {tuple(draws.shape)}, expected {c.draws_shape}")
        score = self.objective(h_prev, depth)
        lo, hi = hand.search_box(h_prev, geo, c.pos_range, c.quat_range)
        span = hi - lo
        u_pos, u_vel = draws[0]
        x = torch.cat([h_prev[None], (lo + u_pos * span)[1:]])  # particle 0 is h_prev
        v = (u_vel - 0.5) * span * 0.1
        pbest, pscore = x, score(x, geo)
        best = torch.argmin(pscore)  # the first on ties
        gbest, gscore = pbest[best], pscore[best]
        vmax = c.velocity_clip * (hi - lo)
        for r1, r2 in draws[1:]:
            v = (c.inertia * v + c.cognitive * r1 * (pbest - x)
                 + c.social * r2 * (gbest[None] - x))
            v = torch.minimum(torch.maximum(v, -vmax[None]), vmax[None])
            x = torch.minimum(torch.maximum(x + v, lo[None]), hi[None])
            x = hand.normalize_configuration(x)
            s = score(x, geo)
            improved = s < pscore
            pbest = torch.where(improved[:, None], x, pbest)
            pscore = torch.where(improved, s, pscore)
            best = torch.argmin(pscore)
            gbest, gscore = pbest[best], pscore[best]
        h = hand.normalize_configuration(gbest)
        h = (1.0 - c.smoothing) * h + c.smoothing * h_prev
        return hand.normalize_configuration(h), gscore

    def score(self, h: torch.Tensor, h_prev: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """E_D of the configuration h on the frame (depth, h_prev)."""
        return self.objective(h_prev, depth)(h.to(self.dtype), self.geo)


def solution_of(h_next: torch.Tensor, h_prev: torch.Tensor, smoothing: float) -> torch.Tensor:
    """The swarm's best pose g (quaternion normalized) that the smoothing
    step turned into h_next = n((1 - s) n(g) + s h_prev), n normalizing
    the quaternion block; in float64.  Position and angles invert
    linearly; the quaternion q_g is the unit solution of
    k q_next = (1 - s) q_g + s q_prev for the scale k > 0."""
    h_next, h_prev = h_next.double(), h_prev.double()
    a, b = 1.0 - smoothing, smoothing
    g = (h_next - b * h_prev) / a
    qn, qp = h_next[hand.QUAT], h_prev[hand.QUAT]
    dot = torch.dot(qn, qp)
    k = b * dot + torch.sqrt(b * b * dot * dot - b * b * torch.dot(qp, qp) + a * a)
    g[hand.QUAT] = (k * qn - b * qp) / a
    return g
