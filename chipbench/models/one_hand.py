"""The one-hand tracker of arXiv:1804.11256 as the benchmark judges it:
27 parameters and 48 spheres a particle, the box of pixels around the
previous pose's depth, the particle swarm and the smoothing step.

The model's names (``chipbench/manifest.py`` lists them) bound to the
frozen files beside the harness: ``reference/`` (the plain frame),
``clip.py`` (the clip) and ``work.py`` (the counts).
"""

from __future__ import annotations

import torch

from chipbench import clip, work
from chipbench.reference import frame, hand
from chipbench.reference.frame import FrameConfig, Reference  # noqa: F401  (the model's names)


def frame_config(config: dict) -> FrameConfig:
    return FrameConfig.from_file(config)


def make_clip(traffic: dict, cfg: FrameConfig, generator: torch.Generator):
    return clip.make_clip(clip.ClipConfig.from_traffic(traffic), cfg.camera, cfg.background,
                          generator)


def kept_pixels(cfg: FrameConfig, depth: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """The box around each previous pose's depth, h_prev[..., 2]."""
    return work.kept_pixels(depth, h_prev[..., 2], cfg.bbox_half_width)


def solution_of(cfg: FrameConfig, h_next: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    return frame.solution_of(h_next, h_prev, cfg.smoothing)


def k1_ops(cfg: FrameConfig, kept: int) -> int:
    """K1's operations in one frame: its 1 + G population evaluations."""
    return (1 + cfg.num_generations) * work.k1_ops(cfg.num_particles, kept, hand.NUM_SPHERES)


def frame_ops(cfg: FrameConfig, kept: int) -> int:
    return work.frame_ops(cfg.num_particles, cfg.num_generations, kept, hand.NUM_SPHERES)
