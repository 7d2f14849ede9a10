"""Synthetic RGBD hand-motion sequences (the "pre-recorded video").

The paper evaluates against a pre-recorded sequence "depicting various
challenging hand movements" so that all runs see identical input. This
module generates the analogous artifact: a deterministic ground-truth
trajectory of hand configurations (smooth position sweeps, wrist
rotation, finger curls, plus a configurable fast-motion burst), rendered
to depth maps by the same analytic sphere renderer the tracker uses.
Ground truth being known, tracking error is measurable exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import handmodel, objective
from repro_torch.core.camera import Camera


@dataclasses.dataclass(frozen=True)
class SequenceConfig:
    num_frames: int = 90
    camera: Camera = dataclasses.field(default_factory=Camera)
    base_distance: float = 0.5  # meters from camera
    position_amplitude: float = 0.06
    rotation_amplitude: float = 0.5  # radians
    curl_amplitude: float = 0.9
    fast_burst: Tuple[int, int] = (40, 55)  # frame range with 3x velocity
    noise_std: float = 0.002  # depth sensor noise, meters
    seed: int = 0


def truth_trajectory(cfg: SequenceConfig) -> np.ndarray:
    """(T, 27) float32 ground-truth hand configurations (numpy)."""
    t = np.arange(cfg.num_frames, dtype=np.float64)
    # time warp: the fast burst advances phase 3x faster
    speed = np.ones_like(t)
    lo, hi = cfg.fast_burst
    speed[(t >= lo) & (t < hi)] = 3.0
    phase = np.cumsum(speed) / 30.0  # seconds at 30 fps

    hs = np.zeros((cfg.num_frames, handmodel.NUM_PARAMS), np.float32)
    hs[:, 0] = cfg.position_amplitude * np.sin(2 * np.pi * 0.35 * phase)
    hs[:, 1] = cfg.position_amplitude * 0.6 * np.sin(2 * np.pi * 0.23 * phase + 1.0)
    hs[:, 2] = cfg.base_distance + 0.04 * np.sin(2 * np.pi * 0.17 * phase)
    # wrist rotation as axis-angle -> quaternion around a wobbling axis
    ang = cfg.rotation_amplitude * np.sin(2 * np.pi * 0.3 * phase)
    axis = np.stack(
        [np.sin(0.7 * phase), np.cos(0.9 * phase), 0.4 * np.ones_like(phase)],
        axis=-1,
    )
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    hs[:, 3] = np.cos(ang / 2)
    hs[:, 4:7] = axis * np.sin(ang / 2)[:, None]
    # finger curls: staggered sinusoids per finger, flexion channels only
    for f in range(5):
        curl = 0.5 * cfg.curl_amplitude * (
            1 - np.cos(2 * np.pi * (0.4 + 0.05 * f) * phase + f)
        )
        base = 7 + 4 * f
        hs[:, base + 1] = curl * 0.9
        hs[:, base + 2] = curl
        hs[:, base + 3] = curl * 0.7
    return hs


def render_sequence(
    cfg: SequenceConfig, device: torch.device | str = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (depth_frames (T, H, W), truth (T, 27)), both on ``device``.

    All frames render as one batch.  The sensor noise comes from
    ``np.random.default_rng(cfg.seed)`` and is cast to float32 before the
    add, as in the reference, so both packages see the same noise.
    """
    truth = torch.as_tensor(truth_trajectory(cfg), device=device)
    frames = objective.render_depth(truth, cfg.camera)
    if cfg.noise_std > 0:
        rng = np.random.default_rng(cfg.seed)
        noise = rng.normal(0.0, cfg.noise_std, size=tuple(frames.shape))
        frames = frames + torch.as_tensor(noise.astype(np.float32), device=device)
    return frames, truth
