"""The clip every client's camera sees: a synthetic RGBD hand-motion
sequence, made on the device from the run's seed.

A frozen copy of the program's synthetic generator (its
``truth_trajectory``, the paper's "pre-recorded video" analogue): smooth
position sweeps, a wrist rotation about a wobbling axis, staggered finger
curls and a burst at three times the speed, rendered by the reference's
sphere renderer.  The trajectory is the same for every seed; the seed
draws the sensor noise, so every seed asks for the same work.  The clip
is played forward and then backward, so a client's pose stays continuous
when it loops.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from chipbench.reference import hand, render


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    num_frames: int
    base_distance: float  # meters from the camera
    position_amplitude: float
    rotation_amplitude: float  # radians
    curl_amplitude: float
    fast_burst: Tuple[int, int]  # frames [lo, hi) at 3x the speed
    noise_std: float  # meters

    @classmethod
    def from_traffic(cls, traffic: dict) -> "ClipConfig":
        clip = dict(traffic["clip"])
        clip["fast_burst"] = tuple(clip["fast_burst"])
        return cls(**clip)


def truth_trajectory(cfg: ClipConfig) -> np.ndarray:
    """(T, 27) float32 ground-truth configurations."""
    t = np.arange(cfg.num_frames, dtype=np.float64)
    speed = np.ones_like(t)
    lo, hi = cfg.fast_burst
    speed[(t >= lo) & (t < hi)] = 3.0
    phase = np.cumsum(speed) / 30.0  # seconds at 30 fps

    hs = np.zeros((cfg.num_frames, hand.NUM_PARAMS), np.float32)
    hs[:, 0] = cfg.position_amplitude * np.sin(2 * np.pi * 0.35 * phase)
    hs[:, 1] = cfg.position_amplitude * 0.6 * np.sin(2 * np.pi * 0.23 * phase + 1.0)
    hs[:, 2] = cfg.base_distance + 0.04 * np.sin(2 * np.pi * 0.17 * phase)
    ang = cfg.rotation_amplitude * np.sin(2 * np.pi * 0.3 * phase)
    axis = np.stack([np.sin(0.7 * phase), np.cos(0.9 * phase), 0.4 * np.ones_like(phase)],
                    axis=-1)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    hs[:, 3] = np.cos(ang / 2)
    hs[:, 4:7] = axis * np.sin(ang / 2)[:, None]
    for f in range(5):
        curl = 0.5 * cfg.curl_amplitude * (1 - np.cos(2 * np.pi * (0.4 + 0.05 * f) * phase + f))
        base = 7 + 4 * f
        hs[:, base + 1] = curl * 0.9
        hs[:, base + 2] = curl
        hs[:, base + 3] = curl * 0.7
    return hs


def loop_index(i: int, num_frames: int) -> int:
    """The clip frame shown at step i of the forward-backward loop."""
    period = 2 * num_frames - 2
    k = i % period
    return k if k < num_frames else period - k


def make_clip(cfg: ClipConfig, camera: render.Camera, background: float,
              generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(depth (T, H, W), truth (T, 27)) on the generator's device: the
    trajectory rendered, plus Gaussian noise drawn from ``generator``."""
    device = generator.device
    truth = torch.as_tensor(truth_trajectory(cfg), device=device)
    geo = hand.geometry(device)
    rays = camera.rays(device)
    depth = render.clip_depth(rays, truth, geo, background, (camera.height, camera.width))
    if cfg.noise_std > 0:
        depth = depth + cfg.noise_std * torch.randn(depth.shape, generator=generator,
                                                    device=device)
    return depth, truth
