"""Pinhole RGBD camera model (paper §3.1: camera calibration parameters).

Only the depth channel enters Eq. (2); rays are built once per camera
and device and reused for every particle and every frame.
"""

from __future__ import annotations

import dataclasses

import torch

# Far-plane depth used for "no hit" pixels, meters: keeps |d_h - d_o|
# saturated at the clamp T for misrendered pixels.
BACKGROUND_DEPTH = 10.0


@dataclasses.dataclass(frozen=True)
class Camera:
    """Intrinsics of the RGBD sensor. Defaults approximate a Kinect-class
    sensor downsampled to the tracker's working resolution."""

    width: int = 128
    height: int = 128
    fx: float = 110.0
    fy: float = 110.0
    cx: float = 63.5
    cy: float = 63.5

    def rays(self, device: torch.device | str = "cuda") -> torch.Tensor:
        """Unnormalized ray directions d with d_z == 1, shape (H, W, 3).

        With d_z == 1 the ray parameter t *is* the metric depth z, which
        keeps the per-sphere hit test to one sqrt (see objective.py).
        """
        u = (torch.arange(self.width, dtype=torch.float32, device=device) - self.cx) / self.fx
        v = (torch.arange(self.height, dtype=torch.float32, device=device) - self.cy) / self.fy
        gu, gv = torch.meshgrid(u, v, indexing="xy")
        return torch.stack([gu, gv, torch.ones_like(gu)], dim=-1)

    def rays_flat(self, device: torch.device | str = "cuda") -> torch.Tensor:
        """(H*W, 3) flattened rays — the kernel-facing layout."""
        return self.rays(device).reshape(-1, 3)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def crop_camera(cam: Camera, scale: int) -> Camera:
    """A reduced-resolution camera (used by smoke tests)."""
    return Camera(
        width=cam.width // scale,
        height=cam.height // scale,
        fx=cam.fx / scale,
        fy=cam.fy / scale,
        cx=(cam.cx + 0.5) / scale - 0.5,
        cy=(cam.cy + 0.5) / scale - 0.5,
    )
