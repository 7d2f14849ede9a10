"""The work of the frame, counted from its sizes and the inputs the
benchmark hands the program.  Frozen here, so that a program change that
fuses, renames or drops a kernel leaves the count of the frame's work as
it is.

Operations are fp32 operations.  One population evaluation (K1) makes 10
per (particle, kept pixel, sphere) test (the K=3 dot, the discriminant,
its sign test, the running min) and 5 per (particle, kept pixel) for the
clamped masked sum.  The 4 more of a test that hits (sqrt, subtract,
divide, t > 1e-4) are left out: which tests hit depends on the swarm,
which the program keeps on the device.  Forward kinematics is counted at
600 operations x 5 a particle, as the program's own staged description
counts it.  A frame evaluates its population 1 + G times: the spawn's,
then once a generation.
"""

from __future__ import annotations

import torch

FK_OPS_PER_PARTICLE = 600 * 5


def kept_pixels(depth: torch.Tensor, center_depth: torch.Tensor, half_width: float) -> torch.Tensor:
    """The pixels K1 scores: the box |depth - z_prev| < half_width, for
    frames (..., H, W) and their previous poses' depths (...); a count
    per frame."""
    box = torch.abs(depth - center_depth[..., None, None]) < half_width
    return box.flatten(-2).sum(-1)


def k1_ops(particles: int, kept: int, spheres: int) -> int:
    """fp32 operations of one population evaluation, without hits."""
    return 10 * particles * kept * spheres + 5 * particles * kept


def frame_ops(particles: int, generations: int, kept: int, spheres: int) -> int:
    """fp32 operations of one frame: 1 + G evaluations, each forward
    kinematics and K1."""
    return (1 + generations) * (k1_ops(particles, kept, spheres)
                                + particles * FK_OPS_PER_PARTICLE)
