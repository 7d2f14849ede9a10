"""Forward kinematics of a population in one launch: the hand's 48
spheres for every configuration, the CUDA kernel and its wrapper.

Replaces no TPU kernel: the reference's forward kinematics is ``jnp``
ops in ``repro/core/handmodel.py`` (``pack_spheres``), which XLA fuses
inside its jitted frame.  The port's ``handmodel.pack_spheres`` is ~182
small PyTorch kernels a call, run eagerly or captured into the frame's
CUDA graph; ``pack_spheres`` here computes the same (..., 27) ->
(..., 48, 4) ``[cx, cy, cz, r]`` in one launch of
``csrc/hand_spheres.cu``, which says what bounds it on an H100 and how
it follows the eager ops' rounding.  Any leading batch is flattened to
M configurations.

For a CUDA tensor the wrapper launches the kernel on the current
stream and reads nothing on the host, so a CUDA graph captures it; the
hand's geometry reaches the kernel as one float32 buffer a device
(``geometry_buffer``), packed from ``handmodel._geometry`` at the first
call on that device (the tracker's eager warm-up, ahead of a capture).
For a CPU tensor it runs the plain version, ``handmodel.pack_spheres``
itself.  ``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.core import handmodel
from repro_torch.kernels import _build

# Launches of the CUDA kernel since the count was last set to 0.  A
# launch made while a CUDA graph captures counts once, here; the graph's
# replays run it without the wrapper (``core.tracker.FrameGraphs``).
launches = 0

# The kernel takes the configuration count as a 32-bit int.
MAX_CONFIGS = 2**31 - 1


def _unit(axis: torch.Tensor) -> torch.Tensor:
    """``axis / (|axis| + 1e-12)``, as ``handmodel.quat_from_axis_angle``
    normalizes its axis."""
    return axis / (torch.linalg.vector_norm(axis, dim=-1, keepdim=True) + 1e-12)


def _parts(device: torch.device) -> Dict[str, torch.Tensor]:
    """The packed buffer's parts in order: each of handmodel._Geometry's
    fields, then the unit axes as quat_from_axis_angle normalizes them
    each call."""
    g = handmodel._geometry(device)
    return {**g._asdict(), "flex_units": _unit(g.flex_axes), "z_unit": _unit(g.z_axis)}


def geometry_offsets() -> Dict[str, Tuple[int, Tuple[int, ...]]]:
    """Each packed part's (offset in floats, shape); ``"size"`` maps to
    the buffer's length and ().  ``csrc/hand_spheres.cu``'s kGeo*
    constants are the same offsets."""
    out, offset = {}, 0
    for name, t in _parts(torch.device("cpu")).items():
        out[name] = (offset, tuple(t.shape))
        offset += t.numel()
    out["size"] = (offset, ())
    return out


@functools.lru_cache(maxsize=None)
def geometry_buffer(device: torch.device) -> torch.Tensor:
    """The hand's geometry packed into one float32 tensor on ``device``,
    built once per device from ``handmodel._geometry`` by tensor ops on
    that device."""
    return torch.cat([t.reshape(-1) for t in _parts(device).values()])


def pack_spheres(h: torch.Tensor) -> torch.Tensor:
    """(..., NUM_SPHERES, 4) packed ``[cx, cy, cz, r]`` for
    configurations h (..., 27): ``handmodel.pack_spheres``, in one kernel
    launch for a CUDA tensor.  Raises ``ValueError`` on a last dimension
    other than 27, on any device."""
    if tuple(h.shape[-1:]) != (handmodel.NUM_PARAMS,):
        raise ValueError(f"h has shape {tuple(h.shape)}, expected (..., "
                         f"{handmodel.NUM_PARAMS})")
    if not h.is_cuda:
        return handmodel.pack_spheres(h)
    global launches
    device = h.device
    batch = tuple(h.shape[:-1])
    m = math.prod(batch)
    if m > MAX_CONFIGS:
        raise ValueError(f"{m} configurations: the kernel takes at most {MAX_CONFIGS}")
    out = torch.empty((*batch, handmodel.NUM_SPHERES, 4), dtype=torch.float32,
                      device=device)
    if m == 0:
        return out
    x = _build.kernel_input("h", h, device)
    geometry = geometry_buffer(device)
    with torch.cuda.device(device):
        err = _build.library().hand_spheres_launch(
            x.data_ptr(), geometry.data_ptr(), out.data_ptr(), m,
            _build.stream_handle(device))
    _build.check(err, "hand_spheres")
    launches += 1
    return out
