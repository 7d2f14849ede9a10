"""The forward-kinematics kernel's wrapper on the CPU
(``repro_torch.kernels.hand_spheres``): its routing to the plain
version, its shape check, its launch count, the packed geometry the
kernel reads and the layout ``csrc/hand_spheres.cu`` reads it by.
``tests/test_torch_hand_spheres_gpu.py`` holds the kernel on the card.
"""

import math
import re

import numpy as np
import pytest
import torch

from repro_torch.core import handmodel as hm
from repro_torch.core import objective, tracker
from repro_torch.core.camera import Camera
from repro_torch.kernels import _build
from repro_torch.kernels import hand_spheres as hs
from repro_torch.kernels import ops

CPU = torch.device("cpu")
SHAPES = [(27,), (64, 27), (4, 64, 27)]


def _configurations(shape, seed=0):
    """Poses in front of the camera with angles beyond their limits and
    quaternions off the unit sphere."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(-2.5, 2.5, shape).astype(np.float32)
    h[..., :3] = rng.uniform(-0.2, 0.2, (*shape[:-1], 3))
    h[..., 2] += 0.55
    h[..., 3:7] = rng.normal(size=(*shape[:-1], 4)) * rng.choice([1e-7, 1.0, 3.0],
                                                                 (*shape[:-1], 1))
    return torch.from_numpy(h)


@pytest.mark.parametrize("shape", SHAPES)
def test_cpu_tensors_take_handmodel_pack_spheres(shape):
    h = _configurations(shape)
    got = hs.pack_spheres(h)
    want = hm.pack_spheres(h)
    assert got.shape == (*shape[:-1], hm.NUM_SPHERES, 4)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("shape", [(26,), (64, 28), (4, 64, 0), ()])
def test_a_last_dimension_other_than_27_raises(device, shape):
    with pytest.raises(ValueError, match="expected"):
        hs.pack_spheres(torch.zeros(shape, device=device))


def test_cpu_tensors_count_no_launch():
    before = hs.launches
    for shape in SHAPES:
        hs.pack_spheres(_configurations(shape))
    assert hs.launches == before


def test_geometry_buffer_unpacks_to_the_geometry():
    g = hm._geometry(CPU)
    buf = hs.geometry_buffer(CPU)
    offsets = hs.geometry_offsets()
    assert buf.dtype == torch.float32 and buf.shape == (offsets["size"][0],)
    assert list(offsets)[:len(g._fields)] == list(g._fields)
    for name, want in g._asdict().items():
        start, shape = offsets[name]
        got = buf[start:start + math.prod(shape)].view(shape)
        assert torch.equal(got, want), name
    # the unit axes are the axis quat_from_axis_angle rotates about:
    # at angle pi, sin(pi / 2) rounds to 1, so its vector part is that axis
    for name, axis in (("flex_units", g.flex_axes), ("z_unit", g.z_axis)):
        start, shape = offsets[name]
        got = buf[start:start + math.prod(shape)].view(shape)
        q = hm.quat_from_axis_angle(axis, torch.full(axis.shape[:-1], math.pi))
        assert torch.equal(got, q[..., 1:]), name
    assert hs.geometry_buffer(CPU) is buf  # built once per device


def _cu_offsets():
    src = (_build.CSRC_DIR / "hand_spheres.cu").read_text()
    found = re.findall(r"constexpr int kGeo(\w+) = (\d+);", src)
    return {re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower(): int(v) for name, v in found}


def test_kernel_reads_the_buffer_by_its_layout():
    """The kGeo* offsets of csrc/hand_spheres.cu are the wrapper's, for
    every part the kernel reads (the raw axes only in their unit form)."""
    want = {name: offset for name, (offset, _shape) in hs.geometry_offsets().items()
            if name not in ("flex_axes", "z_axis", "size")}
    assert _cu_offsets() == want
    assert hs.geometry_offsets()["size"] == (231, ())


def test_build_picks_up_the_kernel():
    assert _build.CSRC_DIR / "hand_spheres.cu" in _build.sources()
    assert _build._SIGNATURES["hand_spheres_launch"] == [_build._P] * 3 + [_build._I,
                                                                            _build._P]


def test_tracker_evaluation_goes_through_the_wrapper(monkeypatch):
    """The tracker's kernel route takes its spheres from
    ``hand_spheres.pack_spheres`` (on the CPU, handmodel's own)."""
    cam = Camera(width=24, height=16, fx=20.0, fy=20.0, cx=11.5, cy=7.5)
    cfg = tracker.TrackerConfig(camera=cam, use_kernel=True)
    h0 = hm.default_pose(0.45, device=CPU)
    depth = objective.render_depth(h0, cam)
    d_o, mask = tracker.stage_preprocess(cfg, h0, depth)
    calls = []
    plain = hs.pack_spheres
    monkeypatch.setattr(hs, "pack_spheres", lambda h: calls.append(h.shape) or plain(h))
    pop = _configurations((8, 27), seed=3)
    got = tracker._make_eval_fn(cfg, d_o, mask)(pop)
    assert calls == [(8, 27)]
    want = ops.render_score(hm.pack_spheres(pop), cam.rays_flat(CPU), d_o.reshape(-1),
                            mask.reshape(-1))
    assert torch.equal(got, want)
