"""The port's CUDA kernels against their plain versions, and the wrappers'
CPU routing.

This file imports neither JAX nor the reference package, so the card's
machine, which has no JAX, runs it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py

The tests marked ``gpu`` need a CUDA card and nvcc; elsewhere they skip
with that reason.  Tolerances: K1 as ``tests/test_kernels.py`` holds the
Pallas kernel (rtol 2e-5 plus one silhouette-pixel flip, CLAMP_T / |B|,
on the normalized score); K2 at rtol = atol = 1e-6, as
``tests/test_pso_kernel.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import handmodel as hm
from repro_torch.core.camera import Camera, crop_camera
from repro_torch.core.objective import CLAMP_T, render_depth
from repro_torch.kernels import _build
from repro_torch.kernels import pso_update as pu
from repro_torch.kernels import render_score as rs

CONSTS = dict(inertia=0.7298, cognitive=1.49618, social=1.49618,
              velocity_clip=0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    return torch.device("cuda")


def _score_inputs(n, device, cam=Camera()):
    """A population of n poses near a hand, rendered rays and depth."""
    rng = np.random.default_rng(n)
    hs = np.tile(np.asarray(hm.default_pose(0.45, device="cpu")), (n, 1))
    hs[:, :3] += rng.uniform(-0.03, 0.03, (n, 3)).astype(np.float32)
    hs[:, 7:] += rng.uniform(0.0, 0.8, (n, 20)).astype(np.float32)
    hs = torch.from_numpy(hs).to(device)
    depth = render_depth(hs[0], cam).reshape(-1)
    mask = (torch.abs(depth - 0.45) < 0.25).to(torch.float32)
    return hm.pack_spheres(hs), cam.rays_flat(device), depth, mask


def _update_inputs(n, d, device, seed=0):
    rng = np.random.default_rng(seed)
    lo = -np.abs(rng.normal(size=d)) - 0.5
    hi = np.abs(rng.normal(size=d)) + 0.5
    x = lo + rng.uniform(size=(n, d)) * (hi - lo)
    v = rng.normal(size=(n, d)) * 0.5
    pb = lo + rng.uniform(size=(n, d)) * (hi - lo)
    r1, r2 = rng.uniform(size=(2, n, d))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (x, v, pb, pb[0], r1, r2, lo, hi)]


def _assert_scores_close(got, want, mask):
    denom = max(float(mask.sum()), 1.0)
    torch.testing.assert_close(got / denom, want / denom, rtol=2e-5,
                               atol=CLAMP_T / denom + 1e-6)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU each wrapper runs its plain version and counts no launch."""
    k1, k2 = rs.launches, pu.launches
    args = _score_inputs(3, "cpu", Camera(width=24, height=16, fx=20.0, fy=20.0,
                                          cx=11.5, cy=7.5))
    assert torch.equal(rs.render_score_sums(*args), rs.render_score_sums_plain(*args))
    upd = _update_inputs(5, 27, "cpu")
    for a, b in zip(pu.pso_update(*upd, **CONSTS), pu.pso_update_plain(*upd, **CONSTS)):
        assert torch.equal(a, b)
    assert (rs.launches, pu.launches) == (k1, k2)


def test_build_targets_hopper_without_fast_math():
    assert {p.name for p in _build.sources()} >= {"render_score.cu", "pso_update.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    assert "-O3" in _build.COMPILE_FLAGS
    assert not any("fast_math" in f for f in _build.ARCH_FLAGS + _build.COMPILE_FLAGS)
    assert _build.library_path() == _build.library_path()  # keyed by content
    assert _build.library_path().parent == _build.BUILD_DIR


@pytest.mark.gpu
@pytest.mark.parametrize("n,scale,p_cut", [(64, 2, 0), (13, 1, 77)])
def test_render_score_kernel_matches_plain(cuda, n, scale, p_cut):
    """64 particles on a 64x64 camera, and 13 on 128x128 with P cut to a
    ragged length (not a multiple of the kernel's pixel tile); a repeat
    is bit-identical (no float atomics); an all-zero mask scores exactly
    0.  The full-width (64, 16384) check is chip_smoke.py's."""
    spheres, rays, depth, mask = _score_inputs(n, cuda, crop_camera(Camera(), scale))
    p = rays.shape[0] - p_cut
    args = (spheres, rays[:p], depth[:p], mask[:p])
    before = rs.launches
    got = rs.render_score_sums(*args)
    again = rs.render_score_sums(*args)
    zero = rs.render_score_sums(*args[:3], torch.zeros_like(args[3]))
    assert rs.launches == before + 3
    _assert_scores_close(got, rs.render_score_sums_plain(*args), args[3])
    assert torch.equal(got, again)
    assert bool((zero == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 13])
def test_pso_update_kernel_matches_plain(cuda, n):
    args = _update_inputs(n, 27, cuda, seed=n)
    before = pu.launches
    kx, kv = pu.pso_update(*args, **CONSTS)
    assert pu.launches == before + 1
    px, pv = pu.pso_update_plain(*args, **CONSTS)
    torch.testing.assert_close(kx, px, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kv, pv, rtol=1e-6, atol=1e-6)
