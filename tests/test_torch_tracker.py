"""The port's tracker, data and clock against the JAX reference, and the
port's independence from it.

Tolerances: rendered frames at 1e-5 absolute (same float32 expressions)
on all pixels but grazing ones (see ``_assert_depth_close``); the tracker
to the reference's own accuracy bar (< 3 cm mean position error,
``tests/test_tracker.py``), since its random draws are torch's.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import stages as jstages
from repro.core import tracker as jtracker
from repro.core import pso as jpso
from repro.core.camera import Camera as JCamera
from repro.data import rgbd as jrgbd
from repro.sim import clock as jclock
from repro_torch.core import pso as tpso
from repro_torch.core import stages as tstages
from repro_torch.core import tracker as ttracker
from repro_torch.core.camera import Camera as TCamera
from repro_torch.data import rgbd as trgbd
from repro_torch.sim import clock as tclock

CPU = torch.device("cpu")
CAM_ARGS = dict(width=64, height=64, fx=60.0, fy=60.0, cx=31.5, cy=31.5)
SEQ_ARGS = dict(num_frames=12, noise_std=0.001, fast_burst=(100, 101),
                position_amplitude=0.04, curl_amplitude=0.5)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def short_sequence():
    """The 12-frame 64x64 clip of tests/test_tracker.py, rendered by the port."""
    cfg = trgbd.SequenceConfig(camera=TCamera(**CAM_ARGS), **SEQ_ARGS)
    return trgbd.render_sequence(cfg, device=CPU)


def _assert_depth_close(port, ref):
    """1e-5 on every pixel but grazing ones.  Where a ray barely touches
    a sphere, t moves by ulp(disc) / (2 sqrt(disc)), so one rounding in
    the dot product (XLA's dot there, products and sums here) moves the
    depth by up to ~1e-4 m: at most 0.1% of pixels may differ by more
    than 1e-5, and none by more than 2e-4."""
    diff = np.abs(np.asarray(port) - np.asarray(ref))
    assert diff.max() <= 2e-4, diff.max()
    assert (diff > 1e-5).mean() <= 1e-3, (diff > 1e-5).sum()


def _cfg(n, g, **kw):
    return ttracker.TrackerConfig(
        camera=TCamera(**CAM_ARGS),
        pso=tpso.PSOConfig(num_particles=n, num_generations=g), **kw)


def test_tracks_synthetic_sequence(short_sequence):
    frames, truth = short_sequence
    t = ttracker.Tracker(_cfg(32, 20, smoothing=0.0, use_kernel=True),
                         h0=truth[0], device=CPU)
    errs = []
    for i in range(1, frames.shape[0]):
        h, score = t.step(frames[i])
        assert np.isfinite(score)
        errs.append(float(torch.linalg.vector_norm(h[:3] - truth[i][:3])))
    assert np.mean(errs) < 0.03, errs  # < 3 cm mean position error


@pytest.mark.parametrize("use_kernel", [False, True])
def test_stage_composition_matches_fused(short_sequence, use_kernel):
    """The 4 stages run separately == the fused track_frame, given the
    same generator state (Single-Step and Multi-Step are one math)."""
    frames, truth = short_sequence
    cfg = _cfg(16, 5, use_kernel=use_kernel)
    h_prev, depth = truth[0], frames[1]
    fused = ttracker.make_track_frame(cfg, device=CPU)
    h_fused, score_fused = fused(torch.Generator().manual_seed(0), h_prev, depth)

    gen = torch.Generator().manual_seed(0)
    d_o, mask = ttracker.stage_preprocess(cfg, h_prev, depth)
    eval_fn = ttracker._make_eval_fn(cfg, d_o, mask)
    state, lo, hi = ttracker.stage_spawn(cfg, gen, h_prev, eval_fn)
    state = ttracker.stage_optimize(cfg, state, lo, hi, eval_fn, gen)
    h_multi, score_multi = ttracker.stage_refine(cfg, state, h_prev)
    np.testing.assert_allclose(h_fused.numpy(), h_multi.numpy(), atol=1e-5)
    assert float(score_fused) == pytest.approx(float(score_multi), abs=1e-6)
    assert h_fused.shape == (27,) and np.isfinite(float(score_fused))


def test_build_staged_matches_reference():
    for cam_args, n, g in ((CAM_ARGS, 48, 20), ({}, 64, 30)):
        t_cfg = ttracker.TrackerConfig(
            camera=TCamera(**cam_args), pso=tpso.PSOConfig(num_particles=n, num_generations=g))
        j_cfg = jtracker.TrackerConfig(
            camera=JCamera(**cam_args), pso=jpso.PSOConfig(num_particles=n, num_generations=g))
        assert (ttracker._eval_flops_per_generation(t_cfg)
                == jtracker._eval_flops_per_generation(j_cfg))
        for frame_nbytes in (None, 921_600):
            port = ttracker.build_staged(t_cfg, frame_nbytes)
            ref = jtracker.build_staged(j_cfg, frame_nbytes)
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert port.total_flops() == ref.total_flops()
            assert dataclasses.asdict(port.fused()) == dataclasses.asdict(ref.fused())


def test_pytree_nbytes_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [np.zeros(5, np.int64), (np.ones(2, np.float16), 3.0)], "c": None}
    assert tstages.pytree_nbytes(tree) == jstages.pytree_nbytes(tree)
    as_tensors = {"a": torch.from_numpy(tree["a"]),
                  "b": [torch.zeros(5, dtype=torch.int64),
                        (torch.ones(2, dtype=torch.float16), 3.0)], "c": None}
    assert tstages.pytree_nbytes(as_tensors) == jstages.pytree_nbytes(tree)


def test_truth_trajectory_is_bit_identical():
    for kw in ({}, SEQ_ARGS, {"num_frames": 60, "fast_burst": (10, 30)}):
        port = trgbd.truth_trajectory(trgbd.SequenceConfig(**kw))
        ref = jrgbd.truth_trajectory(jrgbd.SequenceConfig(**kw))
        assert port.dtype == np.float32
        np.testing.assert_array_equal(port, np.asarray(ref))


def test_render_sequence_matches_reference(short_sequence):
    frames, truth = short_sequence
    ref_frames, ref_truth = jrgbd.render_sequence(
        jrgbd.SequenceConfig(camera=JCamera(**CAM_ARGS), **SEQ_ARGS))
    assert frames.shape == (12, 64, 64) and frames.dtype == torch.float32
    np.testing.assert_array_equal(truth.numpy(), np.asarray(ref_truth))
    _assert_depth_close(frames.numpy(), ref_frames)


def test_frame_loop_matches_reference():
    times = [0.020, 0.051, 0.013, 0.150, 0.034, 0.033, 0.090]

    def loop_time(i, gap):
        return times[i % len(times)] * (1.0 + 0.1 * (gap - 1))

    for fps in (30.0, 60.0):
        port = tclock.FrameLoop(fps).run(loop_time, 40)
        ref = jclock.FrameLoop(fps).run(loop_time, 40)
        assert ([dataclasses.astuple(e) for e in port.processed]
                == [dataclasses.astuple(e) for e in ref.processed])
        for attr in ("achieved_fps", "dropped", "drop_rate", "mean_gap",
                     "mean_loop_time", "realtime"):
            assert getattr(port, attr) == getattr(ref, attr), attr


def test_port_is_standalone():
    """No file of the port, and not chip_smoke.py, imports JAX or the
    reference package — directly (source scan) or transitively (a fresh
    interpreter importing every port module loads neither)."""
    forbidden = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|,|$)", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        match = forbidden.search(path.read_text())
        assert match is None, f"{path.relative_to(REPO)}: {match.group(0)!r}"
    modules = [".".join(p.relative_to(REPO / "src").with_suffix("").parts)
               for p in files[:-1] if p.name != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
