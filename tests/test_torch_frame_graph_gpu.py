"""The frame as one CUDA graph on the card (``tracker.FrameGraphs``).

This file imports neither JAX nor the reference package, so the card's
machine runs it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_frame_graph_gpu.py

Elsewhere the tests skip with that reason.  Held at 64x64: the graph
against the eager step bit for bit over chained frames on the same draws
(and, reported as a test property, whether frames drawn from generators
seeded alike are bit-equal too); K1 and K2 run N + 1 and N times on the
card a replayed frame of N generations, by the profiler's kernel
records, while the wrappers count only the launches they make, the
warm-up's and the capture's; another generator, or a depth of another
shape, raising; the graph
``Tracker`` under 3 cm on the 12-frame clip of ``tests/test_tracker.py``.
``chip_smoke.py`` phases 5 and 6 hold the same at full width.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import pso, tracker
from repro_torch.core.camera import Camera
from repro_torch.data import rgbd
from repro_torch.kernels import _build
from repro_torch.kernels import pso_update as pu
from repro_torch.kernels import render_score as rs

CAM = Camera(width=64, height=64, fx=60.0, fy=60.0, cx=31.5, cy=31.5)
SEQ_ARGS = dict(num_frames=12, noise_std=0.001, fast_burst=(100, 101),
                position_amplitude=0.04, curl_amplitude=0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    return torch.device("cuda")


def _clip(device, frames=6):
    return rgbd.render_sequence(rgbd.SequenceConfig(camera=CAM, **{**SEQ_ARGS,
                                                                   "num_frames": frames}),
                                device=device)


def _cfg(n=16, gens=30, **kw):
    return tracker.TrackerConfig(camera=CAM, pso=pso.PSOConfig(num_particles=n,
                                                               num_generations=gens), **kw)


def _draws(device, gens, n, seed):
    """Draws of the reference's shapes as one tensor on the card:
    ((u_pos, u_vel), [(r1, r2)] a generation)."""
    u = torch.rand((1 + gens, 2, n, 27), generator=torch.Generator(device).manual_seed(seed),
                   device=device)
    return (u[0, 0], u[0, 1]), [(u[g, 0], u[g, 1]) for g in range(1, 1 + gens)]


@pytest.mark.gpu
def test_graph_equals_eager_bit_for_bit(cuda, record_property):
    frames, truth = _clip(cuda)
    cfg = _cfg()
    graph = tracker.make_track_frame(cfg, cuda)
    eager = tracker.make_track_frame(cfg, cuda, capture=False)
    assert isinstance(graph, tracker.FrameGraphs)
    h_g = h_e = truth[0]
    for t in range(1, 6):
        draws = _draws(cuda, 30, 16, seed=t)
        h_g, s_g = graph(None, h_g, frames[t], draws=draws)
        h_e, s_e = eager(None, h_e, frames[t], draws=draws)
        assert torch.equal(h_g, h_e) and torch.equal(s_g, s_e), t
    # from generators seeded alike: reported, not required
    gens = [torch.Generator(cuda).manual_seed(0) for _ in range(2)]
    h_g = h_e = truth[0]
    same = []
    for t in range(1, 6):
        h_g, s_g = graph(gens[0], h_g, frames[t])
        h_e, s_e = eager(gens[1], h_e, frames[t])
        same.append(bool(torch.equal(h_g, h_e) and torch.equal(s_g, s_e)))
    record_property("generator_frames_bit_equal", same)
    print(f"generator-drawn frames bit-equal, graph vs eager: {same}")


@pytest.mark.gpu
def test_replays_run_k1_and_k2_on_the_card(cuda):
    frames, truth = _clip(cuda)
    step = tracker.make_track_frame(_cfg(), cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    rs.launches = pu.launches = pu.launches_projected = 0
    step.capture(gen, truth[0], frames[1])
    wrapped = (62, 60, 60)  # the warm-up's launches and the capture's
    assert (rs.launches, pu.launches, pu.launches_projected) == wrapped

    def replays():
        h = truth[0]
        for t in range(1, 4):
            h, _ = step(gen, h, frames[t])

    _, runs = _build.kernel_runs(replays, ("render_score_kernel", "pso_update_kernel"))
    assert runs == {"render_score_kernel": 3 * 31, "pso_update_kernel": 3 * 30}
    assert (rs.launches, pu.launches, pu.launches_projected) == wrapped


@pytest.mark.gpu
def test_graph_refuses_another_generator_or_shape(cuda):
    frames, truth = _clip(cuda)
    step = tracker.make_track_frame(_cfg(gens=3), cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    step(gen, truth[0], frames[1])
    with pytest.raises(ValueError, match="generator"):
        step(torch.Generator(cuda).manual_seed(0), truth[0], frames[2])
    with pytest.raises(ValueError, match="depth has shape"):
        step(gen, truth[0], frames[2][:32])
    with pytest.raises(ValueError, match="captured already"):
        step.capture(gen, truth[0], frames[2])
    h, score = step(gen, truth[0], frames[2])  # the graph still runs
    assert torch.isfinite(h).all() and torch.isfinite(score)


@pytest.mark.gpu
def test_graph_tracker_tracks_the_clip(cuda):
    frames, truth = _clip(cuda, frames=12)
    t = tracker.Tracker(_cfg(32, 20, smoothing=0.0), h0=truth[0], device=cuda)
    assert isinstance(t._step, tracker.FrameGraphs)
    errs, kept = [], []
    for i in range(1, frames.shape[0]):
        h, score = t.step(frames[i])
        assert np.isfinite(score)
        kept.append((h, h.clone()))
        errs.append(float(torch.linalg.vector_norm(h[:3] - truth[i][:3])))
    assert all(torch.equal(a, b) for a, b in kept)  # no replay overwrote a kept h
    assert np.mean(errs) < 0.03, errs
