"""The forward-kinematics kernel on the card (``csrc/hand_spheres.cu``
through ``repro_torch.kernels.hand_spheres``).

This file imports neither JAX nor the reference package, so the card's
machine runs it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_hand_spheres_gpu.py

Elsewhere the tests skip with that reason.  Held: the kernel against
``handmodel.pack_spheres`` run on the card, over 4,096 configurations
with angles beyond their limits and non-unit and near-zero quaternions
and at (27,), (64, 27) and (4, 64, 27): radii and padding bit for bit,
centers within 1e-6 m (the share of bit-equal elements is reported);
K1 on the kernel's spheres within 1e-5 relative of K1 on handmodel's
at frame 1's mask; one evaluation is one FK kernel record on the card
and no PyTorch kernel; a replayed frame of N generations runs FK N + 1
times, by the profiler's kernel records, while the wrapper counts only
the warm-up's and the capture's launches.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import handmodel as hm
from repro_torch.core import pso, tracker
from repro_torch.core.camera import Camera
from repro_torch.data import rgbd
from repro_torch.kernels import _build
from repro_torch.kernels import hand_spheres as hs
from repro_torch.kernels import ops
from repro_torch.kernels import pso_update as pu
from repro_torch.kernels import render_score as rs

FK = "hand_spheres_kernel"
CENTER_TOL = 1e-6  # meters
K1_RTOL = 1e-5
EVALUATIONS = 20  # profiled back to back


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    return torch.device("cuda")


def _configurations(n, device, seed):
    """n configurations in front of the camera: angles drawn from twice
    their range around it (many beyond a limit), quaternions at scales
    1e-7 to 3 and a few exactly 0."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n, hm.NUM_PARAMS), np.float32)
    h[:, :3] = rng.uniform(-0.2, 0.2, (n, 3))
    h[:, 2] += 0.55
    scale = rng.choice([1e-7, 1e-3, 0.5, 1.0, 3.0], (n, 1))
    h[:, 3:7] = rng.normal(size=(n, 4)) * scale
    h[:, 3:7] /= np.where(scale == 1.0, np.linalg.norm(h[:, 3:7], axis=-1, keepdims=True), 1.0)
    h[:8, 3:7] = 0.0
    h[:, 7:] = rng.uniform(-3.0, 3.0, (n, 20))
    return torch.from_numpy(h).to(device)


def _device_records(fn, calls=EVALUATIONS):
    """The names of the kernels ``calls`` calls of fn ran on the card, by
    the profiler's records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # built, loaded and cached before the profiler records
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


@pytest.mark.gpu
def test_kernel_matches_handmodel_on_the_card(cuda, record_property):
    many = _configurations(4096, cuda, seed=0)
    cases = {"4096": many, "(27,)": many[9], "(64, 27)": many[64:128],
             "(4, 64, 27)": many[:256].reshape(4, 64, 27)}
    equal = total = 0
    worst = 0.0
    for label, h in cases.items():
        got = hs.pack_spheres(h)
        want = hm.pack_spheres(h)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (*h.shape[:-1], hm.NUM_SPHERES, 4), label
        bits, want_bits = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(bits[..., 3], want_bits[..., 3]), f"{label}: radii"
        pad = slice(hm.NUM_SPHERES_RAW, None)
        assert torch.equal(bits[..., pad, :], want_bits[..., pad, :]), f"{label}: padding"
        assert torch.isfinite(got).all(), label
        err = float((got[..., :3] - want[..., :3]).abs().max())
        assert err <= CENTER_TOL, f"{label}: centers differ by {err:.3g} m"
        worst = max(worst, err)
        equal += int((bits == want_bits).sum())
        total += bits.numel()
    share = equal / total
    record_property("bit_equal_share", share)
    record_property("max_center_err_m", worst)
    print(f"FK kernel against handmodel.pack_spheres on the card: {share:.6f} of elements "
          f"bit-equal, centers within {worst:.3g} m")


@pytest.mark.gpu
def test_k1_scores_the_kernels_spheres_as_handmodels(cuda):
    frames, truth = rgbd.render_sequence(rgbd.SequenceConfig(num_frames=2), device=cuda)
    h_prev, depth = truth[0], frames[1]
    lo = hm.parameter_lower_bounds(h_prev, 0.10, 0.25)
    hi = hm.parameter_upper_bounds(h_prev, 0.10, 0.25)
    gen = torch.Generator(device=cuda).manual_seed(1)
    pop = lo + torch.rand((64, 27), generator=gen, device=cuda) * (hi - lo)
    pop = hm.normalize_configuration(torch.cat([h_prev[None], pop[1:]]))
    mask = (torch.abs(depth - h_prev[2]) < 0.25).reshape(-1).to(torch.float32)
    rays, d = Camera().rays_flat(cuda), depth.reshape(-1)
    got = rs.render_score_sums(hs.pack_spheres(pop), rays, d, mask)
    want = rs.render_score_sums(hm.pack_spheres(pop), rays, d, mask)
    torch.testing.assert_close(got, want, rtol=K1_RTOL, atol=0.0)


@pytest.mark.gpu
def test_one_evaluation_is_one_fk_record(cuda):
    pop = _configurations(64, cuda, seed=1)
    before = hs.launches
    names = _device_records(lambda: hs.pack_spheres(pop))
    assert hs.launches == before + 1 + EVALUATIONS
    assert len(names) == EVALUATIONS and all(FK in n for n in names), names

    # the tracker's evaluation: one FK record each, then ops.render_score's own
    frames, truth = rgbd.render_sequence(rgbd.SequenceConfig(num_frames=2), device=cuda)
    cfg = tracker.TrackerConfig()
    d_o, mask = tracker.stage_preprocess(cfg, truth[0], frames[1])
    eval_fn = tracker._make_eval_fn(cfg, d_o, mask)
    spheres, rays = hs.pack_spheres(pop), cfg.camera.rays_flat(cuda)
    scored = _device_records(lambda: ops.render_score(spheres, rays, d_o.reshape(-1),
                                                      mask.reshape(-1)))
    evaluated = _device_records(lambda: eval_fn(pop))
    assert sum(FK in n for n in evaluated) == EVALUATIONS
    assert sorted(n for n in evaluated if FK not in n) == sorted(scored)


@pytest.mark.gpu
def test_replays_run_fk_once_an_evaluation(cuda):
    cam = Camera(width=64, height=64, fx=60.0, fy=60.0, cx=31.5, cy=31.5)
    frames, truth = rgbd.render_sequence(rgbd.SequenceConfig(
        num_frames=4, camera=cam, noise_std=0.001, fast_burst=(100, 101),
        position_amplitude=0.04, curl_amplitude=0.5), device=cuda)
    cfg = tracker.TrackerConfig(camera=cam, pso=pso.PSOConfig(num_particles=16,
                                                              num_generations=30))
    step = tracker.make_track_frame(cfg, cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    hs.launches = rs.launches = pu.launches = 0
    step.capture(gen, truth[0], frames[1])
    assert (hs.launches, rs.launches, pu.launches) == (62, 62, 60)

    def replays():
        h = truth[0]
        for t in range(1, 4):
            h, _ = step(gen, h, frames[t])

    _, runs = _build.kernel_runs(replays, (FK, "render_score_kernel", "pso_update_kernel"))
    assert runs == {FK: 3 * 31, "render_score_kernel": 3 * 31, "pso_update_kernel": 3 * 30}
    assert (hs.launches, rs.launches, pu.launches) == (62, 62, 60)
