"""The port's edge runtime (``sim/runtime``), container-tax measurement
(``core/wrapper``) and example programs against the JAX reference.

``analytic_run`` and ``experiment_grid`` are deterministic and held
equal: the same plans and the same ``LoopStats`` (processed events, fps,
drop rate, mean loop time).  ``executed_run`` processes the frames that
the plan, the numpy jitter stream and the frame loop choose, so its
processed indices and ``LoopStats`` equal the reference's exactly; its
poses come from torch's random draws, so they are held to the
reference's accuracy bar (< 3 cm mean position error on a local fast
tier) and to the reference's coupling of drops to quality
(``tests/test_tracker.py``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.core import offload as joffload
from repro.core import tracker as jtracker
from repro.core import wrapper as jwrapper
from repro.sim import hardware as jhardware
from repro.sim import runtime as jruntime
from repro_torch.core import offload as toffload
from repro_torch.core import pso as tpso
from repro_torch.core import tracker as ttracker
from repro_torch.core import wrapper as twrapper
from repro_torch.core.camera import Camera as TCamera
from repro_torch.data import rgbd as trgbd
from repro_torch.examples import edge_offload_serve, quickstart
from repro_torch.sim import hardware as thardware
from repro_torch.sim import runtime as truntime

CPU = torch.device("cpu")
CAM_ARGS = dict(width=64, height=64, fx=60.0, fy=60.0, cx=31.5, cy=31.5)
STATS = ("achieved_fps", "dropped", "drop_rate", "mean_gap", "mean_loop_time", "realtime")


def _stats(stats):
    return ([dataclasses.astuple(e) for e in stats.processed],
            {a: getattr(stats, a) for a in STATS})


def _sim(res):
    """A SimResult as plain values."""
    return (_stats(res.stats), dataclasses.astuple(res.plan), res.policy.value,
            res.network, res.granularity, res.fps, res.camera_capped_fps)


def _environments(hw):
    return {"ethernet": hw.paper_environment("gigabit_ethernet"),
            "wifi": hw.paper_environment("wifi_802.11"),
            "three_tier": hw.three_tier_environment()}


@pytest.mark.parametrize("gran", ["single_step", "multi_step"])
@pytest.mark.parametrize("policy", ["local", "forced", "auto"])
@pytest.mark.parametrize("env", ["ethernet", "wifi", "three_tier"])
def test_analytic_run_matches_reference(env, policy, gran):
    for seed in (0, 3):
        want = jruntime.analytic_run(jhardware.paper_staged(), _environments(jhardware)[env],
                                     joffload.Policy(policy), gran, 150, seed)
        got = truntime.analytic_run(thardware.paper_staged(), _environments(thardware)[env],
                                    toffload.Policy(policy), gran, 150, seed)
        assert _sim(got) == _sim(want)


def test_analytic_run_rejects_unknown_granularity():
    for runtime, hw in ((jruntime, jhardware), (truntime, thardware)):
        with pytest.raises(ValueError, match="per_layer"):
            runtime.analytic_run(hw.paper_staged(), hw.paper_environment(),
                                 runtime.Policy.AUTO, "per_layer")


def test_experiment_grid_matches_reference():
    envs = ("ethernet", "wifi")
    want = jruntime.experiment_grid(
        jhardware.paper_staged(), {e: _environments(jhardware)[e] for e in envs}, num_frames=90)
    got = truntime.experiment_grid(
        thardware.paper_staged(), {e: _environments(thardware)[e] for e in envs}, num_frames=90)
    assert len(got) == 8
    assert [_sim(r) for r in got] == [_sim(r) for r in want]


# -- executed_run -------------------------------------------------------------


def _coupling_envs(offload, tracker, cfg):
    """The fast (60 fps-capable) and slow (5 fps) local tiers of the
    reference's tests/test_tracker.py coupling test."""
    comp_flops = tracker.build_staged(cfg).total_flops()
    link = offload.Link("eth", 117e6, 0.3e-3)
    return {name: offload.Environment(client=tier, server=tier, link=link, wrapped=False)
            for name, tier in (("fast", offload.Tier("fast", comp_flops * 60, 50e9)),
                               ("slow", offload.Tier("slow", comp_flops * 5, 20e9)))}


def _port_cfg():
    return ttracker.TrackerConfig(
        camera=TCamera(**CAM_ARGS), pso=tpso.PSOConfig(num_particles=32, num_generations=10),
        smoothing=0.0)


RUNS = ("fast", "slow", "wifi")


def _run(runtime, offload, tracker, hardware, cfg, frames, truth, name, **device):
    """``executed_run`` on the coupling test's local tiers, or offloaded
    over the paper's jittered Wi-Fi (Forced, Multi-Step, seed 4, the clock
    charged with the paper-scale workload), where the jitter stream
    decides which frames are processed."""
    if name == "wifi":
        return runtime.executed_run(cfg, hardware.paper_environment("wifi_802.11"),
                                    offload.Policy.FORCED, frames, truth, "multi_step", seed=4,
                                    timing_comp=hardware.paper_staged(), **device)
    env = _coupling_envs(offload, tracker, cfg)[name]
    return runtime.executed_run(cfg, env, offload.Policy.LOCAL, frames, truth, **device)


@pytest.fixture(scope="module")
def executed():
    """The port's executed runs on the CPU at the reference test's size
    (64x64, 32 particles x 10 generations, 20 frames with a burst)."""
    seq = trgbd.SequenceConfig(num_frames=20, camera=TCamera(**CAM_ARGS), fast_burst=(8, 14))
    frames, truth = trgbd.render_sequence(seq, device=CPU)
    return {name: _run(truntime, toffload, ttracker, thardware, _port_cfg(), frames, truth,
                       name, device=CPU)
            for name in RUNS}


def _reference_run(monkeypatch, name):
    """The reference's executed_run on the same plan and seed, with its
    tracker step replaced by the identity: which frames it processes
    does not depend on the poses, and this skips the JAX compile."""
    from repro.core import pso as jpso
    from repro.core.camera import Camera as JCamera

    monkeypatch.setattr(jtracker, "make_track_frame",
                        lambda cfg: (lambda key, h, depth: (h, 0.0)))
    cfg = jtracker.TrackerConfig(
        camera=JCamera(**CAM_ARGS), pso=jpso.PSOConfig(num_particles=32, num_generations=10),
        smoothing=0.0)
    frames, truth = np.zeros((20, 64, 64), np.float32), np.zeros((20, 27), np.float32)
    return _run(jruntime, joffload, jtracker, jhardware, cfg, frames, truth, name)


@pytest.mark.parametrize("name", RUNS)
def test_executed_run_processes_the_reference_frames(executed, monkeypatch, name):
    got, want = executed[name], _reference_run(monkeypatch, name)
    assert _sim(got.sim) == _sim(want.sim)
    assert len(got.sim.stats.processed) > 0
    errs = (got.mean_pos_error, got.mean_angle_error)
    assert all(math.isfinite(e) for e in errs) and got.track_lost_frames >= 0
    if name == "wifi":  # the jitter draws move the loop times
        assert got.sim.plan.legs and len(set(got.sim.stats.loop_times())) > 1


def test_executed_run_tracks_and_couples_drops_to_quality(executed):
    fast, slow = executed["fast"], executed["slow"]
    assert fast.mean_pos_error < 0.03, fast.mean_pos_error
    assert slow.sim.stats.dropped > fast.sim.stats.dropped
    assert len(fast.sim.stats.processed) > len(slow.sim.stats.processed)


def test_entry_points_do_not_fall_back_to_the_cpu():
    """Asked for the card where there is none, they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        twrapper.measure_wrapper(device="cuda")
    cfg = _port_cfg()
    env = _coupling_envs(toffload, ttracker, cfg)["fast"]
    with pytest.raises((RuntimeError, AssertionError)):
        truntime.executed_run(cfg, env, toffload.Policy.LOCAL, np.zeros((2, 64, 64), np.float32),
                              np.zeros((2, 27), np.float32))


# -- measure_wrapper ----------------------------------------------------------


@pytest.mark.parametrize("small,large,repeats", [(1024, 4 << 20, 5), (4096, 1 << 20, 3)])
def test_measure_wrapper_fit_matches_reference(monkeypatch, small, large, repeats):
    """The same staging timings give the same fit: both packages'
    ``_roundtrip_once`` replaced by one fixed schedule of timings."""

    def schedule():
        times = {small: iter(np.linspace(3e-4, 1e-4, repeats + 1)),
                 large: iter(np.linspace(9e-3, 4e-3, repeats + 1))}
        return lambda arr, *_: float(next(times[arr.nbytes]))

    monkeypatch.setattr(jwrapper, "_roundtrip_once", schedule())
    want = jwrapper.measure_wrapper(small, large, repeats)
    monkeypatch.setattr(twrapper, "_roundtrip_once", schedule())
    got = twrapper.measure_wrapper(small, large, repeats, device="cpu")
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.serialization_bandwidth == (large - small) / (4e-3 - 1e-4)


def test_measure_wrapper_on_the_cpu_is_finite_and_positive():
    model = twrapper.measure_wrapper(device="cpu")
    for value in (model.call_overhead, model.serialization_bandwidth):
        assert math.isfinite(value) and value > 0
    assert dataclasses.astuple(twrapper.paper_wrapper()) == dataclasses.astuple(
        jwrapper.paper_wrapper())


# -- the example programs -----------------------------------------------------


def test_quickstart_runs_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu", "--frames", "5", "--particles", "8",
                     "--generations", "2"])
    out = capsys.readouterr().out
    assert "tracking 5 frames (8 particles x 2 generations)" in out
    assert "mean position error" in out and "fps on this CPU" in out


def test_edge_offload_serve_runs_on_the_cpu(capsys):
    edge_offload_serve.main(["--device", "cpu", "--frames", "6", "--particles", "8",
                             "--generations", "2"])
    lines = capsys.readouterr().out.splitlines()
    names = [name for name, *_ in edge_offload_serve.deployments()]
    assert len(names) == 12
    rows = [line.split() for line in lines if line.split()[:1] and line.split()[0] in names]
    assert [r[0] for r in rows] == names
    for row in rows:
        assert all(math.isfinite(float(v)) for v in row[1:])
    # the simulated fps are the cost model's, as the reference prints them
    fps = {r[0]: float(r[1]) for r in rows}
    assert fps["local/server/native"] > 40.0 and abs(fps["local/laptop/native"] - 13.0) < 0.5
