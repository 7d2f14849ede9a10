"""The port's recorder (``repro_torch.obs``) on the CPU.

A frame's row holds its load and its launch, in order, under one frame
id; the counters are exact; the ring wraps and counts what it dropped;
``enable(False)`` records nothing and reads no clock on the frame path;
a graph replay's device time is read only from events that report
complete, and a replay whose events were re-recorded before they were
read, or whose row left the ring, is not sampled; set-up spans time
themselves and are kept in order.  The frame graph's call path
(``tracker.FrameGraphs``) runs here on a stand-in graph and stand-in
events; under a CPU ``torch.profiler`` session the frame's load and
launch and the eager frame's four stage ranges appear among the host
events.  The card's side is ``tests/test_torch_obs_gpu.py``.
"""

import itertools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import pso, tracker
from repro_torch.core.camera import Camera
from repro_torch.kernels import _build

CPU = torch.device("cpu")
CAM = Camera(width=32, height=24, fx=30.0, fy=30.0, cx=15.5, cy=11.5)
N, GENS = 8, 2
STAGES = ("stage.preprocess", "stage.spawn", "stage.optimize", "stage.refine")


class TickClock:
    """A host clock that ticks 10 ns a read, and counts its reads."""

    def __init__(self):
        self.ticks, self.reads = itertools.count(1_000_000, 10), 0

    def __call__(self):
        self.reads += 1
        return next(self.ticks)


@pytest.fixture
def rec(monkeypatch):
    """A fresh process recorder on a ``TickClock``."""
    r = obs.Recorder(frames=64, clock=TickClock())
    monkeypatch.setattr(obs, "RECORDER", r)
    return r


class FakeEvent:
    """A timing event as the recorder uses it; refuses a read before it
    has completed."""

    def __init__(self):
        self.done, self.reads = True, 0

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time on an event not reported complete"
        self.reads += 1
        return 8.5


class FakeGraph:
    """A replay re-records the graph's events: they stay incomplete until
    the test lets the card finish."""

    def __init__(self, *events):
        self.events, self.replays = events, 0

    def replay(self):
        self.replays += 1
        for e in self.events:
            e.done = False


def _cfg():
    return tracker.TrackerConfig(camera=CAM, pso=pso.PSOConfig(num_particles=N,
                                                               num_generations=GENS))


def _draws(seed):
    u = torch.rand((1 + GENS, 2, N, 27), generator=torch.Generator().manual_seed(seed))
    return (u[0, 0], u[0, 1]), [(u[g, 0], u[g, 1]) for g in range(1, 1 + GENS)]


def _graph_step():
    """A ``FrameGraphs`` whose given-draws graph is a stand-in: the real
    call path (the row, the counters, the device sample) around a fake
    replay."""
    step = tracker.FrameGraphs(_cfg(), CPU)
    g = object.__new__(tracker._FrameGraph)
    g.generator = None
    g.inputs = tracker.FrameInputs(_cfg(), CPU, (CAM.height, CAM.width), _draws(0))
    g.started, g.ended = FakeEvent(), FakeEvent()
    g.graph = FakeGraph(g.started, g.ended)
    g.h_next, g.score = torch.zeros(27), torch.zeros(())
    step._graphs[True] = g
    return step, g


def _call(step, seed=1):
    return step(None, torch.zeros(27), torch.ones(CAM.height, CAM.width), _draws(seed))


def _device_ms(rec, frame):
    (row,) = [r for r in rec.frames() if r.frame == frame]
    return row.device_ms


def test_a_frames_row_holds_its_load_and_launch_in_order(rec):
    step, _ = _graph_step()
    for seed in range(3):
        _call(step, seed)
    rows = rec.frames()
    assert [r.frame for r in rows] == [1, 2, 3]
    # the clock is read at the load's start, between load and launch, and
    # after the launch: one tick each
    assert all(r.load_ns == 10 and r.launch_ns == 10 for r in rows)
    assert all(b.start_ns - a.start_ns == 30 for a, b in zip(rows, rows[1:]))


def test_counters_are_exact(rec):
    step, g = _graph_step()
    calls = 5
    for seed in range(calls):
        _call(step, seed)
    assert rec.counters() == {"frame.replays": calls, "frame.captures": 0,
                              "kernels.builds": 0, "obs.dropped": 0}
    assert g.graph.replays == calls
    with pytest.raises(ValueError):
        step(None, torch.zeros(27), torch.ones(CAM.height + 1, CAM.width), _draws(9))
    assert rec.counters()["frame.replays"] == calls  # a refused load replays nothing
    with pytest.raises(KeyError):
        rec.count("frame.replay")  # only the fixed names count


def test_the_device_time_is_read_only_from_completed_events(rec):
    step, g = _graph_step()
    _call(step, 1)
    assert _device_ms(rec, 1) is None  # frame 1's events are still running
    g.started.done = g.ended.done = True
    _call(step, 2)  # the call polls first: frame 1 is sampled
    assert _device_ms(rec, 1) == 8.5
    _call(step, 3)  # frame 2's events not complete at this call: not sampled
    g.started.done = g.ended.done = True
    assert _device_ms(rec, 2) is None and _device_ms(rec, 3) == 8.5
    assert g.started.reads == 2


def test_the_ring_wraps_and_counts_what_it_dropped(monkeypatch):
    r = obs.Recorder(frames=2)
    monkeypatch.setattr(obs, "RECORDER", r)
    step, g = _graph_step()
    for seed in range(5):
        _call(step, seed)
    assert [row.frame for row in r.frames()] == [4, 5]
    assert r.counters()["obs.dropped"] == 3
    assert [row.device_ms for row in r.frames()] == [None, None]  # 5 still running


def test_a_sample_whose_row_left_the_ring_is_not_kept(monkeypatch):
    r = obs.Recorder(frames=2)
    monkeypatch.setattr(obs, "RECORDER", r)
    step, g = _graph_step()
    _call(step, 1)
    late = FakeEvent(), FakeEvent()  # another pair of frame 1's, completing late
    late[0].done = late[1].done = False
    r._pending[id(late[1])] = (1, *late)
    g.started.done = g.ended.done = True
    _call(step, 2)  # frame 1 sampled from the graph's own events
    _call(step, 3)  # frame 2 not sampled; frame 3 takes frame 1's slot
    late[0].done = late[1].done = True
    assert [row.frame for row in r.frames()] == [2, 3]
    assert [row.device_ms for row in r.frames()] == [None, None]  # not frame 1's late sample
    assert r._pending.keys() == {id(g.ended)}


def test_enable_false_records_nothing(rec):
    step, g = _graph_step()
    rec.enable(False)
    try:
        reads = rec.clock.reads
        for seed in range(3):
            _call(step, seed)
        assert rec.clock.reads == reads  # off, a frame reads no clock
        with obs.span("capture") as s:
            pass
        assert s.ms > 0  # a set-up span still times itself, for its caller
        assert rec.frames() == [] and rec.setup == [] and rec._pending == {}
        assert set(rec.counters().values()) == {0}
    finally:
        rec.enable(True)
    assert g.graph.replays == 3
    _call(step, 4)
    assert rec.counters()["frame.replays"] == 1
    assert [r.frame for r in rec.frames()] == [1]


def test_setup_spans_time_themselves_and_are_kept_in_order(rec):
    with obs.span("capture") as outer:
        with obs.span("capture.warmup") as warm:
            with obs.span("kernels.build") as build:
                pass
    assert [s.name for s in rec.setup] == ["kernels.build", "capture.warmup", "capture"]
    assert rec.setup == [build, warm, outer]
    assert outer.ns > warm.ns > build.ns > 0
    assert outer.start_ns < warm.start_ns < build.start_ns
    assert rec.frames() == []


def test_an_nvcc_build_is_a_span_and_counted(rec, monkeypatch, tmp_path):
    target = tmp_path / "lib.so"
    monkeypatch.setattr(_build, "library_path", lambda: target)
    monkeypatch.setattr(_build, "_compile", lambda t: t.write_bytes(b""))
    assert _build.build() == target
    assert _build.build() == target  # built already: no second build
    assert rec.counters()["kernels.builds"] == 1
    assert [s.name for s in rec.setup] == ["kernels.build"]


def test_the_profiler_sees_the_spans_and_the_eager_stages(rec):
    step, _ = _graph_step()
    cfg = _cfg()
    eager = tracker.make_track_frame(cfg, CPU)
    h0, depth = torch.zeros(27), torch.ones(CAM.height, CAM.width)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(step, 1)
        eager(None, h0, depth, _draws(1))
    names = {e.name for e in prof.events()}
    assert {"frame.load", "frame.launch", *STAGES} <= names
    load = [e for e in prof.events() if e.name == "frame.load"]
    assert len(load) == 1 and any(
        e.name == "aten::copy_" and load[0].time_range.start <= e.time_range.start
        and e.time_range.end <= load[0].time_range.end for e in prof.events())
    # host-only ranges: a user annotation would cast a shadow range onto the
    # card's timeline, which the benchmark's device reductions would count
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name() in {"frame.load", "frame.launch", *STAGES}]
    assert len(ours) == 6 and not any(e.is_user_annotation() for e in ours)
    # outside a session the stages open no range: nothing to see, nothing paid
    assert obs.ranged("stage.spawn") is obs._NULL
