"""The recorder (``repro_torch.obs``) on the card, at the paper's frame
(128x128, 64 particles x 30 generations).

This file imports neither JAX nor the reference package, so the card's
machine runs it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_obs_gpu.py

Elsewhere the tests skip with that reason.  Held here: ``frame.replays``
counts the calls; ``FrameGraphs.capture`` returns its three costs as
its spans read them; the device time read from the graph's own timing
events lies inside the time between two events recorded on the stream
around the same replay (the card busy before the first, so the host's
enqueue falls outside), within 2% of it, and is at least 90% of the
profiler's busy time of the same frames (inputs and draws) replayed
under it; and under the profiler each frame's ``frame.launch`` range
starts before the first record of that frame's replay, on the device
trace's clock.

The event time is not held under 105% of that busy time: in the card's
slow start (PERF.md) the same graph spans 7-8% more on the card than
its kernels' busy time (9.50 against 8.79 ms), after it 4-5% less (8.37
against 8.74, the profiler lengthening each record), and the slow start
outlasted this file's 25 s of warm-up in two of six runs.  The ratio is
reported.
"""

import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import tracker
from repro_torch.data import rgbd

FRAMES = 8
WARM_S = 25.0  # back to back: a fresh process's slow start lasted 0-23 s in most probes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    return torch.device("cuda")


@pytest.fixture
def rec(monkeypatch):
    r = obs.Recorder()
    monkeypatch.setattr(obs, "RECORDER", r)
    return r


def _clip(device):
    return rgbd.render_sequence(rgbd.SequenceConfig(num_frames=FRAMES + 2), device=device)


def _draws(device, seed):
    u = torch.rand((31, 2, 64, 27), generator=torch.Generator(device).manual_seed(seed),
                   device=device)
    return (u[0, 0], u[0, 1]), [(u[g, 0], u[g, 1]) for g in range(1, 31)]


def _run(step, frames, truth, draws):
    """``FRAMES`` frames on ``draws``, each read back before the next, as
    one camera's frames are."""
    h = truth[0]
    for t in range(1, FRAMES + 1):
        h, score = step(None, h, frames[t], draws[t - 1])
        torch.cuda.current_stream(h.device).synchronize()
    return h


# Cycles the card spins before each bracketed replay (~0.5 ms at the
# H100's 1.98 GHz): longer than the host takes to enqueue the replay.
HOLD_CYCLES = 1_000_000


class Bracketed:
    """A captured graph whose every replay is bracketed by two timing
    events on the stream, outside the graph.  The card spins before the
    first event while the host enqueues the replay, so the bracket holds
    the replay's span on the card and not the host's launch (~20 us,
    which at a ~1 ms frame would be 2% of it)."""

    def __init__(self, graph):
        self.graph, self.pairs = graph, []

    def replay(self):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(HOLD_CYCLES)
        pair[0].record()
        self.graph.replay()
        pair[1].record()
        self.pairs.append(pair)


def _records(prof):
    """(host records, device records) of a session: (name, start ns, end ns,
    correlation id)."""
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id())
        (device if e.device_type() == DeviceType.CUDA else host).append(rec)
    return host, device


def _replays(prof):
    """Each ``frame.launch`` range with the device records of the graph it
    launched (those that share its ``cudaGraphLaunch``'s correlation id),
    in order."""
    host, device = _records(prof)
    launches = sorted(r for r in host if r[0] == "frame.launch")
    calls = [r for r in host if "cudaGraphLaunch" in r[0]]
    spans = {"frame.load", "frame.launch"}
    out = []
    for name, start, end, _ in launches:
        (call,) = [c for c in calls if start <= c[1] <= end]
        out.append(((start, end), sorted(d for d in device
                                         if d[3] == call[3] and d[0] not in spans)))
    return out


def _union_ns(records):
    total, reach = 0, None
    for _, s, e, _ in sorted(records, key=lambda r: r[1]):
        if reach is None or s > reach:
            total, reach = total + e - s, e
        elif e > reach:
            total, reach = total + e - reach, e
    return total


@pytest.mark.gpu
def test_replays_are_counted_and_the_capture_is_its_spans(cuda, rec):
    frames, truth = _clip(cuda)
    step = tracker.make_track_frame(tracker.TrackerConfig(), cuda)
    draws = [_draws(cuda, t) for t in range(1, FRAMES + 1)]
    cost = step.capture(None, truth[0], frames[1], draws[0])
    spans = {s.name: s for s in rec.setup}
    assert cost == {"warmup": spans["capture.warmup"].ms,
                    "capture": spans["capture.record"].ms,
                    "instantiate": spans["capture.instantiate"].ms}
    outer = spans["capture"]
    assert all(outer.start_ns <= spans[n].start_ns <= spans[n].end_ns <= outer.end_ns
               for n in ("capture.warmup", "capture.record", "capture.instantiate"))
    _run(step, frames, truth, draws)
    counts = rec.counters()
    assert counts["frame.replays"] == FRAMES and counts["frame.captures"] == 1
    assert counts["obs.dropped"] == 0
    rows = rec.frames()
    assert [r.frame for r in rows] == list(range(1, FRAMES + 1))
    assert all(r.device_ms is not None for r in rows)  # read back each frame


@pytest.mark.gpu
def test_device_time_is_the_profilers_busy_time_and_launch_precedes_it(cuda, rec,
                                                                       record_property):
    frames, truth = _clip(cuda)
    step = tracker.make_track_frame(tracker.TrackerConfig(), cuda)
    draws = [_draws(cuda, t) for t in range(1, FRAMES + 1)]
    warm_until = time.perf_counter() + WARM_S
    while time.perf_counter() < warm_until:  # the capture, then the card's slow start
        _run(step, frames, truth, draws)
    graph = step._graphs[True]
    graph.graph = bracketed = Bracketed(graph.graph)
    _run(step, frames, truth, draws)  # the frames whose device time is read
    graph.graph = bracketed.graph
    unprofiled = rec.frames()[-FRAMES:]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _run(step, frames, truth, draws)  # the same frames again, on the same draws
    profiled = rec.frames()[-FRAMES:]
    replays = _replays(prof)
    assert len(replays) == FRAMES
    device_ms = [r.device_ms for r in unprofiled]
    outer_ms = [a.elapsed_time(b) for a, b in bracketed.pairs]
    busy_ms = [_union_ns(records) / 1e6 for _, records in replays]
    stretched_ms = [r.device_ms for r in profiled]
    ratio = sum(device_ms) / sum(busy_ms)
    for name, value in (("device_ms", device_ms), ("outer_ms", outer_ms), ("busy_ms", busy_ms),
                        ("profiled_device_ms", stretched_ms), ("ratio", ratio)):
        record_property(name, value)
        print(name, value)
    assert len(outer_ms) == FRAMES
    assert all(0.98 * o <= d <= o + 1e-3 for d, o in zip(device_ms, outer_ms))
    # Under the profiler the graph's span on the card is stretched by the
    # gaps the profiler puts between its nodes, so the unprofiled replays'
    # event time is held to the profiled replays' busy time.
    assert ratio >= 0.90
    for (launch_start, _), records in replays:
        assert records and launch_start < records[0][1]
