"""The readers of the program's own record (``chipbench/program_spans.py``
and the five metrics that read it) on a synthetic recorder and window,
on the CPU: each reads the frames that start inside the window, and
gives nothing where that count differs from the window's, where the
ring may have overwritten some of them, or where the program has no
recorder; the capture's cost leaves out an ``nvcc`` build inside it."""

import sys

import numpy as np
import pytest

import repro_torch
from chipbench import manifest
from chipbench.context import Context
from chipbench.loadgen import Frame
from repro_torch import obs

H = np.zeros(27, np.float32)
READERS = ("load_ms.cam30", "launch_ms.cam30", "graph_ms.cam30", "graph_idle_pct.cam30",
           "capture_ms.setup")
LOAD_NS, LAUNCH_NS, DEVICE_MS = 210_000, 640_000, 8.5
CAPTURE_NS, BUILD_NS = 500_000_000, 20_000_000_000


class Clock:
    def __init__(self):
        self.ns = 10**12

    def __call__(self):
        return self.ns


class Event:
    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return DEVICE_MS


def _frames(rec, clock, events, count, period_ns, service_ns, sampled):
    """``count`` frames as the program records them, one every
    ``period_ns``; a frame's replay completes before the next call (is
    sampled) where ``sampled(k)``.  Returns the client's view of them."""

    def load():
        clock.ns += LOAD_NS

    def replay():
        for e in events:
            e.done = False
        clock.ns += LAUNCH_NS

    out = []
    for k in range(count):
        clock.ns += period_ns
        start = clock.ns  # the client's stamp, a little before the program's row
        clock.ns += 1_000
        rec.frame(load, replay, events)
        for e in events:
            e.done = sampled(k)
        out.append(Frame(0, k, 0, 0, H, H, 0.0, start / 1e9, start / 1e9,
                         (start + service_ns) / 1e9, service_ns / 1e6))
    return out


def _capture(rec, clock, build_ns=0):
    with rec.span("capture"):
        with rec.span("capture.warmup"):
            if build_ns:
                with rec.span("kernels.build"):
                    clock.ns += build_ns
                rec.count("kernels.builds")
            clock.ns += 300_000_000
        clock.ns += CAPTURE_NS - 300_000_000
    rec.count("frame.captures")


def _recorder(monkeypatch, frames=128):
    clock = Clock()
    rec = obs.Recorder(frames=frames, clock=clock)
    monkeypatch.setattr(obs, "RECORDER", rec)
    return rec, clock, (Event(), Event())


@pytest.fixture
def recorded(monkeypatch):
    """A capture, 3 warm-up frames, the window's 40 frames at 30 Hz, 9.4
    ms of service each, and 5 frames after it."""
    rec, clock, events = _recorder(monkeypatch)
    _capture(rec, clock)
    _frames(rec, clock, events, 3, 1_000_000, 9_400_000, lambda k: True)
    clock.ns += 50_000_000
    window = _frames(rec, clock, events, 40, 33_333_333, 9_400_000, lambda k: True)
    clock.ns += 50_000_000
    _frames(rec, clock, events, 5, 1_000_000, 9_400_000, lambda k: True)
    return rec, clock, events, window


def _ctx(frames):
    return Context(cfg=None, frames=frames, start=min(f.due for f in frames),
                   end=max(f.done for f in frames), setup_s=7.5)


def _read(name, ctx):
    return manifest.reader("per_layer", name)(ctx)


def test_the_readers_read_the_windows_frames(recorded):
    _, _, _, window = recorded
    ctx = _ctx(window)
    assert _read("load_ms.cam30", ctx) == pytest.approx(LOAD_NS / 1e6)
    assert _read("launch_ms.edge", ctx) == pytest.approx(LAUNCH_NS / 1e6)
    assert _read("graph_ms.cam30", ctx) == pytest.approx(DEVICE_MS)
    assert _read("graph_idle_pct.edge", ctx) == pytest.approx(100 * (1 - DEVICE_MS / 9.4))
    assert _read("capture_ms.setup", ctx) == pytest.approx(CAPTURE_NS / 1e6)


def test_only_the_sampled_replays_give_the_device_time(monkeypatch):
    rec, clock, events = _recorder(monkeypatch)
    # rounds of 4 frames back to back: only a round's last replay completes
    # before the next call, and its service share is 9 ms
    window = _frames(rec, clock, events, 32, 1_000_000, 9_000_000, lambda k: k % 4 == 3)
    ctx = _ctx(window)
    assert _read("graph_ms.edge", ctx) == pytest.approx(DEVICE_MS)
    assert sum(r.device_ms is not None for r in rec.frames()) == 8
    assert _read("graph_idle_pct.edge", ctx) == pytest.approx(100 * (1 - DEVICE_MS / 9.0))


@pytest.mark.parametrize("name", READERS[:4])
def test_a_count_that_differs_from_the_window_gives_nothing(recorded, name):
    _, _, _, window = recorded
    assert _read(name, _ctx(window)) is not None
    assert _read(name, _ctx(window + window[-1:])) is None  # one frame more than recorded
    shifted = [Frame(**{**f.__dict__, "due": f.due + 100.0, "done": f.done + 100.0})
               for f in window]
    assert _read(name, _ctx(shifted)) is None  # no recorded frame in the window


@pytest.mark.parametrize("name", READERS[:4])
def test_a_window_the_ring_overwrote_gives_nothing(monkeypatch, name):
    rec, clock, events = _recorder(monkeypatch, frames=16)
    window = _frames(rec, clock, events, 24, 33_333_333, 9_400_000, lambda k: True)
    assert rec.counters()["obs.dropped"] == 8
    assert _read(name, _ctx(window[8:])) is None  # its first frame may have been lost
    clock.ns += 10**9
    after = _frames(rec, clock, events, 4, 33_333_333, 9_400_000, lambda k: True)
    assert _read(name, _ctx(after)) is not None  # the ring still holds older frames


def test_the_capture_leaves_out_an_nvcc_build(monkeypatch):
    rec, clock, events = _recorder(monkeypatch)
    _capture(rec, clock, build_ns=BUILD_NS)
    window = _frames(rec, clock, events, 4, 33_333_333, 9_400_000, lambda k: True)
    (capture,) = [s for s in rec.setup if s.name == "capture"]
    assert capture.ns == CAPTURE_NS + BUILD_NS
    assert _read("capture_ms.setup", _ctx(window)) == pytest.approx(CAPTURE_NS / 1e6)


@pytest.mark.parametrize("counter", ["frame.captures", "kernels.builds"])
def test_a_capture_the_recorder_missed_gives_nothing(recorded, counter):
    rec, _, _, window = recorded
    rec.count(counter)  # counted while no span was kept for it
    assert _read("capture_ms.setup", _ctx(window)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_recorder_gives_nothing(recorded, monkeypatch, name):
    _, _, _, window = recorded
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert _read(name, _ctx(window)) is None
