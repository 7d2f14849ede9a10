"""The program's own recorder: a row of host times for each call into a
frame graph, with the graph's device time sampled from its own timing
events; the set-up's spans; four counters.  All of it is kept in memory
until a reader asks.

* Counters, exactly those of ``COUNTERS``: ``frame.replays`` (one a call
  into a frame graph; a frame's id is its count), ``frame.captures``,
  ``kernels.builds`` (``nvcc`` builds in this process) and
  ``obs.dropped`` (frames whose row the full ring overwrote).
* A frame's row, in a ring allocated up front for ``FRAMES`` frames: the
  start of its input load on ``time.perf_counter_ns()`` (the clock the
  benchmark stamps frames with), the load's and the launch's ns, and the
  graph's device ms once sampled.  While a ``torch.profiler`` session
  records, the load and the launch are also host ranges ``frame.load``
  and ``frame.launch`` (``_range``), which puts them on the device
  trace's clock.
* The device time: a frame graph records two timing events as its first
  and last nodes.  The next ``poll`` (the next frame, or a read) stores
  their elapsed time in the frame's row if both have completed; a replay
  whose events a later replay of the same graph re-recorded first is not
  sampled.  Nothing here waits for the card.
* Set-up spans (``span``): the capture and its parts, an ``nvcc`` build.
  Each times itself, so its caller can read its ``ms``, and is kept as a
  ``Span`` while the recorder is on.

The recorder is on by default.  ``enable(False)`` turns it off: a frame
then costs one flag check, and nothing is recorded, counted or sampled.
It serves one thread, as the frame path runs on one.
"""

from __future__ import annotations

import time

import torch

COUNTERS = ("frame.replays", "frame.captures", "kernels.builds", "obs.dropped")
FRAMES = 16384  # frames the ring holds: 3x the longest measured window


_profiling = torch._C._autograd._profiler_enabled  # is a profiler session recording?


def _range(name: str):
    """A host range of the profiler's.  Not ``record_function``: a user
    annotation casts a shadow of itself onto the device's timeline, which
    a reduction of the device's records would count as device time."""
    return torch._C._profiler._RecordFunctionFast(name)


def _ranged(name: str, fn) -> None:
    with _range(name):
        fn()


class Row:
    """A frame's row as a reader sees it."""

    __slots__ = ("frame", "start_ns", "load_ns", "launch_ns", "device_ms")

    def __init__(self, frame, start_ns, load_ns, launch_ns, device_ms):
        self.frame, self.start_ns, self.load_ns = frame, start_ns, load_ns
        self.launch_ns, self.device_ms = launch_ns, device_ms


class Span:
    """A set-up span (a context manager).  It times itself whether or not
    the recorder is on, and is kept if the recorder is on as it closes."""

    __slots__ = ("rec", "name", "start_ns", "end_ns", "_range")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name, self._range = rec, name, None

    def __enter__(self) -> "Span":
        if self.rec.enabled and _profiling():
            self._range = _range(self.name)
            self._range.__enter__()
        self.start_ns = self.rec.clock()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = self.rec.clock()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.rec.enabled:
            self.rec.setup.append(self)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def ms(self) -> float:
        return self.ns / 1e6


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _Null()


class Recorder:
    """Counters, the ring of frame rows, the pending device samples and
    the set-up spans.  ``clock`` is the host clock in ns (a test may hand
    in its own)."""

    def __init__(self, frames: int = FRAMES, clock=time.perf_counter_ns):
        self.enabled = True
        self.clock = clock
        self.ring = n = frames
        self._start_ns, self._load_ns, self._launch_ns = [0] * n, [0] * n, [0] * n
        self._device_ms = [None] * n  # by frame id modulo the ring
        self._pending = {}  # id(end event) -> (frame id, start event, end event)
        self.setup = []  # the set-up spans, in the order they closed
        self.counts = dict.fromkeys(COUNTERS, 0)

    def enable(self, on: bool = True) -> None:
        self.enabled = on
        if not on:  # a replay while off would leave a pending sample stale
            self._pending.clear()

    # -- recording ---------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.counts[name] += n

    def span(self, name: str) -> Span:
        return Span(self, name)

    def frame(self, load, replay, events) -> None:
        """One call into a frame graph: ``load()`` copies its inputs,
        ``replay()`` enqueues the graph, whose first and last nodes record
        ``events`` (start, end)."""
        if not self.enabled:
            load()
            replay()
            return
        self.poll()  # before the replay re-records the events
        profiling, clock = _profiling(), self.clock
        t0 = clock()
        _ranged("frame.load", load) if profiling else load()
        t1 = clock()
        _ranged("frame.launch", replay) if profiling else replay()
        t2 = clock()
        counts = self.counts
        frame = counts["frame.replays"] = counts["frame.replays"] + 1
        if frame > self.ring:
            counts["obs.dropped"] += 1
        slot = frame % self.ring
        self._start_ns[slot], self._load_ns[slot], self._launch_ns[slot] = t0, t1 - t0, t2 - t1
        self._device_ms[slot] = None
        self._pending[id(events[1])] = (frame, *events)

    def poll(self) -> None:
        """Store the device time of each pending replay whose events have
        completed; never waits."""
        if not self._pending:
            return
        for key, (frame, start, end) in list(self._pending.items()):
            if end.query() and start.query():
                del self._pending[key]
                if frame > self.counts["frame.replays"] - self.ring:  # its row is kept
                    self._device_ms[frame % self.ring] = start.elapsed_time(end)

    # -- reading -----------------------------------------------------------

    def frames(self) -> list:
        """The rows the ring holds, oldest first (pending device samples
        polled first)."""
        self.poll()
        last = self.counts["frame.replays"]
        out = []
        for frame in range(max(1, last - self.ring + 1), last + 1):
            s = frame % self.ring
            out.append(Row(frame, self._start_ns[s], self._load_ns[s], self._launch_ns[s],
                           self._device_ms[s]))
        return out

    def counters(self) -> dict:
        return dict(self.counts)


RECORDER = Recorder()


def enable(on: bool = True) -> None:
    """Turn the process's recorder on or off."""
    RECORDER.enable(on)


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def span(name: str) -> Span:
    return RECORDER.span(name)


def frame(load, replay, events) -> None:
    RECORDER.frame(load, replay, events)


def ranged(name: str):
    """A profiler range only, and only while a session records (nothing
    is kept): names eager work in a profiler trace."""
    if RECORDER.enabled and _profiling():
        return _range(name)
    return _NULL
