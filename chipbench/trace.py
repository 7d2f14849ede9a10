"""The traced segment: a few frames under ``torch.profiler``, reduced to
the device's operations and the host's, and to what the metrics read
from them.

The segment runs after the measured window, from the same clients, with
the frames sent back to back, so the camera's wait is not in it.  The
profiler slows the host, so no host time of the segment is a metric; the
device's records are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from chipbench.loadgen import Load, Frame

SEGMENT = "chipbench.segment"
NAME_CHARS = 96  # a kernel's name is cut to this many characters in the breakdown


@dataclasses.dataclass
class Op:
    name: str
    start_ns: int
    end_ns: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass
class Segment:
    frames: List[Frame]
    device: List[Op]  # kernels, copies and sets on the card
    host: List[Op]  # the host's operations and runtime calls
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _span(event) -> Tuple[int, int]:
    """An event's [start, end) in ns on the profiler's clock."""
    if hasattr(event, "start_ns"):
        start = event.start_ns()
        return start, start + event.duration_ns()
    start = event.start_us() * 1000
    return start, start + event.duration_us() * 1000


def record(load: Load, frames: int) -> Segment:
    """About ``frames`` frames of the mix under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SEGMENT):
            done = load.run(None, frames=frames, paced=False)
    device, host, bounds = [], [], None
    for event in prof.profiler.kineto_results.events():
        name = event.name()
        start, end = _span(event)
        if name == SEGMENT:  # the host's span, and its shadow on the card's timeline
            if event.device_type() == DeviceType.CPU:
                bounds = (start, end)
        elif event.device_type() == DeviceType.CUDA:
            device.append(Op(name, start, end))
        else:
            host.append(Op(name, start, end))
    if bounds is None:
        raise RuntimeError("the profiler recorded no segment")
    return Segment(done, device, host, *bounds)


def _merged(ops: List[Op], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the ops' intervals, clipped to [lo, hi], in order."""
    spans = sorted((max(o.start_ns, lo), min(o.end_ns, hi)) for o in ops)
    merged: List[Tuple[int, int]] = []
    for s, e in spans:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def busy_ns(seg: Segment) -> int:
    """Nanoseconds of the segment in which some operation ran on the card."""
    return sum(e - s for s, e in _merged(seg.device, seg.start_ns, seg.end_ns))


def device_ops(seg: Segment, top: int = 10) -> List[list]:
    """The device operations that took the most time: [name, seconds]."""
    total: Dict[str, int] = {}
    for o in seg.device:
        name = o.name[:NAME_CHARS]
        total[name] = total.get(name, 0) + o.ns
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def idle_gaps(seg: Segment, top: int = 10) -> List[list]:
    """The card's idle time in the segment by what the host was doing: each
    gap between device operations is named by the innermost host
    operation running at its middle; [name, seconds], longest first."""
    busy = _merged(seg.device, seg.start_ns, seg.end_ns)
    edges = [seg.start_ns] + [x for span in busy for x in span] + [seg.end_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = sorted(seg.host, key=lambda o: o.start_ns)
    total: Dict[str, int] = {}
    active: List[Op] = []
    nxt = 0
    for s, e in gaps:  # in time order: sweep the host's operations once
        mid = (s + e) // 2
        while nxt < len(host) and host[nxt].start_ns <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [o for o in active if o.end_ns > mid]
        name = min(active, key=lambda o: o.ns).name if active else "host, between operations"
        total[name] = total.get(name, 0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:NAME_CHARS], ns / 1e9] for name, ns in ranked]


def op_ns(seg: Segment, patterns) -> int:
    """Device nanoseconds of the ops whose name holds one of ``patterns``."""
    return sum(o.ns for o in seg.device if any(p in o.name for p in patterns))
