"""The arithmetic of the end-to-end metrics, on timestamps taken by the
host's clock."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (0 < q < 100) of all values, interpolated as
    ``statistics.quantiles(method="inclusive")`` does."""
    if len(values) < 2:
        raise ValueError("a percentile needs two values or more")
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def latencies_ms(due: Sequence[float], done: Sequence[float]) -> list:
    """Each frame's latency: from the time it was due at the camera to the
    time its pose was on the host, in ms."""
    return [(b - a) * 1e3 for a, b in zip(due, done)]


def rate(count: int, start: float, end: float) -> float:
    """``count`` completions over [start, end], a second."""
    if end <= start:
        raise ValueError("an empty window")
    return count / (end - start)

