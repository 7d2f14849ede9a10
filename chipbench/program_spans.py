"""The program's own record of the measured window (``repro_torch.obs``):
a row for each frame, with the host's input load and launch on the clock
that ``loadgen`` stamps frames with, and the frame graph's sampled device
time.

The window runs unprofiled, in every run, so what is read here is what
the benchmark's untraced runs pay for too.  A program without that recorder
gives nothing, and so does a record whose count of frames started inside
the window differs from the window's count, or whose full ring may have
overwritten some of them: the readers then report nothing rather than a
share of the frames.
"""

from __future__ import annotations

from typing import List, Optional


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.RECORDER


def window(ctx) -> Optional[List]:
    """The program's rows (``obs.Row``) of the frames that start inside
    the window, in order, or None unless there is one for each of the
    window's frames."""
    rec = recorder()
    if rec is None:
        return None
    lo, hi = ctx.start * 1e9, ctx.end * 1e9
    kept = rec.frames()
    if not kept or (rec.counters()["obs.dropped"] and kept[0].start_ns >= lo):
        return None  # the ring may have overwritten the window's first frames
    rows = [r for r in kept if lo <= r.start_ns <= hi]
    return rows if rows and len(rows) == len(ctx.frames) else None


def mean_ms(ctx, field: str) -> Optional[float]:
    """The mean of the rows' ``field`` (ns) over the window's frames, in
    ms a frame."""
    rows = window(ctx)
    if rows is None:
        return None
    return sum(getattr(r, field) for r in rows) / len(rows) / 1e6


def mean_device_ms(ctx) -> Optional[float]:
    """The mean device time of the window's sampled replays, in ms."""
    rows = window(ctx)
    if rows is None:
        return None
    sampled = [r.device_ms for r in rows if r.device_ms is not None]
    return sum(sampled) / len(sampled) if sampled else None
