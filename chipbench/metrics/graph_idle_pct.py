"""The card's idle share of a frame's service time, in %, from one set of
frames: 100 x (1 - the mean device time of the window's sampled graph
replays / the mean service time of the window's frames).  Both come from
the unprofiled window, so neither is stretched by the profiler.  What
is not the graph's device time counts as idle: the host's step before
the graph starts, the input copies and output clones on the card, and
the read-back."""

import statistics

from chipbench import program_spans


def read(ctx):
    device_ms = program_spans.mean_device_ms(ctx)
    if device_ms is None:
        return None
    return 100.0 * (1.0 - device_ms / statistics.fmean(f.service_ms for f in ctx.frames))
