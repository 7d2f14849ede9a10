"""The median latency over every frame of the window: from the time the
frame was due at the camera to the time its pose was on the host."""

import statistics

from chipbench import stats


def read(ctx):
    return statistics.median(stats.latencies_ms([f.due for f in ctx.frames],
                                                [f.done for f in ctx.frames]))
