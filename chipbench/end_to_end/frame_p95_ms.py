"""The 95th percentile of the latencies of every frame of the window."""

from chipbench import stats


def read(ctx):
    return stats.percentile(stats.latencies_ms([f.due for f in ctx.frames],
                                               [f.done for f in ctx.frames]), 95)
