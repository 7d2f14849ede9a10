"""Frames whose pose came back, over all clients, a second of the window:
from the first round's start to the last pose on the host."""

from chipbench import stats


def read(ctx):
    return stats.rate(len(ctx.frames), ctx.start, ctx.end)
