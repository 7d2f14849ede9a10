"""The card's idle share of a frame's service time, in %.

Device busy a frame is the union of the profiled frames' kernel, copy
and set records, a frame.  The service time is taken from the window's
unprofiled frames, since the profiler stretches the host: the mean of
their service intervals, from the call into the step to the pose on the
host, never the camera's wait.  The two come from different frames of
one run, and the profiler stretches each device record a little too,
so the share reads low by that stretch; it is read in the open loop
only, where the host's step and read-back leave the card idle for a
share of each frame well above it."""

import statistics

from chipbench import trace


def read(ctx):
    if ctx.segment is None or not ctx.segment.device:
        return None
    busy_ms = trace.busy_ns(ctx.segment) / 1e6 / len(ctx.segment.frames)
    service_ms = statistics.fmean(f.service_ms for f in ctx.frames)
    return 100.0 * (1.0 - busy_ms / service_ms)
