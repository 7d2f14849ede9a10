"""The host's enqueue of the graph a frame, in ms: the mean of the
program's ``frame.launch`` time (``CUDAGraph.replay``) over the window's
frames, unprofiled."""

from chipbench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "launch_ns")
