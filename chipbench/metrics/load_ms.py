"""The host's input copies a frame, in ms: the mean of the program's
``frame.load`` time (h, the depth map and the draws into the graph's
static buffers) over the window's frames, unprofiled."""

from chipbench import program_spans


def read(ctx):
    return program_spans.mean_ms(ctx, "load_ns")
