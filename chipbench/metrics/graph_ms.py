"""The graph's device time a frame, in ms: the mean, over the window's
sampled replays, of the time between the timing events the program's
graph records as its first and last nodes (``repro_torch.obs``).  No
profiler runs and nothing waits for the card to take it: the open loop
samples every frame, the closed loop the last frame of each round."""

from chipbench import program_spans


def read(ctx):
    return program_spans.mean_device_ms(ctx)
