"""The frame step's share of the card's fp32 peak, in %: the counted
operations of every frame of the window (the model's ``frame_ops``: for
the one-hand model chipbench.work's count of its 1 + G population
evaluations and their forward kinematics, over each frame's kept pixels)
over the sum of their service times, by the host clock.
The frame's arithmetic is fp32 and has no matrix product, so the peak is
fp32 outside the tensor cores."""


def read(ctx):
    if ctx.kept is None or ctx.peaks is None:
        return None
    ops = sum(ctx.model.frame_ops(ctx.cfg, kept) for kept in ctx.kept)
    seconds = sum(f.service_ms for f in ctx.frames) / 1e3
    return 100.0 * ops / ctx.peaks["fp32_flops_per_s"] / seconds
