"""K1's share of its roofline, in %: the least time the card's fp32 rate
allows for the population evaluations' counted operations (the model's
``k1_ops``: for the one-hand model chipbench.work's count, over the kept
pixels of each profiled frame, without the hit term) divided by the
device time of the render kernel's records.  K1's bytes
bound it far less than its operations, so the operations' bound is the
roofline."""

from chipbench import trace

K1 = ("render_score_kernel",)


def read(ctx):
    if ctx.segment is None or ctx.peaks is None:
        return None
    ns = trace.op_ns(ctx.segment, K1)
    if ns == 0:
        return None
    ops = sum(ctx.model.k1_ops(ctx.cfg, kept) for kept in ctx.segment_kept)
    return 100.0 * ops / ctx.peaks["fp32_flops_per_s"] / (ns / 1e9)
