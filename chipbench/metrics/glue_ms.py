"""Device time a frame of every record that is neither K1's nor K2's
kernel: forward kinematics, the swarm's best-of updates, the spawn, the
mask, the refine and the input and output copies, in ms."""

from chipbench import trace

# The kernels that are not glue, as the profiler's records name them.
NOT_GLUE = ("render_score_kernel", "pso_update_kernel")


def read(ctx):
    if ctx.segment is None or not ctx.segment.device:
        return None
    total = sum(o.ns for o in ctx.segment.device)
    glue = total - trace.op_ns(ctx.segment, NOT_GLUE)
    return glue / 1e6 / len(ctx.segment.frames)
