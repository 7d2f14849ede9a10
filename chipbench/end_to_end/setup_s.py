"""The process's set-up before the window: imports, the kernel library's
load (its build on a checkout's first run), the clip and the draws, the
graph's capture and the warm-up."""


def read(ctx):
    return ctx.setup_s
