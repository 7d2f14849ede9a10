"""The frame graph's one-time cost, in ms of host time: the program's
``capture`` spans of the process summed (the input buffers, the eager
warm-up with the kernel library's load, the capture and the
instantiation), less any ``nvcc`` build inside them (``kernels.build``,
which only a checkout's first run makes), so every run reads the same
quantity.  Nothing where the recorder kept fewer spans than the
program counted captures (``frame.captures``) or builds
(``kernels.builds``)."""

from chipbench import program_spans


def read(ctx):
    rec = program_spans.recorder()
    if rec is None:
        return None
    counts = rec.counters()
    captures = [s for s in rec.setup if s.name == "capture"]
    builds = [s for s in rec.setup if s.name == "kernels.build"]
    if (not captures or len(captures) != counts["frame.captures"]
            or len(builds) != counts["kernels.builds"]):
        return None
    built = sum(b.ns for b in builds for c in captures
                if c.start_ns <= b.start_ns and b.end_ns <= c.end_ns)
    return (sum(c.ns for c in captures) - built) / 1e6
