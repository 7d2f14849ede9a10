"""One run of one cell: set-up, the measured window, the traced segment
(``--trace 1``), the metrics' readers and the check that decides
``correct``.  ``run.py`` is its command line; ``readings.py`` and the
tests drive it too.

The program enters only through the configuration's ``entry``: the
function that builds the frame step and its configuration's classes,
by module and name.  Everything else here is the benchmark's own; what
belongs to one tracker model (its frame's sizes, clip, mask rule,
reference and work counts) comes from the cell's ``model``
(``chipbench/models/``).
"""

from __future__ import annotations

import copy
import gc
import importlib
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from chipbench import check, loadgen, manifest, trace
from chipbench.context import Context

# Top-level modules the process may not hold once the window has closed:
# the reference package and its stack.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KEPT_BLOCK = 64  # frames a block when the kept pixels are counted


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def resolve(dotted: str):
    """``"package.module:name"`` -> that object."""
    module, name = dotted.split(":")
    return getattr(importlib.import_module(module), name)


def build_step(config: dict, device: torch.device) -> Callable:
    """The program's frame step, built from the configuration's entry."""
    entry = config["entry"]
    groups = {key: resolve(cls)(**config[key]) for key, cls in entry["groups"].items()}
    cfg = resolve(entry["config"])(**groups, **config["tracker"])
    return resolve(entry["step"])(cfg, device)


def truncated_step(config: dict, device: torch.device, generations: int) -> Callable:
    """A planted fault: the program's own step built with only the first
    ``generations`` of the configuration's PSO generations, and called
    with each frame's draws cut to them, so its search stops short."""
    cut = copy.deepcopy(config)
    cut["pso"]["num_generations"] = generations
    step = build_step(cut, device)

    def truncated(generator, h_prev, depth, draws):
        spawn, gens = draws
        return step(generator, h_prev, depth, (spawn, gens[:generations]))
    return truncated


def make_inputs(cell: manifest.Cell, frame_cfg, seed: int, device: torch.device):
    """(depth, truth, draws pool) on the device, from the seed: the clip's
    noise, then the pool, from one generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    depth, truth = cell.model.make_clip(cell.traffic, frame_cfg, gen)
    pool = torch.rand((cell.traffic["draw_pool"], *frame_cfg.draws_shape), generator=gen,
                      device=device)
    return depth, truth, pool


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules`` by
    default), compared whole."""
    held = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in held} & set(FORBIDDEN))


def kept_pixels(model, frame_cfg, frames, depth: torch.Tensor) -> List[int]:
    """The kept pixels of each frame, by the model's mask rule on its
    inputs."""
    out: List[int] = []
    for i in range(0, len(frames), KEPT_BLOCK):
        block = frames[i:i + KEPT_BLOCK]
        d = depth[torch.as_tensor([f.clip_index for f in block], device=depth.device)]
        h = torch.as_tensor(np.stack([f.h_prev for f in block]), device=depth.device)
        out += [int(k) for k in model.kept_pixels(frame_cfg, d, h)]
    return out


def power_limit() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi reads them."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"
    return done.stdout.strip() or f"not read ({done.stderr.strip()})"


def measure(cell: manifest.Cell, step: Callable, frame_cfg, seed: int,
            seconds: float, traced: bool, device: torch.device, t_start: float):
    """Set-up's end, the window and, traced, the segment.  Returns
    (context, metrics, device record, breakdown, inputs)."""
    cuda = device.type == "cuda"
    marks = [("entered", time.perf_counter())]
    depth, truth, pool = make_inputs(cell, frame_cfg, seed, device)
    if cuda:  # the clip's render passes through memory the program never holds
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    load = loadgen.Load(step, cell.traffic, depth, truth, pool)
    marks.append(("inputs", time.perf_counter()))
    load.run(None, frames=1, paced=False)  # the first frame captures the graph
    marks.append(("capture", time.perf_counter()))
    # the rest of the warm-up back to back: every path the window takes runs
    load.run(None, frames=cell.traffic["warmup_frames"] - 1, paced=False)
    load.reset()
    gc.collect()
    marks.append(("warm-up", time.perf_counter()))
    log("[setup] s from the process's start: " + ", ".join(
        f"{name} {t - t_start:.3f}" for name, t in marks))
    frames = load.run(seconds)
    start, end = loadgen.window(frames)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell.chips, "memory_peak_bytes": peak}
    segment = seg_kept = kept = None
    breakdown = None
    if traced:
        segment = trace.record(load, cell.traffic["profile_frames"])
        kept = kept_pixels(cell.model, frame_cfg, frames, depth)
        seg_kept = kept_pixels(cell.model, frame_cfg, segment.frames, depth)
        dev["busy_s"] = trace.busy_ns(segment) / 1e9
        dev["window_s"] = segment.seconds
        breakdown = {"device_ops": trace.device_ops(segment),
                     "idle_gaps": trace.idle_gaps(segment)}
    peaks = json.loads((manifest.HERE / "peaks.json").read_text()).get(dev["kind"])
    ctx = Context(frame_cfg, cell.model, frames, start, end, start - t_start, kept, segment,
                  seg_kept, peaks)
    kind, entries = ("per_layer", cell.per_layer) if traced else ("end_to_end", cell.end_to_end)
    metrics = {}
    for m in entries:
        value = manifest.reader(kind, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return ctx, metrics, dev, breakdown, (depth, truth, pool)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float,
             wrap: Optional[Callable[[Callable], Callable]] = None) -> dict:
    """One run: the program's step (through ``wrap``, if given) measured,
    then judged; returns the result line.  The reference runs after the
    program's state is freed."""
    frame_cfg = cell.model.frame_config(cell.config)
    step = build_step(cell.config, device)
    if wrap is not None:
        step = wrap(step)
    ctx, metrics, dev, breakdown, inputs = measure(cell, step, frame_cfg, seed, seconds, traced,
                                                   device, t_start)
    del step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    depth, _, pool = inputs
    frames = ctx.frames
    lat = [(f.done - f.due) * 1e3 for f in frames]
    log(f"[run] {cell.name} seed {seed}: {len(frames)} frames in {ctx.end - ctx.start:.3f} s, "
        f"set-up {ctx.setup_s:.3f} s; latency ms min {min(lat):.3f} max {max(lat):.3f}; "
        f"the step was entered at most {max(f.start - f.due for f in frames) * 1e3:.3f} ms "
        f"after a frame was due; memory peak {dev['memory_peak_bytes']} B")
    by_second: Dict[int, List[float]] = {}
    for f in frames:
        by_second.setdefault(int(f.start - ctx.start), []).append(f.service_ms)
    log("[run] mean service ms a frame, each second of the window: " + " ".join(
        f"{sum(v) / len(v):.3f}" for _, v in sorted(by_second.items())))
    slow = sorted(frames, key=lambda f: f.due - f.done)[:5]
    log("[run] slowest frames (client, frame, latency ms, late into the step ms): " + "; ".join(
        f"{f.client} {f.index} {(f.done - f.due) * 1e3:.3f} {(f.start - f.due) * 1e3:.3f}"
        for f in slow))
    if traced:
        log(f"[trace] card: {power_limit()}; kept pixels a frame {min(ctx.kept)}.."
            f"{max(ctx.kept)}, mean {sum(ctx.kept) / len(ctx.kept):.1f}; "
            f"{len(ctx.segment.frames)} profiled frames, "
            f"{len(ctx.segment.device)} device records, busy {dev['busy_s']:.6f} s of "
            f"{dev['window_s']:.6f} s")
    _, correct, compared = judge_run(cell, frame_cfg, frames, depth, pool, seed, device)
    failed = check.nonfinite_answers(frames)
    result = {"correct": correct and failed == 0, "attempted": len(frames), "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def judge_run(cell, frame_cfg, frames, depth, pool, seed, device):
    """The check on a sample of the window's frames: (values, within the
    limits, {name: {value, limit}})."""
    t = time.perf_counter()
    ref = cell.model.Reference(frame_cfg, device)
    sampled = check.sample(frames, cell.traffic["check_frames"], seed)
    values = check.numbers(sampled, depth, pool, cell.model, ref)
    ok, compared = check.judge(values, cell.limits)
    log(f"[check] {len(sampled)} sampled frames against the reference in "
        f"{time.perf_counter() - t:.3f} s: " + ", ".join(f"{k} {v!r}" for k, v in values.items()))
    return values, ok, compared
