"""The benchmark's arithmetic on synthetic inputs, on the CPU: latencies
and rates from host timestamps, the work counts, and the reduction of a
profiled segment to the per-layer metrics."""

import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from chipbench import manifest, stats, trace, work
from chipbench.context import Context
from chipbench.loadgen import Frame
from chipbench.reference import hand, render

ROOT = pathlib.Path(__file__).resolve().parents[1]
H = np.zeros(27, np.float32)


def _frame(client, index, due, start, done, service_ms=None):
    return Frame(client, index, 0, 0, H, H, 0.0, due, start, done,
                 (done - start) * 1e3 if service_ms is None else service_ms)


def _camera_clip(service_s, stall_at=None, stall_s=0.0, frames=600, rate=30.0):
    """A 30 Hz camera's frames through a server that takes service_s a
    frame, and stall_s more once at frame stall_at: each starts when it is
    due or when the one before is done."""
    out, free = [], 0.0
    for i in range(frames):
        due = i / rate
        start = max(due, free)
        done = start + service_s + (stall_s if i == stall_at else 0.0)
        out.append(_frame(0, i, due, start, done))
        free = done
    return out


def _ctx(frames, **kw):
    start, end = min(f.due for f in frames), max(f.done for f in frames)
    return Context(cfg=None, model=None, frames=frames, start=start, end=end, setup_s=7.5, **kw)


def _e2e(name, ctx):
    return manifest.reader("end_to_end", name)(ctx)


def test_latency_percentiles_and_a_stall_in_the_window():
    steady = _ctx(_camera_clip(0.010))
    assert _e2e("frame_p50_ms", steady) == pytest.approx(10.0)
    assert _e2e("frame_p95_ms", steady) == pytest.approx(10.0)
    # a 250 ms stall delays the frames queued behind it: the tail moves,
    # the median hardly
    stalled = _ctx(_camera_clip(0.010, stall_at=300, stall_s=0.25))
    late = [(f.done - f.due) * 1e3 for f in stalled.frames]
    assert 1 < sum(x > 11 for x in late) < 30  # the stalled frame and those queued behind it
    assert _e2e("frame_p95_ms", stalled) == pytest.approx(10.0)  # under 5% of 600 frames
    stalled = _ctx(_camera_clip(0.010, stall_at=300, stall_s=1.5))
    assert _e2e("frame_p95_ms", stalled) > 500.0
    assert _e2e("frame_p50_ms", stalled) == pytest.approx(10.0)
    assert _e2e("setup_s", stalled) == 7.5


def _rounds(service_s, clients=16, rounds=70, stall_round=None, stall_s=0.0):
    out, t = [], 0.0
    for r in range(rounds):
        done = t + service_s * clients + (stall_s if r == stall_round else 0.0)
        out += [_frame(c, r, t, t, done, (done - t) * 1e3 / clients) for c in range(clients)]
        t = done
    return out


def test_tracked_fps_counts_all_the_work_and_all_the_time():
    assert _e2e("tracked_fps", _ctx(_rounds(0.009))) == pytest.approx(1 / 0.009)
    stalled = _ctx(_rounds(0.009, stall_round=35, stall_s=1.0))
    assert _e2e("tracked_fps", stalled) == pytest.approx(70 * 16 / (70 * 16 * 0.009 + 1.0))


def test_percentile_definition():
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    with pytest.raises(ValueError):
        stats.percentile([1.0], 50)
    with pytest.raises(ValueError):
        stats.rate(10, 1.0, 1.0)


def _k1_inputs(seed=0, n=3, side=24):
    gen = torch.Generator().manual_seed(seed)
    cam = render.Camera(side, side, side * 0.86, side * 0.86, side / 2 - 0.5, side / 2 - 0.5)
    h = torch.zeros(n, 27)
    h[:, 2] = 0.5
    h[:, 3] = 1.0
    h[:, :3] += 0.01 * torch.randn((n, 3), generator=gen)
    spheres = hand.spheres(h, hand.geometry("cpu"))
    rays = cam.rays("cpu")
    depth = 0.5 + 0.3 * torch.rand(side * side, generator=gen)
    return spheres, rays, depth


def test_k1_count_is_chip_smokes_without_the_hit_term():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    spheres, rays, depth = _k1_inputs()
    mask = (torch.abs(depth - 0.5) < 0.25).float()
    (ops, _), _, kept = chip_smoke._k1_work(torch, spheres, rays, depth, mask)
    n, s = spheres.shape[:2]
    hits = chip_smoke._disc_hits(torch, spheres, rays[chip_smoke._kept(torch, depth, mask)])
    assert kept == int(work.kept_pixels(depth.reshape(24, 24), torch.tensor(0.5), 0.25))
    assert work.k1_ops(n, kept, s) == ops - 4 * hits
    assert work.frame_ops(n, 30, kept, s) == 31 * (work.k1_ops(n, kept, s) + n * 3000)


def _op(name, start, end):
    return trace.Op(name, start, end)


def _segment(frames=2):
    device = [_op("render_score_kernel", 100, 110), _op("pso_update_kernel", 110, 112),
              _op("void elementwise_kernel<add>", 105, 130),  # overlaps K1: counted once
              _op("Memcpy DtoD", 150, 160), _op("render_score_kernel", 300, 310)]
    host = [_op("aten::copy_", 120, 200), _op("cudaGraphLaunch", 145, 148),
            _op("cudaStreamSynchronize", 200, 400)]
    return trace.Segment([_frame(0, i, 0, 0, 0) for i in range(frames)], device, host, 0, 400)


def test_segment_busy_idle_and_breakdown():
    seg = _segment()
    assert trace.busy_ns(seg) == (130 - 100) + (160 - 150) + (310 - 300)
    ops = trace.device_ops(seg)
    assert ops[0] == ["void elementwise_kernel<add>", 25e-9]
    assert ops[1] == ["render_score_kernel", 20e-9]
    gaps = dict(map(tuple, trace.idle_gaps(seg)))
    # 0-100 before any op; 130-150 inside the copy; 160-300 and 310-400 in the sync
    assert gaps == {"host, between operations": 100e-9, "aten::copy_": 20e-9,
                    "cudaStreamSynchronize": 230e-9}
    assert sum(gaps.values()) == pytest.approx((400 - trace.busy_ns(seg)) / 1e9)


def _cfg():
    """hand128-64x30's frame at an 8x8 camera, and its model."""
    cell = manifest.load_cell("hand128.cam30")
    camera = {"width": 8, "height": 8, "fx": 7.0, "fy": 7.0, "cx": 3.5, "cy": 3.5}
    return cell.model.frame_config({**cell.config, "camera": camera}), cell.model


def test_per_layer_readers_on_a_synthetic_segment():
    seg = _segment()
    frames = [_frame(0, i, 0, 0, 0, service_ms=50e-6) for i in range(4)]  # 50 ns each
    peaks = {"fp32_flops_per_s": 67e12}
    cfg, model = _cfg()
    ctx = Context(cfg, model, frames, 0.0, 1.0, 1.0, kept=[750] * 4, segment=seg,
                  segment_kept=[750, 750], peaks=peaks)

    def read(name):
        return manifest.reader("per_layer", name)(ctx)

    assert read("device_idle_pct.cam30") == pytest.approx(100 * (1 - 25 / 50))
    assert read("device_idle_pct.cam30") == manifest.reader("per_layer", "device_idle_pct")(ctx)
    glue = (25 + 10) * 1e-6 / 2  # the elementwise kernel and the copy, a frame, in ms
    assert read("glue_ms.cam30") == pytest.approx(glue)
    k1 = 2 * 31 * work.k1_ops(64, 750, 48) / 67e12 / 20e-9 * 100
    assert read("k1_roofline.edge") == pytest.approx(k1)
    mfu = 4 * work.frame_ops(64, 30, 750, 48) / 67e12 / (4 * 50e-9) * 100
    assert read("frame_mfu.cam30") == pytest.approx(mfu)
    bare = Context(cfg, model, frames, 0.0, 1.0, 1.0)  # untraced: nothing to read
    for name in ("device_idle_pct", "glue_ms", "k1_roofline", "frame_mfu"):
        assert manifest.reader("per_layer", name)(bare) is None
    unknown_card = Context(cfg, model, frames, 0.0, 1.0, 1.0, kept=[1] * 4, segment=seg,
                           segment_kept=[1, 1], peaks=None)
    assert manifest.reader("per_layer", "k1_roofline")(unknown_card) is None
    assert math.isfinite(manifest.reader("per_layer", "glue_ms")(unknown_card))
