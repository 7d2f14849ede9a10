#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the hand tracker on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from src/repro_torch/csrc with nvcc (sm_90a)
     and print ptxas' registers and spills;
  3. K1 (render_score) against its plain version on the card: full width,
     a ragged shape, an all-zero mask (exactly 0) and a repeat
     (bit-identical);
  4. K2 (pso_update) against its plain version at (64, 27) and (13, 27),
     and the main path's evaluation on the card (forward kinematics + K1)
     against the plain objective on the CPU for the same particles;
  5. the main path: render a 30-frame 128x128 sequence and track it with
     ``Tracker`` at 64 particles x 30 generations from the true first
     pose; mean position error < 3 cm; K1 launched 31 times and K2 30
     times per frame; per-frame time by CUDA events and its replay
     through the 30 Hz ``FrameLoop``;
  6. two frames under torch.profiler: device busy/idle share and kernel
     time per frame;
  7. each kernel timed by CUDA events at the main path's shapes, beside
     its plain version and its bound on the card;
  8. one {"kernels": [...]} line, then the {"ok": ...} line last.

Needs one CUDA card and nvcc; there is no CPU fallback.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
PACKAGE = ROOT / "src" / "repro_torch"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# fp32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FRAMES = 30  # rendered; the first is the known start pose, 29 are tracked
K1_TOL_RTOL = 2e-5  # plus one silhouette flip: CLAMP_T / |B| + 1e-6
K2_TOL = 1e-6


def configs():
    """The sequence and the tracker the main path runs: the repo's
    defaults, Camera() 128x128 and PSOConfig() 64 x 30."""
    from repro_torch.core import tracker
    from repro_torch.data import rgbd

    return rgbd.SequenceConfig(num_frames=FRAMES), tracker.TrackerConfig()


def log(msg: str = "") -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"CUDA {torch.version.cuda}  device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")


def phase_build(_build):
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.find_nvcc()})")
    for line in _build.build_log_path().read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("[build] " + line.strip())


def _particles(torch, hm, h_prev, n, device, seed):
    """n particles spawned around h_prev as the tracker spawns them."""
    lo = hm.parameter_lower_bounds(h_prev, 0.10, 0.25)
    hi = hm.parameter_upper_bounds(h_prev, 0.10, 0.25)
    gen = torch.Generator(device=device).manual_seed(seed)
    hs = lo + torch.rand((n, 27), generator=gen, device=device) * (hi - lo)
    return hm.normalize_configuration(torch.cat([h_prev[None], hs[1:]]))


def _population(torch, hm, cam, truth, frames, n, device, seed):
    """The main path's evaluation inputs: n particles spawned around the
    true pose of frame 0, scored against frame 1."""
    h_prev, depth = truth[0], frames[1]
    hs = _particles(torch, hm, h_prev, n, device, seed)
    mask = (torch.abs(depth - h_prev[2]) < 0.25).reshape(-1).to(torch.float32)
    return hm.pack_spheres(hs), cam.rays_flat(device), depth.reshape(-1), mask


def _normalized_err(torch, got, want, mask):
    denom = max(float(mask.sum()), 1.0)
    err = (got / denom - want / denom).abs()
    tol = K1_TOL_RTOL * (want / denom).abs() + 0.30 / denom + 1e-6
    return float(err.max()), bool((err <= tol).all())


def phase_k1(torch, rs, inputs):
    spheres, rays, depth, mask = inputs
    got = rs.render_score_sums(spheres, rays, depth, mask)
    again = rs.render_score_sums(spheres, rays, depth, mask)
    want = rs.render_score_sums_plain(spheres, rays, depth, mask)
    torch.cuda.synchronize()
    err, ok = _normalized_err(torch, got, want, mask)
    check(ok, f"K1 full width disagrees with its plain version: max|err| {err:.3g}")
    check(torch.equal(got, again), "K1 repeat is not bit-identical")
    log(f"[K1] full width N={spheres.shape[0]} S={spheres.shape[1]} P={rays.shape[0]}: "
        f"max|err| of E_D {err:.3g} (tol rtol {K1_TOL_RTOL} + CLAMP_T/|B| + 1e-6), "
        f"repeat bit-identical")

    p = rays.shape[0] - 77  # not a multiple of the 1024-pixel tile
    args = (spheres[:13], rays[:p], depth[:p], mask[:p])
    r_err, r_ok = _normalized_err(torch, rs.render_score_sums(*args),
                                  rs.render_score_sums_plain(*args), args[3])
    check(r_ok, f"K1 ragged shape disagrees: max|err| {r_err:.3g}")
    log(f"[K1] ragged N=13 P={p}: max|err| {r_err:.3g}")

    zero = rs.render_score_sums(spheres, rays, depth, torch.zeros_like(mask))
    check(bool((zero == 0).all()), "K1 with an all-zero mask is not exactly 0")
    log("[K1] all-zero mask: exactly 0")
    return err


def phase_k2(torch, pu, device):
    consts = dict(inertia=0.7298, cognitive=1.49618, social=1.49618, velocity_clip=0.5)
    full_width_err = None
    for n in (64, 13):
        gen = torch.Generator(device=device).manual_seed(n)
        u = lambda *shape: torch.rand(shape, generator=gen, device=device)
        lo, hi = -0.5 - u(27), 0.5 + u(27)
        x, pb = lo + u(n, 27) * (hi - lo), lo + u(n, 27) * (hi - lo)
        args = (x, (u(n, 27) - 0.5) * 2.0, pb, pb[0], u(n, 27), u(n, 27), lo, hi)
        kx, kv = pu.pso_update(*args, **consts)
        px, pv = pu.pso_update_plain(*args, **consts)
        torch.cuda.synchronize()
        for got, want in ((kx, px), (kv, pv)):
            check(bool(torch.allclose(got, want, rtol=K2_TOL, atol=K2_TOL)),
                  f"K2 at ({n}, 27) disagrees with its plain version")
        err = max(float((kx - px).abs().max()), float((kv - pv).abs().max()))
        full_width_err = err if full_width_err is None else full_width_err
        log(f"[K2] ({n}, 27): max|err| {err:.3g} (tol rtol = atol = {K2_TOL})")
    return full_width_err


def phase_eval_agrees(tracker_mod, hs, frames, truth):
    """The main path's population evaluation on the card (forward
    kinematics + K1 through ops.render_score) against the plain
    objective on the CPU, for the same particles hs."""
    import dataclasses

    cfg = configs()[1]
    cpu_cfg = dataclasses.replace(cfg, use_kernel=False)
    d_o, mask = tracker_mod.stage_preprocess(cfg, truth[0], frames[1])
    on_card = tracker_mod._make_eval_fn(cfg, d_o, mask)(hs).cpu()
    on_cpu = tracker_mod._make_eval_fn(cpu_cfg, d_o.cpu(), mask.cpu())(hs.cpu())
    denom = max(float(mask.sum()), 1.0)
    err = float((on_card - on_cpu).abs().max())
    ok = bool(((on_card - on_cpu).abs() <= K1_TOL_RTOL * on_cpu.abs() + 0.30 / denom + 1e-6).all())
    check(ok and on_card.shape == hs.shape[:1],
          f"evaluation on the card disagrees with the CPU: {err:.3g}")
    log(f"[eval] {hs.shape[0]} particles, card (FK + K1) vs CPU plain objective: "
        f"max|err| {err:.3g}")


def phase_main_path(torch, tracker_mod, rs, pu, frames, truth, device):
    cfg = configs()[1]
    log(f"[main] Tracker: camera {cfg.camera.width}x{cfg.camera.height}, "
        f"{cfg.pso.num_particles} particles x {cfg.pso.num_generations} generations, "
        f"{frames.shape[0] - 1} tracked frames")
    warm = tracker_mod.Tracker(cfg, h0=truth[0], seed=1, device=device)
    warm.step(frames[1])  # first-use set-up (allocator, constants) outside the counts
    tracker = tracker_mod.Tracker(cfg, h0=truth[0], seed=0, device=device)
    torch.cuda.synchronize()

    rs.launches = 0
    pu.launches = 0
    frame_ms, errs = [], []
    for i in range(1, frames.shape[0]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        h, score = tracker.step(frames[i])
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
        check(bool(torch.isfinite(h).all()) and score == score, f"frame {i}: non-finite output")
        errs.append(float(torch.linalg.vector_norm(h[:3] - truth[i][:3])))
    k1, k2 = rs.launches, pu.launches

    tracked = len(frame_ms)
    per_frame = 1 + cfg.pso.num_generations
    mean_err = statistics.fmean(errs)
    log(f"[main] mean position error {mean_err * 100:.3f} cm (max {max(errs) * 100:.3f} cm)")
    check(mean_err < 0.03, f"mean position error {mean_err:.4f} m >= 3 cm")
    log(f"[main] launches: K1 {k1} (expected {tracked * per_frame}), "
        f"K2 {k2} (expected {tracked * cfg.pso.num_generations})")
    check(k1 == tracked * per_frame, "K1 launch count off the main path")
    check(k2 == tracked * cfg.pso.num_generations, "K2 launch count off the main path")
    log(f"[main] frame time by CUDA events: mean {statistics.fmean(frame_ms):.3f} ms, "
        f"median {statistics.median(frame_ms):.3f} ms, min {min(frame_ms):.3f} ms, "
        f"max {max(frame_ms):.3f} ms")

    from repro_torch.sim import clock
    stats = clock.FrameLoop(clock.CAMERA_FPS).run(
        lambda idx, gap: frame_ms[idx % tracked] / 1e3, tracked)
    log(f"[main] FrameLoop at {clock.CAMERA_FPS:.0f} Hz over {tracked} camera frames: "
        f"achieved {stats.achieved_fps:.3f} fps, drop rate {stats.drop_rate:.3f}, "
        f"mean gap {stats.mean_gap:.2f}")
    return {"k1": k1, "k2": k2}


def phase_profile(torch, tracker_mod, frames, truth, device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tracker = tracker_mod.Tracker(configs()[1], h0=truth[0], seed=2, device=device)
    tracker.step(frames[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in (2, 3):
            tracker.step(frames[i])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        log("[profile] the profiler recorded no device activity: busy share not measured")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by = {"K1": 0.0, "K2": 0.0, "other": 0.0}
    count = {"K1": 0, "K2": 0}
    for e in events:
        dur = e.time_range.end - e.time_range.start
        key = ("K1" if "render_score_" in e.name else
               "K2" if "pso_update_kernel" in e.name else "other")
        by[key] += dur
        if key in count and ("partial" in e.name or key == "K2"):
            count[key] += 1
    out = {
        "frame_ms": wall_us / 2 / 1e3,
        "busy_ms": busy / 2 / 1e3,
        "idle_share": 1.0 - busy / wall_us,
        "activities_per_frame": len(events) / 2,
        "k1_ms": by["K1"] / 2 / 1e3,
        "k2_ms": by["K2"] / 2 / 1e3,
        "other_ms": by["other"] / 2 / 1e3,
        "k1_device_ms_per_launch": by["K1"] / max(count["K1"], 1) / 1e3,
        "k2_device_ms_per_launch": by["K2"] / max(count["K2"], 1) / 1e3,
    }
    log(f"[profile] per frame: wall {out['frame_ms']:.3f} ms, device busy "
        f"{out['busy_ms']:.3f} ms (idle {out['idle_share'] * 100:.1f}%), "
        f"{out['activities_per_frame']:.0f} device activities; K1 {out['k1_ms']:.3f} ms, "
        f"K2 {out['k2_ms']:.3f} ms, other kernels/copies {out['other_ms']:.3f} ms")
    log(f"[profile] device time per launch: K1 {out['k1_device_ms_per_launch'] * 1e3:.2f} us "
        f"(both of its kernels), K2 {out['k2_device_ms_per_launch'] * 1e3:.2f} us")
    return out


def _time_ms(torch, fn, reps, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _disc_hits(torch, spheres, rays):
    """How many (particle, pixel, sphere) tests have disc >= 0: the work
    K1's hit branch does on these inputs."""
    d2 = (rays * rays).sum(-1)[:, None]
    hits = 0
    for chunk in spheres.split(8):
        c = chunk[:, None, :, :3]
        dc = (rays[:, 0, None] * c[..., 0] + rays[:, 1, None] * c[..., 1]
              + rays[:, 2, None] * c[..., 2])
        c2r2 = (c * c).sum(-1) - chunk[:, None, :, 3] ** 2
        hits += int(((dc * dc - d2 * c2r2) >= 0).sum())
    return hits


def phase_timing(torch, rs, pu, inputs, device, k1_err, k2_err, launches, prof):
    spheres, rays, depth, mask = inputs
    n, s = spheres.shape[:2]
    p = rays.shape[0]
    k1_ms = _time_ms(torch, lambda: rs.render_score_sums(spheres, rays, depth, mask), 200)
    k1_plain = _time_ms(torch, lambda: rs.render_score_sums_plain(spheres, rays, depth, mask), 20)
    hits = _disc_hits(torch, spheres, rays)
    # fp32 operations: 10 per (particle, pixel, sphere) test (the K=3 dot,
    # the discriminant, its sign test, the running min), 4 more per test
    # with disc >= 0 (sqrt, subtract, divide, t > 1e-4), 5 per (particle,
    # pixel) for the clamped masked sum.
    k1_ops = 10 * n * p * s + 4 * hits + 5 * n * p
    k1_bytes = 4 * (n * s * 4 + p * 3 + p + p + n)
    k1_bound = 1e3 * max(k1_ops / PEAK_FP32_FLOPS, k1_bytes / PEAK_BYTES_PER_S)
    log(f"[time] K1 at N={n} S={s} P={p}: kernel {k1_ms * 1e3:.2f} us, plain "
        f"{k1_plain * 1e3:.2f} us, bound {k1_bound * 1e3:.2f} us "
        f"({k1_ops:.4g} fp32 ops of which {hits} hit tests / 67 TFLOP/s; "
        f"{k1_bytes} B / 3.35 TB/s); no single PyTorch call computes it")

    consts = dict(inertia=0.7298, cognitive=1.49618, social=1.49618, velocity_clip=0.5)
    gen = torch.Generator(device=device).manual_seed(3)
    d = 27
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)
    lo, hi = -0.5 - u(d), 0.5 + u(d)
    args = (lo + u(64, d) * (hi - lo), u(64, d) - 0.5, lo + u(64, d) * (hi - lo),
            lo + u(d) * (hi - lo), u(64, d), u(64, d), lo, hi)
    k2_ms = _time_ms(torch, lambda: pu.pso_update(*args, **consts), 500)
    k2_plain = _time_ms(torch, lambda: pu.pso_update_plain(*args, **consts), 200)
    # 17 fp32 ops per element; bytes: five (N, D) planes read, three (D,)
    # rows read, two (N, D) planes written.
    k2_ops = 17 * 64 * d
    k2_bytes = 4 * (7 * 64 * d + 3 * d)
    k2_bound = 1e3 * max(k2_ops / PEAK_FP32_FLOPS, k2_bytes / PEAK_BYTES_PER_S)
    log(f"[time] K2 at (64, {d}): kernel {k2_ms * 1e3:.2f} us, plain {k2_plain * 1e3:.2f} us, "
        f"bound {k2_bound * 1e3:.4f} us ({k2_bytes} B / 3.35 TB/s; {k2_ops} fp32 ops); "
        f"no single PyTorch call computes it")
    return [
        {"name": "render_score_sums", "route": "cuda",
         "source": "src/repro_torch/csrc/render_score.cu",
         "replaces": "src/repro/kernels/render_score.py:138",
         "launches": launches["k1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by":
         "operations" if k1_ops / PEAK_FP32_FLOPS >= k1_bytes / PEAK_BYTES_PER_S else "bytes",
         "library_ms": None,
         "device_ms": prof["k1_device_ms_per_launch"] if prof else None},
        {"name": "pso_update", "route": "cuda",
         "source": "src/repro_torch/csrc/pso_update.cu",
         "replaces": "src/repro/kernels/pso_update.py:72",
         "launches": launches["k2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by":
         "operations" if k2_ops / PEAK_FP32_FLOPS >= k2_bytes / PEAK_BYTES_PER_S else "bytes",
         "library_ms": None,
         "device_ms": prof["k2_device_ms_per_launch"] if prof else None},
    ]


def main() -> int:
    if not (PACKAGE / "kernels" / "_build.py").is_file():
        fail(f"{PACKAGE} not found: run from the root of a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from repro_torch.core import handmodel as hm
    from repro_torch.core import tracker as tracker_mod
    from repro_torch.data import rgbd
    from repro_torch.kernels import _build
    from repro_torch.kernels import pso_update as pu
    from repro_torch.kernels import render_score as rs

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_card(torch)
    phase_build(_build)

    seq, cfg = configs()
    frames, truth = rgbd.render_sequence(seq, device=device)
    check(frames.shape == (seq.num_frames, seq.camera.height, seq.camera.width)
          and bool(torch.isfinite(frames).all()), "rendered sequence is malformed")
    inputs = _population(torch, hm, cfg.camera, truth, frames, cfg.pso.num_particles,
                         device, seed=1)
    k1_err = phase_k1(torch, rs, inputs)
    k2_err = phase_k2(torch, pu, device)
    phase_eval_agrees(tracker_mod, _particles(torch, hm, truth[0], 16, device, seed=4),
                      frames, truth)
    launches = phase_main_path(torch, tracker_mod, rs, pu, frames, truth, device)
    prof = phase_profile(torch, tracker_mod, frames, truth, device)
    kernels = phase_timing(torch, rs, pu, inputs, device, k1_err, k2_err, launches, prof)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
