#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the hand tracker, and of its LLM
analogue (serving and training), on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from src/repro_torch/csrc with nvcc (sm_90a)
     and print ptxas' registers and spills;
  3. K1 (render_score) against its plain version on the card: full width
     on frame 1's bounding-box mask, a ragged shape, an all-ones, a
     non-binary and a single-pixel mask, an all-zero mask (exactly 0), a
     repeat (bit-identical), a NaN depth at a masked and at an unmasked
     pixel (every sum NaN, as the plain version), a NaN background
     (every sum NaN) and clamp_t = inf (every pixel scored);
  4. K2 (pso_update) against its plain version at (64, 27) and (13, 27),
     without and with the quaternion projection fused (the tracker's
     launch); FK (hand_spheres, the forward kinematics of the tracker's
     evaluation) against handmodel.pack_spheres on the card at the main
     path's population and with its angles beyond their limits and its
     quaternions off the unit sphere (radii and padding bit for bit,
     centers within 1e-6 m, the bit-equal elements counted); and the main
     path's evaluation on the card (FK + K1) against the plain objective
     on the CPU for the same particles;
  5. the main path: render a 30-frame 128x128 sequence and track it with
     ``Tracker`` at 64 particles x 30 generations from the true first
     pose, its step the whole frame captured into one CUDA graph
     (``tracker.FrameGraphs``, captured ahead of the clip: warm-up,
     capture and instantiate timed) and replayed a frame; mean position
     error < 3 cm; then the eager step
     (``capture=False``) from a generator seeded alike; for each path the
     frame time by CUDA events (mean, median, min, max), its replay
     through the 30 Hz ``FrameLoop`` (fps, drop rate) and the error;
     whether the generator-drawn frames are bit-equal (reported); then
     the graph and the eager step on the same draws (made on the card),
     h and score bit-equal on all 29 frames; last, the ``Tracker`` clip
     again, bit for bit with its first run, with the counts at 0 and
     under the profiler, whose kernel records give K1 31, K2 30 and FK
     31 runs on the card a frame (the warm-up's and each replay's) while
     the wrappers count their launches, the warm-up's and the capture's,
     each K2 with the projection fused;
  6. two frames of each path, graph and eager, under torch.profiler:
     device busy/idle share (of the profiled wall time, and of phase 5's
     unprofiled median frame), device activities a frame, kernel time per
     frame, and the profiler's records of K1's kernel (31 a frame) and
     K2's (30 a frame), on the graph path the graph's nodes;
  7. each kernel timed by CUDA events and profiler device time at the
     main path's shapes, beside its plain version and its bound on the
     card; K1 also on an all-ones mask, each with its kept-pixel count
     and a bound counted over the kept pixels; K2 fused and alone; FK at
     (64, 27) beside handmodel.pack_spheres (its device time and
     activities a call) and its byte bound;
  8. the uplink: the phase-5 sequence streamed through the port's
     ``DeltaStreamEncoder`` -> ``DeltaStreamDecoder`` on the card at
     threshold 0 (every frame decodes bit-identical) and 0.01 m (every
     pixel within it), and once with a packet lost (the forced keyframe
     arrives within ``resync_bound``), one launch a delta frame each
     way (K3 writing the next reference, K4 writing the decoder's state
     and the copy it returns; no K4 in the encoder, no copy after K4 in
     the decoder); ``change_density`` (K3b's
     mask-only launch) per transition and the wire ratio; K3b bit for bit
     against its plain version at change_density's own (29, 128, 128)
     call, and change_density equal to the mean of the plain masks and of
     the full launch's; K3, K3b (B = 4) and K4 bit for bit against their
     plain versions at 128x128, at the unaligned 240x320 and at 240x322
     (a width not a multiple of 4), with a NaN tile and a -0.0/+0.0 tile,
     and the mask-only K3 and K3b equal to the full launches' masks, K3
     with the reconstruction equal to K3 then K4 and the two-output K4 to
     K4, also on 32x64 and 9x130 tiles (over 1,024 pixels: the kernel's
     chunk loops); each timed beside its bound, K3 and K3b full and
     mask-only;
  9. the edge server's batched step at full width: 4 clients, each with
     its own decoded frame and 64-particle population, scored by K1b
     (each row equal to K1 on that client), updated by K2b with the
     quaternion projection fused at (4, 64, 27) (each swarm equal to the
     fused K2), and scored again; then K1b with a NaN in
     client 2's frame alone (row 2 NaN, every other row equal to K1); the
     fused launches timed against 4 solo launches (per_client_vs_solo);
 10. the quantized uplink: the clip through ``encode_frame`` ->
     ``decode_frame`` (one launch each a delta frame; for the keyframe
     one launch of K6 that also writes K7's reconstruction) in a closed
     loop at 16 and 8 bits over (0, 10 m): every
     pixel within step/2 + 2 ulp(10) of the clipped frame, each delta
     frame's exact wire bytes within 8 B of the reference's identity,
     each shipped words, mask and decoded frame equal to the composition
     of standalone kernels they replace (K6, K7, K6, K7, K3 mask-only; K7
     and the select), to K3's full launch's mask and to the CPU's; the
     one-launch encode and decode also at bits 16, 8, 4 and 2 on 8x128,
     8x64 and straddling 9x130 tiles, with NaN and oversized masks, and
     the decode on ragged tiles, where the encode raises; then the
     entropy stage: each threshold-0 residual and its per-tile widths from
     wire.entropy_residuals, one launch of K3 (the widths equal to K5's plain version and to the
     host coder's 64-word chunk widths), the host coder's roundtrip, and
     its bytes over raw at 2 mm noise and on a noise-free clip; each
     keyframe launch equal to K6 then K7 and each K3 launch with the
     widths to K3 then K5, and both to the CPU;
 11. K5, K5b, K6, K6b, the keyframe launch and K7 bit for bit against
     their plain versions at 128x128 and 240x320, every packable width,
     (lo, hi) in (0, 1) and (0.1, 10), with half-step ties and a
     NaN/+-inf/-0.0 tile (and K5 with a width-32 and a width-0 tile, on
     8x128, 32x64 and 9x130 tiles and off 16-byte alignment); whether
     PyTorch's own division by a Python float
     rounds those ties as the true division does;
 12. the codec model's density calibration on the card (K3b's mask-only
     launch at 8x32)
     against the port's CPU run: densities equal, (gain, floor) to 1e-9;
 13. in the batched step, K6b quantizes the 4 clients' frames and one
     launch of K3b writes their 4 residual planes and widths, equal to
     K3b then K5b and to the CPU, each row equal to K6 / K3 with the
     widths alone;
 14. the one-launch paths (encode, decode, K3 with the reconstruction,
     the two-output K4, K3 and K3b with the widths, the keyframe launch)
     timed beside the compositions they replace (events, profiler device
     time and activities a call, plain version, bound and its bytes);
     device activities per quantized closed-loop delta frame, old path
     against new; K4 against torch.bitwise_xor at 128x128, 240x320 and
     480x640;
 15. the paper's offload path: ``measure_wrapper`` on the card (pinned
     host <-> card round trips) beside ``paper_wrapper``'s constants;
     the 12 deployments of ``repro_torch.examples.edge_offload_serve``
     (Fig. 4 local runs, Fig. 5 networks x Forced/Auto x Single/Multi-
     Step) through ``runtime.executed_run`` at ``PAPER_TRACKER_CFG``
     (Camera() 128x128, 64 x 30) on a 36-frame clip with the example's
     fast burst: the simulated fps and drop rate (the cost model's, for
     the paper's tiers), the mean position error (< 3 cm on the local
     server runs), processed frames equal to ``analytic_run``'s replay,
     the card's wall time a processed frame by CUDA events, K1 31 and K2
     30 runs on the card a processed frame and a warm-up, by the
     profiler's kernel records (each deployment's step is the captured
     frame: one warm-up and capture a deployment, then its replays);
     the paper's orderings;
 16. the fleet (``repro_torch.cluster``, host code that launches no
     kernel: the counts are the same before and after it): the codec
     golden config's fleet (fleet_star 3 x 2, 6 clients, 40 frames, the
     sequence's motion) under phase 12's fit from the card, on both
     engines, equal event for event to each other and to the run under
     the CPU's fit, each client's final operating point beside the run
     under the module defaults; the reference's 13 golden configs,
     restated here (``fleet_golden_configs``), object engine equal to
     vector engine; a 1-client fleet against a capacity-1 edge for each
     of phase 15's 12 deployments, its processed frames equal to the
     ones ``executed_run`` tracked on the card; both engines' events/s
     at 256 clients x 16 edges x 120 frames on the host CPU;
 17. the LLM analogue's serving path (``repro_torch.models``,
     ``serving``, ``launch.serve``; torch.matmul/einsum, no kernel of the
     port: the counts are the same before and after it), float32 with
     TF32 off where results are compared: every reduced arch's forward,
     prefill and 10 decode steps on the card against the port's CPU run
     on the same parameters (drawn on the CPU, copied to the card),
     within LLM_TOL; the example's 8 requests on gemma-2b reduced through
     ``Engine`` (tokens equal to the CPU's) and ``ContinuousEngine`` (4
     slots, the same tokens); gemma-2b at full width in bfloat16 through
     ``launch.serve.run(device="cuda")`` at the reference's defaults
     (8 requests, 32-token prompts, 32 new tokens), its parameter count
     and peak memory, then the same run timed by CUDA events (prefill,
     decode a step, tok/s; every logit finite, every token in the
     vocabulary); and the same parameters in float32: prefill on 16
     tokens + 16 decode steps against the forward over 32, within
     LLM_FULL_DECODE_BOUND, with the bfloat16 run's first-token
     agreement printed;
 18. the LLM analogue's training path (``repro_torch.optim``,
     ``checkpoint``, ``data.tokens``, ``launch.train``; no kernel of the
     port: the counts are the same before and after it), float32 with
     TF32 off where results are compared: every reduced arch's loss and
     gradients (``loss_fn(remat=True)`` and ``torch.autograd.grad``) on
     the card against the port's CPU run on the same parameters, within
     TRAIN_TOL of each leaf's largest |g|, and remat off against on (the
     loss bit-equal, the gradients within TRAIN_REMAT_TOL);
     ``launch.train.run`` at the reference's integration settings
     (gemma-2b reduced, 40 steps of 4 x 64, lr 1e-3) lowering its loss,
     its step-40 checkpoint restored on the CPU; the parameters and AdamW
     state after 3 steps saved from the card by ``checkpoint.io`` and
     restored on the CPU bit for bit; gemma-2b at full width in bfloat16
     through ``train.run(reduced=False)`` for 4 steps of 8 x 256 (every
     logged loss and grad norm finite, the first loss beside ln V), then
     its train step timed by CUDA events beside the bound 6 N tokens at
     the data sheet's dense bfloat16 rate, one step's peak memory with
     and without remat (with remat lower, both under the card's memory),
     and one ``adamw.update`` at lr_scale 1 moving the bfloat16
     parameters;
 19. the multi-device path and the dry run (``launch.mesh``,
     ``sharding.specs``, ``roofline``, ``launch.dryrun``): a one-rank NCCL
     group and ``make_host_mesh()`` on the card; ``make_track_frame_sharded``
     at the main path's width (128x128, 64 x 30) over the clip's first
     frames on a generator seeded alike, eager, bit-equal to
     ``make_track_frame``'s captured frame (the graph),
     K1 31 and K2 30 launches a frame, < 3 cm; the reduced train step over
     the one-rank mesh bit-equal to the meshless step; the op census around
     one full-width gemma-2b decode step and train step at phases 17 and
     18's settings, its roofline terms at the data sheet's peaks beside
     their measured times; the dry run of gemma-2b train_4k and
     qwen3-moe-30b-a3b decode_32k on the (16, 16) mesh (a fake process
     group of 256 ranks), each in its own process started as the phase
     begins, so that it runs on the host while a-d use the card: status ok, the
     arguments' bytes per device equal to the specs' sum, an all-reduce in
     the train step, one expert-parallel combine a layer in the decode;
 20. one {"kernels": [...]} line with all twelve kernels, the seven
     one-launch paths and FK (K1's and K2's launches summed over the tracker,
     the offload grid and the sharded tracker: on the first two, whose
     steps are graphs, the runs on the card in the profiler's records),
     then the {"ok": ...} line last.

Each path (the tracker, the uplink, the quantized uplink with its
entropy stage, the batched step, the offload grid, the sharded tracker)
runs with the launch counts set to 0
just before it and read just after; a kernel of the path that was not
launched fails the run.  A wrapper counts the launches it makes, a
graph's at its capture; the graph's replays are counted from the
profiler's records of the card's kernels.

Needs one CUDA card and nvcc; there is no CPU fallback.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
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
# K1's and K2's kernels as the profiler's records name them, and forward
# kinematics' (FK, csrc/hand_spheres.cu)
KERNEL_NAMES = ("render_score_kernel", "pso_update_kernel")
FK_NAME = "hand_spheres_kernel"
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
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"CUDA {torch.version.cuda}  device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    return card


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


def _normalized_err(torch, got, want, mask, flip=0.30):
    """max |got - want| of the normalized scores, and whether it is within
    rtol K1_TOL_RTOL plus one silhouette flip (``flip``, the most one
    pixel's term can change: CLAMP_T at the defaults)."""
    denom = max(float(mask.sum()), 1.0)
    err = (got / denom - want / denom).abs()
    tol = K1_TOL_RTOL * (want / denom).abs() + flip / denom + 1e-6
    return float(err.max()), bool((err <= tol).all())


def _kept(torch, depth, mask):
    """The pixels whose term can be non-zero, which K1 scores: mask != 0
    or a NaN depth."""
    return (mask != 0) | torch.isnan(depth)


def _k1_masks(torch, depth, mask):
    """K1's mask cases beside the bounding box: all ones, weights 0.5 and
    2.0 on some pixels, and the first masked pixel alone."""
    nonbinary = mask.clone()
    nonbinary[::3] *= 0.5
    nonbinary[1::17] *= 2.0
    single = torch.zeros_like(mask)
    single[int(torch.nonzero(mask)[0])] = 1.0
    return {"all-ones": torch.ones_like(mask), "non-binary": nonbinary,
            "single-pixel": single}


def _with_nan(depth, mask, where):
    """depth with one NaN at the first pixel inside or outside the mask."""
    depth = depth.clone()
    pick = mask != 0 if where == "masked" else mask == 0
    depth[int(pick.nonzero()[0])] = float("nan")
    return depth


def phase_k1(torch, rs, inputs):
    spheres, rays, depth, mask = inputs
    got = rs.render_score_sums(spheres, rays, depth, mask)
    again = rs.render_score_sums(spheres, rays, depth, mask)
    want = rs.render_score_sums_plain(spheres, rays, depth, mask)
    torch.cuda.synchronize()
    err, ok = _normalized_err(torch, got, want, mask)
    check(ok, f"K1 full width disagrees with its plain version: max|err| {err:.3g}")
    check(torch.equal(got, again), "K1 repeat is not bit-identical")
    log(f"[K1] full width N={spheres.shape[0]} S={spheres.shape[1]} P={rays.shape[0]}, "
        f"frame 1's bounding-box mask ({int(_kept(torch, depth, mask).sum())} kept pixels): "
        f"max|err| of E_D {err:.3g} (tol rtol {K1_TOL_RTOL} + CLAMP_T/|B| + 1e-6), "
        f"repeat bit-identical")

    for label, m in _k1_masks(torch, depth, mask).items():
        c_err, c_ok = _normalized_err(torch, rs.render_score_sums(spheres, rays, depth, m),
                                      rs.render_score_sums_plain(spheres, rays, depth, m), m)
        check(c_ok, f"K1 on the {label} mask disagrees: max|err| {c_err:.3g}")
        log(f"[K1] full width, {label} mask ({int(_kept(torch, depth, m).sum())} kept "
            f"pixels): max|err| {c_err:.3g}")
        err = max(err, c_err)

    p = rays.shape[0] - 77  # not a multiple of the 256-pixel segment
    args = (spheres[:13], rays[:p], depth[:p], mask[:p])
    r_err, r_ok = _normalized_err(torch, rs.render_score_sums(*args),
                                  rs.render_score_sums_plain(*args), args[3])
    check(r_ok, f"K1 ragged shape disagrees: max|err| {r_err:.3g}")
    log(f"[K1] ragged N=13 P={p}: max|err| {r_err:.3g}")

    zero = rs.render_score_sums(spheres, rays, depth, torch.zeros_like(mask))
    check(bool((zero == 0).all()), "K1 with an all-zero mask is not exactly 0")
    log("[K1] all-zero mask: exactly 0")

    for where in ("masked", "unmasked"):
        d_nan = _with_nan(depth, mask, where)
        k = rs.render_score_sums(spheres, rays, d_nan, mask)
        plain = rs.render_score_sums_plain(spheres, rays, d_nan, mask)
        check(bool(torch.isnan(plain).all()) and bool(torch.isnan(k).all()),
              f"K1 with a NaN depth at one {where} pixel: {int(torch.isnan(k).sum())} of "
              f"{k.numel()} sums NaN, plain {int(torch.isnan(plain).sum())}")
        log(f"[K1] one NaN depth at one {where} pixel: all {k.numel()} sums NaN, "
            f"as the plain version")

    # The keywords of the reference's Pallas kernel: a NaN background
    # makes every sum NaN; clamp_t = inf scores every pixel (a masked-out
    # term is then |d_h - d_o| * 0), and one silhouette flip between a hit
    # (under 1 m) and the 10 m background can move a term by 11 m.
    kw = dict(background=float("nan"))
    k = rs.render_score_sums(spheres, rays, depth, mask, **kw)
    plain = rs.render_score_sums_plain(spheres, rays, depth, mask, **kw)
    check(bool(torch.isnan(plain).all()) and bool(torch.isnan(k).all()),
          f"K1 at a NaN background: {int(torch.isnan(k).sum())} of {k.numel()} sums NaN, "
          f"plain {int(torch.isnan(plain).sum())}")
    log(f"[K1] NaN background: all {k.numel()} sums NaN, as the plain version")
    kw = dict(clamp_t=float("inf"))
    k = rs.render_score_sums(spheres, rays, depth, mask, **kw)
    plain = rs.render_score_sums_plain(spheres, rays, depth, mask, **kw)
    c_err, c_ok = _normalized_err(torch, k, plain, mask, flip=11.0)
    check(c_ok and bool(torch.isfinite(k).all()),
          f"K1 at clamp_t = inf disagrees with its plain version: max|err| {c_err:.3g}")
    log(f"[K1] clamp_t = inf (every pixel scored): max|err| {c_err:.3g} "
        f"(tol rtol {K1_TOL_RTOL} + 11/|B| + 1e-6)")
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
        log(f"[K2] ({n}, 27): max|err| {err:.3g} (tol rtol = atol = {K2_TOL})")
        # the tracker's launch: the update and the quaternion projection fused
        args = (x.clone(), *args[1:])
        args[0][:, 3:7] *= 2.0  # off the unit sphere, as the update leaves it
        fx, fv = pu.pso_update_projected(*args, **consts)
        qx, qv = pu.pso_update_projected_plain(*args, **consts)
        torch.cuda.synchronize()
        for got, want in ((fx, qx), (fv, qv)):
            check(bool(torch.allclose(got, want, rtol=K2_TOL, atol=K2_TOL)),
                  f"fused K2 (update + projection) at ({n}, 27) disagrees with its plain version")
        f_err = max(float((fx - qx).abs().max()), float((fv - qv).abs().max()))
        norm_err = float((torch.linalg.vector_norm(fx[:, 3:7], dim=-1) - 1.0).abs().max())
        log(f"[K2] fused with the quaternion projection, ({n}, 27): max|err| {f_err:.3g} "
            f"(tol rtol = atol = {K2_TOL}); max ||q| - 1| {norm_err:.3g}")
        err = max(err, f_err)
        full_width_err = err if full_width_err is None else full_width_err
    return full_width_err


def phase_fk(torch, hm, hand_spheres, hs):
    """FK (csrc/hand_spheres.cu) against handmodel.pack_spheres on the
    card, at the main path's population and with its angles pushed
    beyond their limits and its quaternions off the unit sphere: radii
    and padding bit for bit, centers within 1e-6 m.  Returns the largest
    center error."""
    wild = hs.clone()
    wild[:, 7:] *= 3.0
    wild[:, 3:7] *= torch.linspace(1e-6, 3.0, hs.shape[0], device=hs.device)[:, None]
    err = 0.0
    for label, h in (("the main path's population", hs), ("angles x3, |q| 1e-6..3", wild)):
        got, want = hand_spheres.pack_spheres(h), hm.pack_spheres(h)
        torch.cuda.synchronize()
        check(_bit_equal(torch, got[..., 3], want[..., 3])
              and _bit_equal(torch, got[:, hm.NUM_SPHERES_RAW:], want[:, hm.NUM_SPHERES_RAW:]),
              f"FK on {label}: radii or padding differ from handmodel.pack_spheres")
        c_err = _value_err(torch, got[..., :3], want[..., :3])
        check(c_err <= 1e-6, f"FK on {label}: centers differ by {c_err:.3g} m")
        same = int((got.view(torch.int32) == want.view(torch.int32)).sum())
        log(f"[FK] {label}, ({h.shape[0]}, 27): {same} of {got.numel()} elements bit-equal "
            f"to handmodel.pack_spheres on the card, centers within {c_err:.3g} m")
        err = max(err, c_err)
    return err


def phase_eval_agrees(tracker_mod, hs, frames, truth):
    """The main path's population evaluation on the card (forward
    kinematics + K1 through ops.render_score) against the plain
    objective on the CPU, for the same particles hs."""

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


def _timed_frames(torch, step, frames, h0, draws_of=None, generator=None):
    """Track frames[1:] with ``step`` from h0, each frame timed by CUDA
    events; returns [(h, score)] and the times in ms."""
    h, out, frame_ms = h0, [], []
    for i in range(1, frames.shape[0]):
        draws = None if draws_of is None else draws_of(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        h, score = step(generator, h, frames[i], draws)
        end.record()
        end.synchronize()
        frame_ms.append(start.elapsed_time(end))
        out.append((h, score))
    return out, frame_ms


def _frame_stats(torch, label, out, frame_ms, truth):
    """Log a path's frame times and its 30 Hz FrameLoop replay; check its
    outputs are finite and its mean position error is under 3 cm."""
    from repro_torch.sim import clock

    for i, (h, score) in enumerate(out, start=1):
        check(bool(torch.isfinite(h).all()) and bool(torch.isfinite(score)),
              f"{label}: frame {i}: non-finite output")
    errs = [float(torch.linalg.vector_norm(h[:3] - truth[i][:3]))
            for i, (h, _) in enumerate(out, start=1)]
    tracked = len(frame_ms)
    stats = clock.FrameLoop(clock.CAMERA_FPS).run(
        lambda idx, gap: frame_ms[idx % tracked] / 1e3, tracked)
    row = {"mean_ms": statistics.fmean(frame_ms), "median_ms": statistics.median(frame_ms),
           "min_ms": min(frame_ms), "max_ms": max(frame_ms), "fps": stats.achieved_fps,
           "drop_rate": stats.drop_rate, "mean_err_cm": statistics.fmean(errs) * 100}
    log(f"[main] {label}: frame time by CUDA events over {tracked} frames: mean "
        f"{row['mean_ms']:.3f} ms, median {row['median_ms']:.3f} ms, min {row['min_ms']:.3f} ms, "
        f"max {row['max_ms']:.3f} ms; FrameLoop at {clock.CAMERA_FPS:.0f} Hz: "
        f"{row['fps']:.3f} fps, drop rate {row['drop_rate']:.3f}, mean gap "
        f"{stats.mean_gap:.2f}; mean position error {row['mean_err_cm']:.3f} cm "
        f"(max {max(errs) * 100:.3f} cm)")
    check(row["mean_err_cm"] < 3.0, f"{label}: mean position error {row['mean_err_cm']:.3f} cm "
          f">= 3 cm")
    return row


def _cost(cost_ms):
    return ", ".join(f"{k} {v:.1f} ms" for k, v in cost_ms.items())


def phase_main_path(torch, tracker_mod, rs, pu, frames, truth, device):
    """The main path, ``Tracker`` on the card, whose step is the frame
    captured into one CUDA graph, captured ahead of the clip and timed by
    CUDA events; then the eager step from a generator seeded alike; then
    the graph and the eager step on the same draws, bit for bit over the
    clip.  Last, the main path again, bit for bit with its first run,
    with the counts at 0 and under the profiler, whose records of the
    card's kernels count K1 and K2: 31 and 30 a frame, the warm-up's and
    each replay's; the wrappers count the launches they made, the
    warm-up's and the capture's.  Returns the main path's K1 and K2 runs
    on the card and each path's numbers."""
    from repro_torch.kernels import _build

    cfg = configs()[1]
    tracked, gens = frames.shape[0] - 1, cfg.pso.num_generations
    log(f"[main] Tracker: camera {cfg.camera.width}x{cfg.camera.height}, "
        f"{cfg.pso.num_particles} particles x {gens} generations, {tracked} tracked frames")

    def run_tracker():
        tracker = tracker_mod.Tracker(cfg, h0=truth[0], seed=0, device=device)
        check(isinstance(tracker._step, tracker_mod.FrameGraphs),
              "Tracker on the card did not build the captured frame")
        cost = tracker._step.capture(tracker.generator, tracker.h, frames[1])
        torch.cuda.synchronize()
        out, frame_ms = [], []
        for i in range(1, frames.shape[0]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            h, score = tracker.step(frames[i])
            end.record()
            end.synchronize()
            frame_ms.append(start.elapsed_time(end))
            out.append((h, torch.tensor(score)))
        return out, frame_ms, cost

    graph_out, graph_ms, cost = run_tracker()
    log(f"[main] the frame captured into one CUDA graph (generator-drawn): {_cost(cost)}")
    paths = {"graph": _frame_stats(torch, "graph (Tracker)", graph_out, graph_ms, truth)}
    paths["graph"]["capture_ms"] = cost

    eager = tracker_mod.make_track_frame(cfg, device, capture=False)
    eager(torch.Generator(device=device).manual_seed(1), truth[0], frames[1])  # first use
    torch.cuda.synchronize()
    eager_out, eager_ms = _timed_frames(torch, eager, frames, truth[0],
                                        generator=torch.Generator(device=device).manual_seed(0))
    paths["eager"] = _frame_stats(torch, "eager", eager_out, eager_ms, truth)
    same = sum(torch.equal(h, he) and float(s) == float(se)
               for (h, s), (he, se) in zip(graph_out, eager_out))
    log(f"[main] generator-drawn from equal seeds, graph vs eager: h and score bit-equal on "
        f"{same} of {tracked} frames (reported)")
    speedup = paths["eager"]["median_ms"] / paths["graph"]["median_ms"]
    log(f"[main] median frame, eager over graph: {speedup:.2f}x")

    # the same draws fed to both: one (frames, 1 + G, 2, N, D) tensor on the card
    n = cfg.pso.num_particles
    u = torch.rand((frames.shape[0], 1 + gens, 2, n, 27), device=device,
                   generator=torch.Generator(device=device).manual_seed(3))

    def draws_of(i):
        return (u[i, 0, 0], u[i, 0, 1]), [(u[i, g, 0], u[i, g, 1]) for g in range(1, 1 + gens)]

    graph = tracker_mod.make_track_frame(cfg, device)
    cost = graph.capture(None, truth[0], frames[1], draws_of(1))
    log(f"[main] the frame captured into one CUDA graph (draws given): {_cost(cost)}")
    g_out, g_ms = _timed_frames(torch, graph, frames, truth[0], draws_of)
    e_out, e_ms = _timed_frames(torch, eager, frames, truth[0], draws_of)
    differ = [i for i, ((h, s), (he, se)) in enumerate(zip(g_out, e_out), start=1)
              if not (torch.equal(h, he) and torch.equal(s, se))]
    log(f"[main] the same draws fed to both: h and score bit-equal on "
        f"{tracked - len(differ)} of {tracked} frames; median frame {statistics.median(g_ms):.3f} "
        f"ms graph (with its 0.44 MB draw copy), {statistics.median(e_ms):.3f} ms eager")
    check(not differ, f"the graph differs from the eager step on the same draws at frames "
          f"{differ}")
    _frame_stats(torch, "graph, draws given", g_out, g_ms, truth)
    _frame_stats(torch, "eager, draws given", e_out, e_ms, truth)

    # the counted run comes last: no timed run follows the profiler
    from repro_torch.kernels import hand_spheres

    torch.cuda.synchronize()
    rs.launches = hand_spheres.launches = 0
    pu.launches = pu.launches_projected = 0
    (counted_out, counted_ms, _), runs = _build.kernel_runs(run_tracker,
                                                            KERNEL_NAMES + (FK_NAME,))
    wrapped = (rs.launches, pu.launches, pu.launches_projected)
    k1, k2, fk = runs[KERNEL_NAMES[0]], runs[KERNEL_NAMES[1]], runs[FK_NAME]
    log(f"[main] the profiled run: the card ran K1 {k1} times (expected {(1 + tracked) * (1 + gens)}"
        f": {1 + gens} a frame, the warm-up's and {tracked} replays') and K2 {k2} times "
        f"(expected {(1 + tracked) * gens}), by the profiler's kernel records; the wrappers "
        f"launched K1 {wrapped[0]} and K2 {wrapped[1]} times, {wrapped[2]} with the quaternion "
        f"projection fused (expected {2 * (1 + gens)} and {2 * gens}: the warm-up's and the "
        f"capture's); its median frame {statistics.median(counted_ms):.3f} ms by CUDA events "
        f"under the profiler")
    check(k1 == (1 + tracked) * (1 + gens), "K1 runs on the card off the main path")
    check(k2 == (1 + tracked) * gens, "K2 runs on the card off the main path")
    check(wrapped == (2 * (1 + gens), 2 * gens, 2 * gens),
          f"the main path's wrappers launched K1, K2 and K2 projected {wrapped} times")
    log(f"[main] FK: {fk} runs on the card (one an evaluation, as K1), "
        f"{hand_spheres.launches} launches by its wrapper")
    check(fk == k1 and hand_spheres.launches == wrapped[0],
          f"FK ran {fk} times on the card and its wrapper launched it "
          f"{hand_spheres.launches} times; K1 {k1} and {wrapped[0]}")

    differ = [i for i, ((h, s), (hc, sc)) in enumerate(zip(graph_out, counted_out), start=1)
              if not (torch.equal(h, hc) and torch.equal(s, sc))]
    check(not differ, f"the profiled run differs from the timed run at frames {differ}")
    return {"k1": k1, "k2": k2, "fk": fk}, paths


def phase_profile(torch, tracker_mod, frames, truth, device, paths):
    """Two frames of each path under torch.profiler: device busy and idle
    share, device activities, and K1's and K2's kernels a frame from the
    profiler's records (31 and 30: on the graph path the graph's nodes,
    which the wrappers do not see at a replay).  The profiler
    slows the host, so the idle share is given twice: against the
    profiled wall time, and against phase 5's unprofiled median frame by
    CUDA events (``paths``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = configs()[1]
    out = {}
    for label in ("graph", "eager"):
        step = tracker_mod.make_track_frame(cfg, device, capture=label == "graph")
        gen = torch.Generator(device=device).manual_seed(2)
        step(gen, truth[0], frames[1])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            h = truth[1]
            for i in (2, 3):
                h, _ = step(gen, h, frames[i])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        check(bool(events), f"[profile] {label}: the profiler recorded no device activity")
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
            key = ("K1" if KERNEL_NAMES[0] in e.name else
                   "K2" if KERNEL_NAMES[1] in e.name else "other")
            by[key] += dur
            if key in count:
                count[key] += 1
        row = {
            "frame_ms": wall_us / 2 / 1e3,
            "busy_ms": busy / 2 / 1e3,
            "idle_share": 1.0 - busy / wall_us,
            "idle_share_vs_events": 1.0 - busy / 2 / 1e3 / paths[label]["median_ms"],
            "activities_per_frame": len(events) / 2,
            "k1_ms": by["K1"] / 2 / 1e3,
            "k2_ms": by["K2"] / 2 / 1e3,
            "other_ms": by["other"] / 2 / 1e3,
            "k1_device_ms_per_launch": by["K1"] / max(count["K1"], 1) / 1e3,
            "k2_device_ms_per_launch": by["K2"] / max(count["K2"], 1) / 1e3,
            "k1_kernels_per_frame": count["K1"] / 2,
            "k2_kernels_per_frame": count["K2"] / 2,
        }
        log(f"[profile] {label}, per frame: wall {row['frame_ms']:.3f} ms, device busy "
            f"{row['busy_ms']:.3f} ms (idle {row['idle_share'] * 100:.1f}% of the profiled "
            f"wall, {row['idle_share_vs_events'] * 100:.1f}% of phase 5's median frame "
            f"{paths[label]['median_ms']:.3f} ms), "
            f"{row['activities_per_frame']:.0f} device activities; K1 {row['k1_ms']:.3f} ms, "
            f"K2 {row['k2_ms']:.3f} ms, other kernels/copies {row['other_ms']:.3f} ms")
        log(f"[profile] {label}, device time per launch: K1 "
            f"{row['k1_device_ms_per_launch'] * 1e3:.2f} us (on the frames' own masks), K2 "
            f"{row['k2_device_ms_per_launch'] * 1e3:.2f} us; {row['k1_kernels_per_frame']:.0f} "
            f"render_score and {row['k2_kernels_per_frame']:.0f} pso_update kernels a frame")
        gens = cfg.pso.num_generations
        check(row["k1_kernels_per_frame"] == 1 + gens and row["k2_kernels_per_frame"] == gens,
              f"{label}: {row['k1_kernels_per_frame']} render_score and "
              f"{row['k2_kernels_per_frame']} pso_update kernels a frame in the profiler's "
              f"records, expected {1 + gens} and {gens}")
        out[label] = row
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


def _k1_work(torch, spheres, rays, depth, mask):
    """K1's work on one client's inputs: (ops, bytes) counted over the
    pixels it keeps, the same over all P (the work of a kernel that tests
    every pixel), and the kept-pixel count.  fp32 operations: 10 per (particle, pixel,
    sphere) test (the K=3 dot, the discriminant, its sign test, the
    running min), 4 more per test with disc >= 0 (sqrt, subtract, divide,
    t > 1e-4), 5 per (particle, pixel) for the clamped masked sum.
    Bytes: the spheres, mask and depth over all P, the rays of the kept
    pixels, the sums (each read or written once)."""
    n, s = spheres.shape[:2]
    p = rays.shape[0]
    keep = _kept(torch, depth, mask)
    kept = int(keep.sum())
    hits_kept = _disc_hits(torch, spheres, rays[keep])
    hits_all = hits_kept + _disc_hits(torch, spheres, rays[~keep])
    kept_work = (10 * n * kept * s + 4 * hits_kept + 5 * n * kept,
                 4 * (n * s * 4 + 2 * p + 3 * kept + n))
    full_work = (10 * n * p * s + 4 * hits_all + 5 * n * p, 4 * (n * s * 4 + 5 * p + n))
    return kept_work, full_work, kept


def _time_k1(torch, rs, label, args, reps=200):
    """One K1 case timed by CUDA events and profiler device time, beside
    its plain version and its bounds; returns its kernels-line fields."""
    spheres, rays, depth, mask = args
    fn = lambda: rs.render_score_sums(*args)
    ms = _time_ms(torch, fn, reps)
    dev = _device_ms(torch, fn, 20, ["render_score_kernel"])
    plain_ms = _time_ms(torch, lambda: rs.render_score_sums_plain(*args), 20)
    (ops, nbytes), (full_ops, full_bytes), kept = _k1_work(torch, *args)
    bound, by = _bound(ops, nbytes)
    full_bound, full_by = _bound(full_ops, full_bytes)
    log(f"[time] K1 at N={spheres.shape[0]} S={spheres.shape[1]} P={rays.shape[0]}, {label} "
        f"({kept} kept pixels): events {_us(ms)}, device {_us(dev)}, plain {_us(plain_ms)}; "
        f"bound {bound * 1e3:.4f} us over the kept pixels ({by}: {ops:.4g} fp32 ops / "
        f"67 TFLOP/s, {nbytes} B / 3.35 TB/s); the full-P bound (every pixel tested): "
        f"{full_bound * 1e3:.4f} us ({full_by}, {full_ops:.4g} ops); no single PyTorch "
        f"call computes it")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


def phase_timing(torch, rs, pu, inputs, device, k1_err, k2_err, fk_err, launches):
    from repro_torch.kernels import _build

    spheres, rays, depth, mask = inputs
    n, s = spheres.shape[:2]
    log(f"[time] K1's clusters of 8 blocks the card holds at once (N={n}, S={s}): "
        f"{_build.library().render_score_max_active_clusters(n, s)}; K1 launches {n}, "
        f"K1b at B={CLIENTS} {CLIENTS * n}")
    k1 = _time_k1(torch, rs, "frame 1's bounding-box mask", inputs)
    _time_k1(torch, rs, "all-ones mask", (spheres, rays, depth, torch.ones_like(mask)))
    dev = _device_ms(torch, lambda: rs.render_score_sums(*inputs, clamp_t=float("inf")), 20,
                     ["render_score_kernel"])
    log(f"[time] K1 at frame 1's mask and clamp_t = inf (every pixel scored): device "
        f"{_us(dev)}")

    consts = dict(inertia=0.7298, cognitive=1.49618, social=1.49618, velocity_clip=0.5)
    gen = torch.Generator(device=device).manual_seed(3)
    d = 27
    u = lambda *shape: torch.rand(shape, generator=gen, device=device)
    lo, hi = -0.5 - u(d), 0.5 + u(d)
    args = (lo + u(64, d) * (hi - lo), u(64, d) - 0.5, lo + u(64, d) * (hi - lo),
            lo + u(d) * (hi - lo), u(64, d), u(64, d), lo, hi)
    unfused = lambda: pu.pso_update(*args, **consts)
    fused = lambda: pu.pso_update_projected(*args, **consts)
    k2_unfused_ms = _time_ms(torch, unfused, 500)
    k2_unfused_dev = _device_ms(torch, unfused, 50, ["pso_update_kernel"])
    k2_ms = _time_ms(torch, fused, 500)
    k2_dev = _device_ms(torch, fused, 50, ["pso_update_kernel"])
    k2_plain = _time_ms(torch, lambda: pu.pso_update_projected_plain(
        *args, **consts), 200)
    k2_unfused_plain = _time_ms(torch, lambda: pu.pso_update_plain(*args, **consts), 200)
    # 17 fp32 ops per element, and per particle 7 for |q|^2, a sqrt, an
    # add and 4 divisions; bytes: five (N, D) planes read, three (D,) rows
    # read, two (N, D) planes written.
    k2_ops = 17 * 64 * d + 13 * 64
    k2_bytes = 4 * (7 * 64 * d + 3 * d)
    k2_bound, k2_by = _bound(k2_ops, k2_bytes)
    fk = _time_fk(torch, spheres.shape[0], device)
    log(f"[time] K2 at (64, {d}), update + quaternion projection (the tracker's launch): "
        f"events {_us(k2_ms)}, device {_us(k2_dev)}, plain {_us(k2_plain)} (the update, then "
        f"normalize_configuration's ops); update alone: events {_us(k2_unfused_ms)}, device "
        f"{_us(k2_unfused_dev)}, plain {_us(k2_unfused_plain)}; bound {k2_bound * 1e3:.4f} us "
        f"({k2_by}: {k2_bytes} B / 3.35 TB/s; {k2_ops} fp32 ops); no single PyTorch call "
        f"computes it")
    return [
        {"name": "render_score_sums", "route": "cuda",
         "source": "src/repro_torch/csrc/render_score.cu",
         "replaces": "src/repro/kernels/render_score.py:138",
         "launches": launches["k1"], "max_abs_err": k1_err, **k1},
        {"name": "pso_update", "route": "cuda",
         "source": "src/repro_torch/csrc/pso_update.cu",
         "replaces": "src/repro/kernels/pso_update.py:72",
         "launches": launches["k2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "device_ms": k2_dev},
        {"name": "hand_spheres", "route": "cuda",
         "source": "src/repro_torch/csrc/hand_spheres.cu",
         "replaces": "none: jnp ops in src/repro/core/handmodel.py:pack_spheres",
         "launches": launches["fk"], "max_abs_err": fk_err, **fk},
    ]


def _time_fk(torch, m, device):
    """FK at the main path's (M, 27) population, timed by CUDA events and
    profiler device time, beside handmodel.pack_spheres (its plain
    version) and its byte bound; returns its kernels-line fields."""
    from repro_torch.core import handmodel as hm
    from repro_torch.kernels import hand_spheres

    gen = torch.Generator(device=device).manual_seed(5)
    h = hm.normalize_configuration(torch.rand((m, 27), generator=gen, device=device))
    fn = lambda: hand_spheres.pack_spheres(h)
    ms = _time_ms(torch, fn, 500)
    dev = _device_ms(torch, fn, 50, [FK_NAME])
    plain_ms = _time_ms(torch, lambda: hm.pack_spheres(h), 50)
    plain_dev, plain_acts, _ = _device_ms(torch, lambda: hm.pack_spheres(h), 10)
    nbytes = 4 * (m * 27 + m * hm.NUM_SPHERES * 4)
    bound, by = _bound(0, nbytes)
    log(f"[time] FK at ({m}, 27): events {_us(ms)}, device {_us(dev)}, plain {_us(plain_ms)} "
        f"(handmodel.pack_spheres: device {_us(plain_dev)} over {plain_acts:.0f} activities a "
        f"call); bound {bound * 1e3:.4f} us ({by}: {nbytes} B / 3.35 TB/s); no single PyTorch "
        f"call computes it")
    return dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


# ---------------------------------------------------------------------------
# The uplink (delta codec: K3, K3b, K4) and the edge server's batched step
# (K1b, K2b).

STREAM_THRESHOLDS = (0.0, 0.01)  # lossless, and above the 2 mm sensor noise
CLIENTS = 4
UPDATE_CONSTS = dict(inertia=0.7298, cognitive=1.49618, social=1.49618, velocity_clip=0.5)


def _bit_equal(torch, a, b):
    """Same shape, dtype and bits (NaN payloads and signed zeros included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def _value_err(torch, got, want):
    """max |got - want|; NaN against NaN and an infinity against itself
    count 0, NaN against a number inf."""
    if got.numel() == 0:
        return 0.0
    if not got.is_floating_point():
        return float((got.long() - want.long()).abs().max())
    diff = torch.nan_to_num((got.double() - want.double()).abs(), nan=float("inf"))
    diff = torch.where((torch.isnan(got) & torch.isnan(want)) | (got == want), 0.0, diff)
    return float(diff.max())


def _device_ms(torch, fn, reps, names=None):
    """Device time (ms) by torch.profiler over ``reps`` calls of fn.  With
    ``names``, per launch of the kernel whose name contains one of them,
    for an fn that launches it once a call: the mean over the launches
    the profiler recorded (it may drop some; the count is printed then);
    None if it saw none.  Without, a triple: the time per call summed over
    every activity recorded on the card (kernels, copies, fills), the
    activities per call and their names; (None, None, []) if it saw
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if names is None:
        if not device:
            return None, None, []
        total = sum(e.time_range.end - e.time_range.start for e in device)
        return total / reps / 1e3, len(device) / reps, sorted({e.name[:40] for e in device})
    spans = [e.time_range.end - e.time_range.start for e in device
             if any(n in e.name for n in names)]
    if not spans:
        log(f"[profile] no device activity named {names} in {reps} calls; the profiler "
            f"saw {sorted({e.name for e in device})[:8]}")
        return None
    if len(spans) != reps:
        log(f"[profile] {len(spans)} launches of {names} recorded in {reps} calls")
    return sum(spans) / len(spans) / 1e3


def _us(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def _wire_nbytes(cref, packet, shape):
    """Bytes of one stream packet on the wire: a keyframe ships its raw
    float32 plane, a delta ``encoded_nbytes_exact`` of its change mask.
    For a threshold >= 0 a tile is changed exactly when its XOR words are
    not all 0 (|f - r| > 0 means the bits differ), so the mask is read
    off the payload."""
    h, w = shape
    if packet.kind == "key":
        return h * w * 4
    tiles = packet.payload.reshape(h // cref.DEFAULT_BLOCK_H, cref.DEFAULT_BLOCK_H,
                                   w // cref.DEFAULT_BLOCK_W, cref.DEFAULT_BLOCK_W)
    return cref.encoded_nbytes_exact((tiles != 0).any(dim=3).any(dim=1).float())


def phase_uplink(torch, cref, wire, frames):
    """Stream the sequence through the port's encoder and decoder on the
    card.  Returns the frames the 0.01 m stream decoded, and
    change_density's result at each threshold."""
    t_count, h, w = frames.shape
    raw = t_count * h * w * 4
    decoded_lossy, densities = None, {}
    for thr in STREAM_THRESHOLDS:
        enc = wire.DeltaStreamEncoder(threshold=thr)
        dec = wire.DeltaStreamDecoder()
        nbytes, worst, decoded = 0, 0.0, []
        for t in range(t_count):
            packet = enc.encode(frames[t])
            got = dec.decode(packet)
            check(got is not None and got.is_cuda and got.shape == (h, w),
                  f"stream at threshold {thr}: frame {t} did not decode on the card")
            if thr == 0.0:
                check(_bit_equal(torch, got, frames[t]),
                      f"stream at threshold 0: frame {t} is not bit-identical to its source")
            err = float((got - frames[t]).abs().max())
            check(err <= thr, f"stream at threshold {thr}: frame {t} off by {err:.4g}")
            worst = max(worst, err)
            nbytes += _wire_nbytes(cref, packet, (h, w))
            decoded.append(got)
        density = densities[thr] = wire.change_density(frames, threshold=thr)
        check(density.shape == (t_count - 1,) and bool(torch.isfinite(density).all()),
              "change_density is malformed")
        log(f"[uplink] threshold {thr} m, keyframe every {enc.keyframe_interval}: "
            f"{t_count} frames decoded on the card, max |decoded - source| {worst:.4g} m"
            + (" (every frame bit-identical)" if thr == 0.0 else "")
            + f"; wire {nbytes} B of {raw} B raw, ratio {nbytes / raw:.4f}")
        log(f"[uplink] change_density at {thr} m per transition: "
            + " ".join(f"{d:.4f}" for d in density.tolist())
            + f" (mean {float(density.mean()):.4f})")
        if thr > 0.0:
            decoded_lossy = torch.stack(decoded)

    lost = 5
    enc = wire.DeltaStreamEncoder(keyframe_interval=t_count, resync_bound=4)
    dec = wire.DeltaStreamDecoder()
    resync = None
    for t in range(t_count):
        packet = enc.encode(frames[t])
        if packet.seq == lost:
            check(packet.kind == "delta", "the lost packet is not a delta")
            enc.report_loss(lost)
            continue
        got = dec.decode(packet)
        if packet.kind == "key" and packet.seq > lost and resync is None:
            resync = packet.seq
        if got is not None:
            check(_bit_equal(torch, got, frames[t]), f"lossy stream: frame {t} decoded wrong")
    check(resync is not None and resync - lost <= enc.resync_bound,
          f"no keyframe within resync_bound {enc.resync_bound} of the loss (got {resync})")
    check(enc.forced_keyframes == 1 and dec.nacks == resync - lost - 1,
          f"forced keyframes {enc.forced_keyframes}, NACKs {dec.nacks}")
    log(f"[uplink] packet {lost} lost: forced keyframe at packet {resync} "
        f"(resync_bound {enc.resync_bound}), {dec.nacks} NACKs, "
        f"{dec.decoded} of {t_count} frames decoded, each bit-identical")
    return decoded_lossy, densities


def _codec_planes(torch, frames, h, w, device, seed):
    """B = 4 (frame, ref) pairs of (h, w): consecutive frames of the
    sequence in the top-left corner of a noisy background plane (10 m,
    2 mm noise) where (h, w) is larger; tile (0, 0) moves by 0.2 m but
    holds a NaN, and tile (1, 0) differs only by -0.0 against +0.0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    planes = 10.0 + 0.002 * torch.randn((CLIENTS + 1, h, w), generator=gen, device=device)
    fh, fw = min(h, frames.shape[1]), min(w, frames.shape[2])
    planes[:, :fh, :fw] = frames[:CLIENTS + 1, :fh, :fw]
    f, r = planes[1:].clone(), planes[:-1].clone()
    f[:, :4, :16] += 0.2
    f[:, 2, 3] = float("nan")
    f[:, 8:16, :128] = r[:, 8:16, :128]
    r[:, 9, 3] = 0.0
    f[:, 9, 3] = -0.0
    return f, r


def phase_codec_kernels(torch, ck, frames, densities, device):
    """K3, K3b and K4 bit for bit against their plain versions: K3b at
    the shape the uplink gave it (change_density's transitions of the
    sequence), then all three on planes with a NaN and a signed-zero
    tile."""
    errs = {"k3": 0.0, "k3b": 0.0, "k4": 0.0, "k3_recon": 0.0, "k4_pair": 0.0,
            "k3_widths": 0.0, "k3b_widths": 0.0}

    def check_recon(f, r, d, m, label, **tile):
        """K3 with the reconstruction against K3 then K4 (d, m from K3) and
        its CPU plain version, bit for bit."""
        rd, rm, recon = ck._delta_encode_recon(f, r, **tile)
        plain = ck._delta_encode_recon(f.cpu(), r.cpu(), **tile)[2]
        check(_bit_equal(torch, rd, d) and _bit_equal(torch, rm, m)
              and _bit_equal(torch, recon, ck.delta_decode(d, r))
              and _bit_equal(torch, recon.cpu(), plain),
              f"K3 with the reconstruction at {label}: differs from K3 then K4 or the CPU")
        errs["k3_recon"] = max(errs["k3_recon"], _value_err(torch, recon.cpu(), plain))

    def check_widths(f, r, bd, bm, label, **tile):
        """K3b with the widths against K3b then K5b (bd, bm from K3b) and
        its CPU plain version, each row against K3 with the widths on
        that client, bit for bit."""
        bh, bw = tile["block_h"], tile["block_w"]
        d, m, widths = ck._delta_encode_widths(f, r, **tile)
        plain = ck._delta_encode_widths(f.cpu(), r.cpu(), **tile)
        check(_bit_equal(torch, d, bd) and _bit_equal(torch, m, bm)
              and _bit_equal(torch, widths, ck.significant_bit_widths_batched(
                  bd, block_h=bh, block_w=bw))
              and all(_bit_equal(torch, a.cpu(), b) for a, b in zip((d, m, widths), plain)),
              f"K3b with the widths at {label}: differs from K3b then K5b or the CPU")
        errs["k3b_widths"] = max(errs["k3b_widths"], _value_err(torch, widths.cpu(), plain[2]))
        for i in range(f.shape[0]):
            di, mi, wi = ck._delta_encode_widths(f[i], r[i], **tile)
            check(_bit_equal(torch, di, d[i]) and _bit_equal(torch, mi, m[i])
                  and _bit_equal(torch, wi, widths[i])
                  and _bit_equal(torch, wi, ck.significant_bit_widths(
                      ck.delta_encode(f[i], r[i], **tile)[0], block_h=bh, block_w=bw)),
                  f"K3 with the widths at {label}, client {i}: differs from K3b's row or "
                  f"from K3 then K5")
            errs["k3_widths"] = max(errs["k3_widths"], _value_err(torch, wi.cpu(), plain[2][i]))

    for thr, density in densities.items():
        bd, bm = ck.delta_encode_batched(frames[1:], frames[:-1], threshold=thr)
        pd, pm = ck.delta_encode_plain(frames[1:], frames[:-1], threshold=thr)
        check(_bit_equal(torch, bd, pd) and _bit_equal(torch, bm, pm),
              f"K3b at {tuple(bd.shape)}, threshold {thr}: differs from its plain version")
        check(_bit_equal(torch, density, pm.mean(dim=(1, 2)))
              and _bit_equal(torch, density, bm.mean(dim=(1, 2))),
              f"change_density (K3b's mask-only launch) at threshold {thr} differs from "
              f"the mean of the plain masks or of the full launch's")
        errs["k3b"] = max(errs["k3b"], _value_err(torch, bd, pd), _value_err(torch, bm, pm))
    log(f"[codec] K3b at change_density's {tuple(frames[1:].shape)}, thresholds "
        f"{tuple(densities)}: delta and mask bit-identical to the plain version, "
        f"change_density (mask-only launch) equal to the mean of the plain masks and of "
        f"the full launch's")
    for h, w in ((128, 128), (240, 320), (240, 322)):
        f, r = _codec_planes(torch, frames, h, w, device, seed=h)
        for thr in STREAM_THRESHOLDS:
            d, m = ck.delta_encode(f[0], r[0], threshold=thr)
            pd, pm = ck.delta_encode_plain(f[:1], r[:1], threshold=thr)
            check(_bit_equal(torch, d, pd[0]) and _bit_equal(torch, m, pm[0]),
                  f"K3 at {h}x{w}, threshold {thr}: differs from its plain version")
            check(m.dtype == torch.float32 and m.shape == (-(-h // 8), -(-w // 128))
                  and float(m[0, 0]) == 0.0 and float(m[1, 0]) == 0.0,
                  f"K3 at {h}x{w}: the NaN or the signed-zero tile is marked changed")
            errs["k3"] = max(errs["k3"], _value_err(torch, d, pd[0]),
                             _value_err(torch, m, pm[0]))
            bd, bm = ck.delta_encode_batched(f, r, threshold=thr)
            pbd, pbm = ck.delta_encode_plain(f, r, threshold=thr)
            check(_bit_equal(torch, bd, pbd) and _bit_equal(torch, bm, pbm),
                  f"K3b at B={CLIENTS}, {h}x{w}: differs from its plain version")
            for i in range(CLIENTS):
                di, mi = ck.delta_encode(f[i], r[i], threshold=thr)
                check(_bit_equal(torch, bd[i], di) and _bit_equal(torch, bm[i], mi),
                      f"K3b row {i} at {h}x{w} differs from K3 on that client")
            check(_bit_equal(torch, ck._delta_mask(f[0], r[0], threshold=thr), m)
                  and _bit_equal(torch, ck._delta_mask(f, r, threshold=thr), bm),
                  f"the mask-only K3 or K3b at {h}x{w}, threshold {thr}: differs from the "
                  f"full launch's mask")
            errs["k3b"] = max(errs["k3b"], _value_err(torch, bd, pbd),
                              _value_err(torch, bm, pbm))
            out = ck.delta_decode(d, r[0])
            want = ck.delta_decode_plain(d, r[0])
            check(_bit_equal(torch, out, want), f"K4 at {h}x{w} differs from its plain version")
            errs["k4"] = max(errs["k4"], _value_err(torch, out, want))
            changed = m.repeat_interleave(8, 0).repeat_interleave(128, 1)[:h, :w] > 0
            check(_bit_equal(torch, out[changed], f[0][changed]),
                  f"K3 -> K4 at {h}x{w}: a changed tile does not reconstruct bit for bit")
            check_recon(f[0], r[0], d, m, f"{h}x{w}, threshold {thr}", threshold=thr)
            check_widths(f, r, bd, bm, f"{h}x{w}, threshold {thr}", threshold=thr, block_h=8,
                         block_w=128)
            state, copy = ck._delta_decode_pair(d, r[0])
            check(_bit_equal(torch, state, out) and _bit_equal(torch, copy, out)
                  and state.data_ptr() != copy.data_ptr(),
                  f"the two-output K4 at {h}x{w} differs from K4 or wrote one tensor")
            errs["k4_pair"] = max(errs["k4_pair"], _value_err(torch, state, want),
                                  _value_err(torch, copy, want))
        log(f"[codec] {h}x{w}, thresholds {STREAM_THRESHOLDS}: K3, K3b (B={CLIENTS}, rows = K3) "
            f"and K4 bit-identical to their plain versions, the mask-only K3 and K3b to the "
            f"full launches' masks, K3 with the reconstruction to K3 then K4, K3b and K3 with "
            f"the widths to K3b then K5b and K3 then K5, the two-output K4 to K4; NaN and "
            f"-0.0/+0.0 tiles unchanged (width 0)")
    # tiles of over 1,024 pixels run the kernel's loops over later chunks:
    # 32x64 on the vector path, 9x130 on the scalar path, both ragged
    for h, w, bh, bw in ((240, 320, 32, 64), (240, 322, 9, 130)):
        f, r = _codec_planes(torch, frames, h, w, device, seed=h + bh)
        for thr in STREAM_THRESHOLDS:
            tile = dict(threshold=thr, block_h=bh, block_w=bw)
            d, m = ck.delta_encode(f[0], r[0], **tile)
            bd, bm = ck.delta_encode_batched(f, r, **tile)
            pd, pm = ck.delta_encode_plain(f, r, **tile)
            check(_bit_equal(torch, d, pd[0]) and _bit_equal(torch, m, pm[0])
                  and _bit_equal(torch, bd, pd) and _bit_equal(torch, bm, pm),
                  f"K3 or K3b at {h}x{w} on {bh}x{bw} tiles, threshold {thr}: differs from "
                  f"its plain version")
            check(_bit_equal(torch, ck._delta_mask(f[0], r[0], **tile), m)
                  and _bit_equal(torch, ck._delta_mask(f, r, **tile), bm),
                  f"the mask-only K3 or K3b at {h}x{w} on {bh}x{bw} tiles: differs from the "
                  f"full launch's mask")
            errs["k3"] = max(errs["k3"], _value_err(torch, d, pd[0]))
            errs["k3b"] = max(errs["k3b"], _value_err(torch, bd, pd))
            check_recon(f[0], r[0], d, m, f"{h}x{w} on {bh}x{bw} tiles, threshold {thr}",
                        **tile)
            check_widths(f, r, bd, bm, f"{h}x{w} on {bh}x{bw} tiles, threshold {thr}", **tile)
        log(f"[codec] {h}x{w} on {bh}x{bw} tiles ({bh * bw} pixels), thresholds "
            f"{STREAM_THRESHOLDS}: K3, K3b, their mask-only launches, K3 with the "
            f"reconstruction and K3/K3b with the widths bit-identical to the plain version "
            f"(and to K3 then K4, K3 then K5, K3b then K5b)")
    return errs


# ---------------------------------------------------------------------------
# The quantized uplink (encode_frame/decode_frame: K6, K7, K3), the entropy
# stage (K5 and the host coder), the quantizer kernels against their plain
# versions, and the codec model's density calibration (K3b).

QUANT_BITS = (16, 8)  # the rate controller's bits_ladder
HEADER_NBYTES = 64


def phase_quant_uplink(torch, ck, cref, wire, frames, lo, hi):
    """The clip through the quantized wire format in a closed loop on the
    card: frame 0 is a keyframe (K6's launch that also writes K7's
    reconstruction), every later frame is encoded against the receiver's
    previous reconstruction and decoded.  Returns the ratios, each delta
    frame's (bits, frame, reference, words, mask, decoded frame) for
    phase_encode_masks, and each keyframe's (bits, words, reconstruction)
    for phase_path_compositions."""
    import numpy as np

    t_count, h, w = frames.shape
    raw = h * w * 4
    tol_ulp = 2 * float(np.spacing(np.float32(hi)))
    out, encoded, keyframes = {}, [], []
    for bits in QUANT_BITS:
        step = cref.quant_step(lo, hi, bits)
        words, recon = wire.encode_keyframe(frames[0], lo, hi, bits=bits)
        keyframes.append((bits, words, recon))
        wire_nbytes = HEADER_NBYTES + words.numel() * 4
        densities, worst, identity_gap = [], 0.0, 0.0
        for t in range(t_count):
            if t:
                words, mask = wire.encode_frame(frames[t], recon, lo, hi, bits=bits)
                ref = recon
                recon = wire.decode_frame(words, mask, ref, lo, hi, bits=bits)
                encoded.append((bits, frames[t], ref, words, mask, recon))
                density = float(mask.mean())
                exact = cref.encoded_nbytes_exact(mask, bits=bits,
                                                  header_nbytes=HEADER_NBYTES)
                modeled = HEADER_NBYTES + raw * density * bits / 32 + mask.numel() / 8
                identity_gap = max(identity_gap, abs(exact - modeled))
                check(abs(exact - modeled) <= 8,
                      f"quantized uplink at {bits} bits, frame {t}: {exact} B on the wire "
                      f"against the identity's {modeled:.1f} B")
                wire_nbytes += exact
                densities.append(density)
            check(recon.is_cuda and recon.shape == (h, w) and recon.dtype == torch.float32,
                  f"quantized uplink at {bits} bits: frame {t} did not decode on the card")
            err = float((recon - frames[t].clamp(lo, hi)).abs().max())
            check(err <= step / 2 + tol_ulp,
                  f"quantized uplink at {bits} bits: frame {t} off by {err:.6g} "
                  f"> step/2 + 2 ulp = {step / 2 + tol_ulp:.6g}")
            worst = max(worst, err)
        ratio = wire_nbytes / (raw * t_count)
        out[bits] = {"density": statistics.fmean(densities), "ratio": ratio, "worst": worst}
        log(f"[quant] {bits} bits over ({lo}, {hi}) m, step {step:.6g} m: {t_count} frames "
            f"decoded on the card in a closed loop, max |decoded - clip(frame)| {worst:.6g} "
            f"(<= step/2 + 2 ulp = {step / 2 + tol_ulp:.6g}); mean change density "
            f"{out[bits]['density']:.4f}; wire {wire_nbytes} B of {raw * t_count} B raw, "
            f"ratio {ratio:.4f} (keyframe + {t_count - 1} deltas, {HEADER_NBYTES} B headers); "
            f"exact bytes within {identity_gap:.3f} B of the model's identity")
    return out, encoded, keyframes


def old_encode_frame(ck, cref, frame, ref, lo, hi, bits, block_h=8, block_w=128):
    """encode_frame as five launches of the standalone kernels, as it ran
    before its one launch: K6, K7, K6, K7, then K3's mask-only launch at
    threshold step/2."""
    words = ck.quantize_pack(frame, lo, hi, bits=bits)
    recon = ck.unpack_dequantize(words, lo, hi, bits=bits)
    ref_recon = ck.unpack_dequantize(ck.quantize_pack(ref, lo, hi, bits=bits), lo, hi,
                                     bits=bits)
    step = cref.quant_step(lo, hi, bits)
    return words, ck._delta_mask(recon, ref_recon, threshold=step / 2, block_h=block_h,
                                 block_w=block_w)


def old_decode_frame(ck, cref, words, mask, ref, lo, hi, bits, block_h=8, block_w=128):
    """decode_frame as it ran before its one launch: K7, then the mask
    select's eager ops."""
    recon = ck.unpack_dequantize(words, lo, hi, bits=bits)
    return cref.select_tiles(recon, mask, ref, block_h, block_w)


def phase_encode_masks(torch, ck, cref, wire, encoded, lo, hi):
    """Each delta frame the quantized uplink shipped and decoded (one
    launch each) against the composition of standalone kernels it
    replaced, on the same planes, and against the plain composition on
    the CPU, bit for bit: the words, the mask and the decoded frame."""
    for bits, frame, ref, words, mask, decoded in encoded:
        old_words, old_mask = old_encode_frame(ck, cref, frame, ref, lo, hi, bits)
        _, full = ck.delta_encode(
            ck.unpack_dequantize(old_words, lo, hi, bits=bits),
            ck.unpack_dequantize(ck.quantize_pack(ref, lo, hi, bits=bits), lo, hi, bits=bits),
            threshold=cref.quant_step(lo, hi, bits) / 2)
        host_words, host_mask = wire.encode_frame(frame.cpu(), ref.cpu(), lo, hi, bits=bits)
        check(_bit_equal(torch, words, old_words) and _bit_equal(torch, words.cpu(), host_words),
              f"encode_frame's words at {bits} bits differ from K6's or the CPU's")
        check(_bit_equal(torch, mask, old_mask) and _bit_equal(torch, mask, full)
              and _bit_equal(torch, mask.cpu(), host_mask),
              f"encode_frame's mask at {bits} bits differs from K3's mask-only or full launch "
              f"on K7's planes, or from the CPU")
        host = wire.decode_frame(host_words, host_mask, ref.cpu(), lo, hi, bits=bits)
        check(_bit_equal(torch, decoded, old_decode_frame(ck, cref, words, mask, ref, lo, hi, bits))
              and _bit_equal(torch, decoded.cpu(), host),
              f"decode_frame at {bits} bits differs from K7 and the select, or from the CPU")
    log(f"[quant] the {len(encoded)} delta frames encode_frame and decode_frame shipped and "
        f"decoded in one launch each equal the composition of standalone kernels they "
        f"replace (K6, K7, K6, K7, K3 mask-only; K7 and the select), K3's full launch's mask "
        f"and the CPU composition, bit for bit")


def phase_entropy(torch, ck, cref, wire, clips):
    """The entropy stage on the threshold-0 residual planes of each clip,
    each with its per-tile widths from wire.entropy_residuals, one launch
    of K3 (against K5's
    plain version and the host coder's chunk widths), the host coder's
    roundtrip, and its bytes over raw.  Returns the ratios, and each
    residual's (frame, reference, delta, mask, widths) for
    phase_path_compositions."""
    import numpy as np

    ratios, residuals = {}, []
    for label, clip in clips.items():
        t_count, h, w = clip.shape
        coded = raw = 0
        for t in range(1, t_count):
            delta, mask, widths = wire.entropy_residuals(clip[t], clip[t - 1])
            residuals.append((clip[t], clip[t - 1], delta, mask, widths))
            host = delta.cpu()
            check(_bit_equal(torch, widths.cpu(), ck.significant_bit_widths_plain(host[None])[0]),
                  f"K5 on the {label} residual {t} differs from its plain version")
            words = host.numpy()
            if w == cref.DEFAULT_BLOCK_W:  # an (8, 128) tile holds 16 whole 64-word chunks
                chunks = words.view(np.uint32).reshape(-1, cref.ENTROPY_TILE).max(axis=1)
                chunk_widths = np.array([int(c).bit_length() for c in chunks])
                per_tile = chunk_widths.reshape(widths.numel(), -1).max(axis=1)
                check(np.array_equal(per_tile, widths.cpu().numpy().ravel()),
                      f"K5 on the {label} residual {t} disagrees with the coder's chunk widths")
            data = cref.entropy_encode_words(words)
            check(np.array_equal(cref.entropy_decode_words(data, words.size), words.ravel()),
                  f"the entropy coder does not roundtrip the {label} residual {t}")
            coded += len(data)
            raw += words.size * 4
        ratios[label] = coded / raw
        log(f"[entropy] {label} clip: {t_count - 1} threshold-0 residual planes of {h}x{w}, "
            f"each with its widths from one K3 launch: widths equal K5's plain version and "
            f"the coder's 64-word chunk widths; coder roundtrip bit-identical; {coded} B of "
            f"{raw} B raw, ratio {ratios[label]:.4f} (measured; sim/hardware.codec_point "
            f"assumes 0.55)")
    return ratios, residuals


def phase_path_compositions(torch, ck, wire, keyframes, residuals, frame0, lo, hi):
    """The quantized uplink's keyframe launches against K6 then K7, and the
    entropy stage's K3 launches with the widths against K3 then K5, on the
    same inputs, and both against the CPU's plain composition, bit for
    bit (after the path's launch counts were read)."""
    err = {"k6_recon": 0.0, "k3_widths": 0.0}
    for bits, words, recon in keyframes:
        k6 = ck.quantize_pack(frame0, lo, hi, bits=bits)
        host_words, host_recon = wire.encode_keyframe(frame0.cpu(), lo, hi, bits=bits)
        check(_bit_equal(torch, words, k6) and _bit_equal(torch, words.cpu(), host_words)
              and _bit_equal(torch, recon, ck.unpack_dequantize(k6, lo, hi, bits=bits))
              and _bit_equal(torch, recon.cpu(), host_recon),
              f"the keyframe launch at {bits} bits differs from K6 then K7 or from the CPU")
        err["k6_recon"] = max(err["k6_recon"], _value_err(torch, recon.cpu(), host_recon))
    for f, r, delta, mask, widths in residuals:
        k3_delta, k3_mask = ck.delta_encode(f, r)
        host = wire.entropy_residuals(f.cpu(), r.cpu())
        check(_bit_equal(torch, delta, k3_delta) and _bit_equal(torch, mask, k3_mask)
              and _bit_equal(torch, widths, ck.significant_bit_widths(k3_delta))
              and all(_bit_equal(torch, a.cpu(), b) for a, b in zip((delta, mask, widths), host)),
              "a residual of the entropy stage differs from K3 then K5 or from the CPU")
        err["k3_widths"] = max(err["k3_widths"], _value_err(torch, widths.cpu(), host[2]))
    log(f"[quant] the {len(keyframes)} keyframe launches equal K6 then K7 (words and the "
        f"reconstruction's bits) and the CPU; the entropy stage's {len(residuals)} K3 launches "
        f"with the widths equal K3 then K5 (delta, mask, widths) and the CPU, bit for bit")
    return err


def _quant_planes(torch, h, w, lo, hi, bits, device, seed, b=CLIENTS):
    """(b, h, w) planes: uniform over 10% beyond [lo, hi] on both sides,
    exact half-step ties in every other row, and in tile (0, 0) NaN,
    +-inf, -0.0, the range's ends and points just outside them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    span = hi - lo
    x = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, (b, h, w)).astype(np.float32)
    step = np.float32((hi - lo) / ((1 << bits) - 1))
    k = rng.integers(0, (1 << bits) - 1, (b, h // 2, w))
    x[:, ::2] = np.float32(lo) + (k + 0.5).astype(np.float32) * step
    x[:, 1, :10] = [np.nan, np.inf, -np.inf, -0.0, 0.0, lo, hi, lo - 1.0, hi + 1.0, np.nan]
    return torch.from_numpy(x).to(device)


def phase_quant_kernels(torch, ck, cref, frames, device):
    """K6b/K6, K6's keyframe launch and K7 at every packable width and
    K5b/K5, bit for bit against their plain versions run on the CPU copy
    of the inputs (the keyframe launch also against K6 then K7)."""
    errs = {"k5": 0.0, "k5b": 0.0, "k6": 0.0, "k6b": 0.0, "k7": 0.0, "k6_recon": 0.0}
    ties = moved = 0
    for h, w in ((128, 128), (240, 320)):
        for lo, hi in ((0.0, 1.0), (0.1, 10.0)):
            for bits in cref.PACKABLE_BITS:
                x = _quant_planes(torch, h, w, lo, hi, bits, device, seed=bits + h)
                words = ck.quantize_pack_batched(x, lo, hi, bits=bits)
                host = x.cpu()
                want = ck.quantize_pack_plain(host, lo, hi, bits=bits)
                check(_bit_equal(torch, words.cpu(), want),
                      f"K6b at {h}x{w}, ({lo}, {hi}), {bits} bits: differs from its plain version")
                check(_bit_equal(torch, ck.quantize_pack_plain(x, lo, hi, bits=bits).cpu(), want),
                      f"the quantizer's plain version on the card differs from the CPU's "
                      f"at {h}x{w}, ({lo}, {hi}), {bits} bits")
                errs["k6b"] = max(errs["k6b"], _value_err(torch, words.cpu(), want))
                # PyTorch's own CUDA division by a Python float, on the same ties
                step = cref.quant_step(lo, hi, bits)
                clipped = torch.nan_to_num(x.clamp(lo, hi), nan=lo) - lo
                by_float = torch.round(clipped / step)
                by_tensor = torch.round(clipped / torch.tensor(step, device=device))
                moved += int((by_float != by_tensor).sum())
                ties += int((clipped / torch.tensor(step, device=device)).frac().eq(0.5).sum())
                for i in range(CLIENTS):
                    solo = ck.quantize_pack(x[i], lo, hi, bits=bits)
                    check(_bit_equal(torch, solo, words[i]),
                          f"K6b row {i} at {h}x{w}, {bits} bits differs from K6 on that plane")
                    errs["k6"] = max(errs["k6"], _value_err(torch, solo.cpu(), want[i]))
                    values = ck.unpack_dequantize(solo, lo, hi, bits=bits)
                    plain = ck.unpack_dequantize_plain(want[i], lo, hi, bits=bits)
                    check(_bit_equal(torch, values.cpu(), plain),
                          f"K7 at {h}x{w}, ({lo}, {hi}), {bits} bits: differs from its plain version")
                    errs["k7"] = max(errs["k7"], _value_err(torch, values.cpu(), plain))
                # one plane a float off 16-byte alignment: the kernels' scalar path
                flat = x.reshape(-1)
                shifted = flat[1:1 + h * w].view(h, w)
                check(_bit_equal(torch, ck.quantize_pack(shifted, lo, hi, bits=bits).cpu(),
                                 ck.quantize_pack_plain(shifted.cpu(), lo, hi, bits=bits)),
                      f"K6 on an unaligned plane at {h}x{w}, {bits} bits differs")
                for plane in (x[0], shifted):
                    kw, kr = ck._quantize_pack_recon(plane, lo, hi, bits=bits)
                    pw, pr = ck._quantize_pack_recon(plane.cpu(), lo, hi, bits=bits)
                    k6 = ck.quantize_pack(plane, lo, hi, bits=bits)
                    check(_bit_equal(torch, kw, k6)
                          and _bit_equal(torch, kr, ck.unpack_dequantize(k6, lo, hi, bits=bits))
                          and _bit_equal(torch, kw.cpu(), pw) and _bit_equal(torch, kr.cpu(), pr),
                          f"the keyframe launch at {h}x{w}, ({lo}, {hi}), {bits} bits: differs "
                          f"from K6 then K7 or the CPU")
                    errs["k6_recon"] = max(errs["k6_recon"], _value_err(torch, kr.cpu(), pr))
        f, r = _codec_planes(torch, frames, h, w, device, seed=h)
        deltas, _ = ck.delta_encode_batched(f, r)
        deltas[:, :8, -128:] = 0  # an all-zero tile: width 0
        deltas[:, 8, -1] = -1  # a tile whose max word has the sign bit set: width 32
        widths = ck.significant_bit_widths_batched(deltas)
        want = ck.significant_bit_widths_plain(deltas.cpu())
        check(_bit_equal(torch, widths.cpu(), want),
              f"K5b at {h}x{w} differs from its plain version")
        check(bool((widths[:, 0, -1] == 0).all()) and bool((widths[:, 1, -1] == 32).all()),
              f"K5b at {h}x{w}: the zero tile or the sign-bit tile has the wrong width")
        errs["k5b"] = max(errs["k5b"], _value_err(torch, widths.cpu(), want))
        for i in range(CLIENTS):
            solo = ck.significant_bit_widths(deltas[i])
            check(_bit_equal(torch, solo, widths[i]), f"K5b row {i} at {h}x{w} differs from K5")
            errs["k5"] = max(errs["k5"], _value_err(torch, solo.cpu(), want[i]))
        # K5's other launches: 32x64 and 9x130 tiles, and a plane a word off
        # 16-byte alignment
        buf = torch.empty(deltas.numel() + 1, dtype=deltas.dtype, device=device)
        buf[1:] = deltas.reshape(-1)
        shifted = buf[1:].view(deltas.shape)
        for d, bh, bw in ((deltas, 32, 64), (deltas, 9, 130), (shifted, 8, 128)):
            got = ck.significant_bit_widths_batched(d, block_h=bh, block_w=bw)
            plain = ck.significant_bit_widths_plain(d.cpu(), block_h=bh, block_w=bw)
            check(_bit_equal(torch, got.cpu(), plain)
                  and all(_bit_equal(torch, ck.significant_bit_widths(
                      d[i], block_h=bh, block_w=bw), got[i]) for i in range(CLIENTS)),
                  f"K5b/K5 at {tuple(d.shape)} on {bh}x{bw} tiles differs from its plain "
                  f"version or from K5")
            errs["k5b"] = max(errs["k5b"], _value_err(torch, got.cpu(), plain))
        log(f"[quant] {h}x{w}: K6b (B={CLIENTS}, rows = K6), the keyframe launch (= K6 then "
            f"K7), K7 at bits {cref.PACKABLE_BITS} and (lo, hi) in (0, 1), (0.1, 10), and K5b "
            f"(rows = K5; 8x128, 32x64 and 9x130 tiles) bit-identical "
            f"to their plain versions on the CPU; ties, NaN/+-inf/-0.0, a width-32 and a "
            f"width-0 tile, and planes off 16-byte alignment included")
    log(f"[quant] the plain quantizer on the card divides by a CUDA tensor: it equals the "
        f"CPU's on every plane. PyTorch's division by a Python float moved {moved} of "
        f"{ties} exact half-step ties on this card")
    return errs


# (h, w, block_h, block_w, bits): the one-launch encode and decode at
# 128x128 on 8x128 tiles (at 1 bit 8 lanes build one word), at 240x320 on
# whole 8x64 tiles (8x128 tiles do not divide it), and on 9x130 tiles,
# where at 8 and 4 bits a word straddles two tiles
FUSED_SHAPES = ([(128, 128, 8, 128, b) for b in (16, 8, 4, 2, 1)]
                + [(240, 320, 8, 64, b) for b in (16, 8, 4, 2)]
                + [(18, 260, 9, 130, 16), (18, 260, 9, 130, 8), (18, 520, 9, 130, 4)])


def phase_fused_shapes(torch, ck, cref, wire, device, lo, hi):
    """The one-launch encode and decode against the composition of
    standalone kernels they replace and the CPU's plain composition, bit
    for bit, at FUSED_SHAPES: a frame moved on both sides of column 130
    and in its last pixel, with ties, NaN and +-inf; the decode also with
    a NaN mask value, a mask one tile larger than the grid, and at
    240x320 on ragged 8x128 tiles, where the encode must raise."""
    errs = {"quant_encode": 0.0, "quant_decode": 0.0}
    for h, w, bh, bw, bits in FUSED_SHAPES:
        tile = dict(bits=bits, block_h=bh, block_w=bw)
        ref = _quant_planes(torch, h, w, lo, hi, bits, device, seed=bits + w, b=1)[0]
        frame = ref.clone()
        frame[:4, 130:134] += (hi - lo) / 2
        frame[bh:bh + 4, 126:130] += (hi - lo) / 2
        frame[-1, -1] += (hi - lo) / 2
        words, mask = wire.encode_frame(frame, ref, lo, hi, **tile)
        old_words, old_mask = old_encode_frame(ck, cref, frame, ref, lo, hi, bits, bh, bw)
        host_words, host_mask = wire.encode_frame(frame.cpu(), ref.cpu(), lo, hi, **tile)
        check(0 < float(mask.sum()) < mask.numel(), f"{h}x{w}: no mixed mask to test")
        check(_bit_equal(torch, words, old_words) and _bit_equal(torch, mask, old_mask)
              and _bit_equal(torch, words.cpu(), host_words)
              and _bit_equal(torch, mask.cpu(), host_mask),
              f"the one-launch encode at {h}x{w} on {bh}x{bw} tiles, {bits} bits: differs "
              f"from the composition or the CPU")
        errs["quant_encode"] = max(errs["quant_encode"], _value_err(torch, words.cpu(),
                                                                    host_words))
        odd = mask.clone()
        odd[0, 0] = float("nan")
        big = torch.nn.functional.pad(mask, (0, 1, 0, 1), value=1.0)
        for m in (mask, odd, big):
            out = wire.decode_frame(words, m, ref, lo, hi, **tile)
            host = wire.decode_frame(host_words, m.cpu(), ref.cpu(), lo, hi, **tile)
            check(_bit_equal(torch, out, old_decode_frame(ck, cref, words, m, ref, lo, hi,
                                                          bits, bh, bw))
                  and _bit_equal(torch, out.cpu(), host),
                  f"the one-launch decode at {h}x{w} on {bh}x{bw} tiles, {bits} bits: "
                  f"differs from K7 and the select or the CPU")
            errs["quant_decode"] = max(errs["quant_decode"], _value_err(torch, out.cpu(), host))
        if (h, w) == (240, 320):
            before = dict(ck.launches)
            try:
                wire.encode_frame(frame, ref, lo, hi, bits=bits)
                refused = False
            except ValueError:
                refused = ck.launches == before
            check(refused, "encode_frame on 8x128 tiles that do not divide 240x320 did not "
                           "raise before any launch")
            _, ragged = old_encode_frame(ck, cref, frame, ref, lo, hi, bits)
            out = wire.decode_frame(words, ragged, ref, lo, hi, bits=bits)
            check(_bit_equal(torch, out, old_decode_frame(ck, cref, words, ragged, ref, lo,
                                                          hi, bits))
                  and _bit_equal(torch, out.cpu(), wire.decode_frame(
                      words.cpu(), ragged.cpu(), ref.cpu(), lo, hi, bits=bits)),
                  f"the one-launch decode at 240x320 on ragged 8x128 tiles, {bits} bits: "
                  f"differs from K7 and the select or the CPU")
    log(f"[quant] the one-launch encode and decode at {len(FUSED_SHAPES)} (shape, tile, bits) "
        f"cases (8x128, 8x64 and straddling 9x130 tiles; bits 16, 8, 4, 2, and 1 on 8x128 "
        f"tiles; ties, NaN, +-inf; "
        f"NaN and oversized masks; ragged 8x128 tiles for the decode, where the encode raises) "
        f"equal the composition of standalone kernels and the CPU, bit for bit")
    return errs


def phase_calibration(torch, ck, wire, rate, rgbd):
    """The rate controller's motion -> density fit on the card (K3b at the
    calibration's 8x32 tile) against the port's CPU run."""
    before = dict(ck.launches)
    gain, floor = rate.calibrate_density_map(device="cuda")
    torch.cuda.synchronize()
    launched = ck.launches["delta_encode_batched"] - before["delta_encode_batched"]
    mask_only = ck.launches["delta_encode_mask_only"] - before["delta_encode_mask_only"]
    check(launched == 1 and mask_only == 1,
          f"calibrate_density_map launched K3b {launched} times ({mask_only} mask-only), "
          f"expected 1 mask-only launch")
    cpu_gain, cpu_floor = rate.calibrate_density_map(device="cpu")
    cfg = rgbd.SequenceConfig(num_frames=60, noise_std=0.0)  # the calibration's default
    kw = dict(threshold=0.0, block_h=8, block_w=32)
    card = wire.change_density(rgbd.render_sequence(cfg, device="cuda")[0], **kw).cpu()
    host = wire.change_density(rgbd.render_sequence(cfg, device="cpu")[0], **kw)
    check(_bit_equal(torch, card, host),
          "change_density at the calibration's tile differs between the card and the CPU")
    rel = max(abs(gain - cpu_gain) / abs(cpu_gain), abs(floor - cpu_floor) / abs(cpu_floor))
    check(rel <= 1e-9, f"calibration on the card ({gain!r}, {floor!r}) against the CPU "
                       f"({cpu_gain!r}, {cpu_floor!r}): relative gap {rel:.3g} > 1e-9")
    log(f"[calibrate] density ~= gain * motion + floor on the card (K3b at 8x32, "
        f"{cfg.num_frames} frames, noise 0): gain {gain!r}, floor {floor!r}; CPU: "
        f"{cpu_gain!r}, {cpu_floor!r} (relative gap {rel:.3g}); {card.numel()} densities "
        f"equal, mean {float(card.mean()):.4f}")
    return (gain, floor), (cpu_gain, cpu_floor)


def _bound(ops, nbytes):
    """The least time (ms) and what sets it: operations or bytes."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_batched_step(torch, hm, tracker_mod, ops_mod, rs, pu, ck, wire, decoded, truth,
                       device, q_lo, q_hi):
    """B = 4 clients' frames quantized by K6b and their residual planes
    and widths from one launch of K3b; their populations scored by K1b,
    updated by K2b and scored again: the edge server's step.  Returns its
    launch counts, its inputs (for timing) and its errors against the
    plain versions."""
    cfg = configs()[1]
    frame_idx = [1 + 7 * b for b in range(CLIENTS)]
    h_prev = truth[[i - 1 for i in frame_idx]]
    depth = decoded[frame_idx]
    masks = torch.stack([tracker_mod.stage_preprocess(cfg, h_prev[b], depth[b])[1]
                         for b in range(CLIENTS)]).reshape(CLIENTS, -1).to(torch.float32)
    depth = depth.reshape(CLIENTS, -1)
    rays = cfg.camera.rays_flat(device).expand(CLIENTS, -1, -1).contiguous()
    n = cfg.pso.num_particles
    hs = torch.stack([_particles(torch, hm, h_prev[b], n, device, seed=20 + b)
                      for b in range(CLIENTS)])
    pbest = torch.stack([_particles(torch, hm, h_prev[b], n, device, seed=30 + b)
                         for b in range(CLIENTS)])
    lo = torch.stack([hm.parameter_lower_bounds(h_prev[b], cfg.pos_range, cfg.quat_range)
                      for b in range(CLIENTS)])
    hi = torch.stack([hm.parameter_upper_bounds(h_prev[b], cfg.pos_range, cfg.quat_range)
                      for b in range(CLIENTS)])
    gen = torch.Generator(device=device).manual_seed(5)
    v = (torch.rand(hs.shape, generator=gen, device=device) - 0.5) * 0.2 * (hi - lo)[:, None]
    r1 = torch.rand(hs.shape, generator=gen, device=device)
    r2 = torch.rand(hs.shape, generator=gen, device=device)
    torch.cuda.synchronize()

    prev = decoded[[i - 1 for i in frame_idx]]
    torch.cuda.synchronize()

    rs.launches = rs.launches_batched = pu.launches = pu.launches_batched = 0
    pu.launches_projected = 0
    for key in ck.launches:
        ck.launches[key] = 0
    words = ck.quantize_pack_batched(decoded[frame_idx], q_lo, q_hi, bits=8)
    residuals, res_mask, widths = wire.entropy_residuals(decoded[frame_idx], prev)
    spheres = hm.pack_spheres(hs)
    scores = ops_mod.render_score_batched(spheres, rays, depth, masks)
    gbest = hs[torch.arange(CLIENTS, device=device), torch.argmin(scores, dim=1)]
    x_new, v_new = pu.pso_update_projected_batched(hs, v, pbest, gbest, r1, r2, lo, hi,
                                                   **UPDATE_CONSTS)
    scores_new = ops_mod.render_score_batched(hm.pack_spheres(x_new), rays, depth, masks)
    torch.cuda.synchronize()
    c = ck.launches
    launches = {"k1b": rs.launches_batched, "k2b": pu.launches_batched,
                "k6b": c["quantize_pack_batched"], "k3b_widths": c["delta_encode_widths"],
                "k5b": c["significant_bit_widths_batched"]}
    solo = (rs.launches + pu.launches + c["quantize_pack"] + c["significant_bit_widths"]
            + c["delta_encode"])
    check(launches == {"k1b": 2, "k2b": 1, "k6b": 1, "k3b_widths": 1, "k5b": 0}
          and c["delta_encode_batched"] == 1 and solo == 0 and pu.launches_projected == 1,
          f"batched step launched {launches}, K3b {c['delta_encode_batched']} and {solo} "
          f"unbatched kernels: expected K1b 2, K2b 1 (with the projection), K6b 1, K3b with "
          f"the widths 1, K5b 0 and no unbatched kernel")
    launches["k3b"] = c["delta_encode_batched"]
    k3b_delta, k3b_mask = ck.delta_encode_batched(decoded[frame_idx], prev)
    host = wire.entropy_residuals(decoded[frame_idx].cpu(), prev.cpu())
    check(_bit_equal(torch, residuals, k3b_delta) and _bit_equal(torch, res_mask, k3b_mask)
          and _bit_equal(torch, widths, ck.significant_bit_widths_batched(k3b_delta))
          and all(_bit_equal(torch, a.cpu(), b) for a, b in zip((residuals, res_mask, widths),
                                                                 host)),
          "batched step: K3b with the widths differs from K3b then K5b or from the CPU")
    k3b_widths_err = _value_err(torch, widths.cpu(), host[2])
    for b in range(CLIENTS):
        check(_bit_equal(torch, words[b], ck.quantize_pack(decoded[frame_idx[b]], q_lo, q_hi, bits=8)),
              f"K6b row {b} differs from K6 on that client's frame")
        solo_widths = wire.entropy_residuals(decoded[frame_idx[b]], prev[b])
        check(all(_bit_equal(torch, a, full[b]) for a, full in zip(
                  solo_widths, (residuals, res_mask, widths))),
              f"K3b with the widths: row {b} differs from K3 with the widths on that client")
    check(words.shape == (CLIENTS, *decoded.shape[1:-1], decoded.shape[-1] // 4)
          and widths.shape == (CLIENTS, -(-decoded.shape[1] // 8), -(-decoded.shape[2] // 128)),
          "batched step: K6b's words or the residuals' widths are malformed")
    log(f"[batched] K6b quantized the {CLIENTS} clients' frames at 8 bits over ({q_lo}, {q_hi}) m "
        f"in one launch, K3b wrote their residual planes and widths in one (max width per "
        f"client {widths.amax(dim=(1, 2)).tolist()}; equal to K3b then K5b and the CPU); each "
        f"row equal to K6 / K3 with the widths on that client")
    for name, t in (("scores", scores), ("scores after the update", scores_new)):
        check(t.shape == (CLIENTS, n) and bool(torch.isfinite(t).all()),
              f"batched step: {name} malformed")
    log(f"[batched] {CLIENTS} clients (frames {frame_idx} as decoded at 0.01 m) x {n} "
        f"particles x {spheres.shape[2]} spheres at P={rays.shape[1]}: lowest E_D per "
        f"client at the spawn {[round(x, 5) for x in torch.amin(scores, 1).tolist()]}, "
        f"after one update {[round(x, 5) for x in torch.amin(scores_new, 1).tolist()]}; launches "
        f"K1b {launches['k1b']}, K2b {launches['k2b']}")

    denom = torch.clamp(masks.sum(1, keepdim=True), min=1.0)
    plain = rs.render_score_sums_batched_plain(spheres, rays, depth, masks)
    k1b_err = 0.0
    for b in range(CLIENTS):
        solo = ops_mod.render_score(spheres[b], rays[b], depth[b], masks[b])
        check(_bit_equal(torch, scores[b], solo), f"K1b row {b} differs from K1 on that client")
        err, ok = _normalized_err(torch, scores[b] * denom[b], plain[b], masks[b])
        check(ok, f"K1b row {b} disagrees with its plain version: max|err| {err:.3g}")
        k1b_err = max(k1b_err, err)
    px, pv = pu.pso_update_projected_batched_plain(hs, v, pbest, gbest, r1, r2, lo, hi,
                                                   **UPDATE_CONSTS)
    for got, want in ((x_new, px), (v_new, pv)):
        check(bool(torch.allclose(got, want, rtol=K2_TOL, atol=K2_TOL)),
              "the fused K2b disagrees with its plain version")
    k2b_err = max(float((x_new - px).abs().max()), float((v_new - pv).abs().max()))
    for b in range(CLIENTS):
        sx, sv = pu.pso_update_projected(hs[b], v[b], pbest[b], gbest[b], r1[b], r2[b], lo[b],
                                         hi[b], **UPDATE_CONSTS)
        check(_bit_equal(torch, x_new[b], sx) and _bit_equal(torch, v_new[b], sv),
              f"the fused K2b's swarm {b} differs from the fused K2 on that swarm")
    nan_depth = depth.clone()
    nan_depth[2] = _with_nan(depth[2], masks[2], "masked")
    nan_sums = rs.render_score_sums_batched(spheres, rays, nan_depth, masks)
    nan_plain = rs.render_score_sums_batched_plain(spheres, rays, nan_depth, masks)
    for b in range(CLIENTS):
        want_nan = b == 2
        check(bool(torch.isnan(nan_sums[b]).all()) == want_nan
              and bool(torch.isnan(nan_sums[b]).any()) == want_nan
              and bool(torch.isnan(nan_plain[b]).all()) == want_nan,
              f"K1b with a NaN in client 2's frame: row {b} has "
              f"{int(torch.isnan(nan_sums[b]).sum())} NaN sums (plain "
              f"{int(torch.isnan(nan_plain[b]).sum())}), expected {n if want_nan else 0}")
        check(_bit_equal(torch, nan_sums[b],
                         rs.render_score_sums(spheres[b], rays[b], nan_depth[b], masks[b])),
              f"K1b with a NaN in client 2's frame: row {b} differs from K1 on that client")
    log(f"[batched] K1b with a NaN depth in client 2's frame: row 2 all NaN as the plain "
        f"version, rows 0, 1, 3 finite; every row bit-identical to K1 on that client")
    log(f"[batched] K1b rows bit-identical to K1; max|err| of E_D against plain {k1b_err:.3g} "
        f"(tol rtol {K1_TOL_RTOL} + CLAMP_T/|B| + 1e-6). K2b with the quaternion projection "
        f"at {tuple(hs.shape)} bit-identical to the fused K2 per swarm; max|err| against "
        f"plain {k2b_err:.3g} (tol {K2_TOL})")
    inputs = {"score": (spheres, rays, depth, masks),
              "update": (hs, v, pbest, gbest, r1, r2, lo, hi),
              "frames": decoded[frame_idx], "prev": prev, "residuals": residuals}
    return launches, inputs, {"k1b": k1b_err, "k2b": k2b_err, "k3b_widths": k3b_widths_err}


def phase_slice2_timing(torch, rs, pu, ck, frames, step_inputs, device):
    """K1b, K2b, K3, K3b and K4 at their paths' shapes: CUDA events,
    profiler device time, plain version, bound, library call."""
    out = {}
    spheres, rays, depth, masks = step_inputs["score"]
    fused = lambda: rs.render_score_sums_batched(spheres, rays, depth, masks)
    solo = lambda: rs.render_score_sums(spheres[0], rays[0], depth[0], masks[0])
    solos = lambda: [rs.render_score_sums(spheres[b], rays[b], depth[b], masks[b])
                     for b in range(CLIENTS)]
    ms, solo_ms = _time_ms(torch, fused, 200), _time_ms(torch, solo, 200)
    solos_ms = _time_ms(torch, solos, 100)
    dev = _device_ms(torch, fused, 20, ["render_score_kernel"])
    dev_solo = _device_ms(torch, solo, 20, ["render_score_kernel"])
    # K1's work per client, summed: over the kept pixels, and over all P
    n, s, p = spheres.shape[1], spheres.shape[2], rays.shape[1]
    work = [_k1_work(torch, spheres[b], rays[b], depth[b], masks[b]) for b in range(CLIENTS)]
    ops, nbytes = (sum(w[0][i] for w in work) for i in (0, 1))
    full_ops, full_bytes = (sum(w[1][i] for w in work) for i in (0, 1))
    kept = [w[2] for w in work]
    bound, by = _bound(ops, nbytes)
    full_bound, _ = _bound(full_ops, full_bytes)
    plain_ms = _time_ms(torch, lambda: rs.render_score_sums_batched_plain(
        spheres, rays, depth, masks), 10)
    out["k1b"] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                      library_ms=None)
    per_client_dev = (None if dev is None or dev_solo is None
                      else f"{dev / (CLIENTS * dev_solo):.3f}")
    log(f"[time] K1b at B={CLIENTS} N={n} S={s} P={p}: fused {_us(ms)} (device {_us(dev)}), "
        f"one solo K1 {_us(solo_ms)} (device {_us(dev_solo)}), {CLIENTS} solo K1 calls "
        f"{_us(solos_ms)}; per_client_vs_solo {ms / (CLIENTS * solo_ms):.3f} (events), "
        f"{per_client_dev} (device); plain {_us(plain_ms)}; kept pixels per client {kept}; "
        f"bound {bound * 1e3:.4f} us over the kept pixels ({by}: {ops:.4g} fp32 ops, "
        f"{nbytes} B); the full-P bound (every pixel tested): {full_bound * 1e3:.4f} us "
        f"({full_ops:.4g} ops)")

    args = step_inputs["update"]
    b, n, d = args[0].shape
    fused = lambda: pu.pso_update_projected_batched(*args, **UPDATE_CONSTS)
    solo = lambda: pu.pso_update_projected(*(a[0] for a in args), **UPDATE_CONSTS)
    unprojected = lambda: pu.pso_update_batched(*args, **UPDATE_CONSTS)
    ms, solo_ms = _time_ms(torch, fused, 500), _time_ms(torch, solo, 500)
    unprojected_ms = _time_ms(torch, unprojected, 500)
    dev = _device_ms(torch, fused, 50, ["pso_update_kernel"])
    dev_solo = _device_ms(torch, solo, 50, ["pso_update_kernel"])
    dev_unprojected = _device_ms(torch, unprojected, 50, ["pso_update_kernel"])
    # five (B, N, D) planes read and two written; gbest, lo and hi (B, D);
    # 17 fp32 ops an element and 13 a particle for the projection
    nbytes = 4 * (7 * b * n * d + 3 * b * d)
    bound, by = _bound(17 * b * n * d + 13 * b * n, nbytes)
    plain_ms = _time_ms(torch, lambda: pu.pso_update_projected_batched_plain(*args, **UPDATE_CONSTS), 200)
    out["k2b"] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                      library_ms=None)
    per_client_dev = (None if dev is None or dev_solo is None
                      else f"{dev / (b * dev_solo):.3f}")
    log(f"[time] K2b at ({b}, {n}, {d}), update + quaternion projection (the batched step's "
        f"launch): fused {_us(ms)} (device {_us(dev)}), one solo K2 {_us(solo_ms)} (device "
        f"{_us(dev_solo)}); per_client_vs_solo {ms / (b * solo_ms):.3f} (events), "
        f"{per_client_dev} (device); update alone {_us(unprojected_ms)} (device "
        f"{_us(dev_unprojected)}); plain {_us(plain_ms)}; bound {bound * 1e3:.4f} us "
        f"({nbytes} B)")

    def codec_bytes(planes, h, w, write_delta=True):
        # two float planes read; the delta (unless mask-only) and mask written
        return 4 * planes * ((3 if write_delta else 2) * h * w + -(-h // 8) * -(-w // 128))

    def time_encode(key, label, ff, rr, planes, reps):
        """One shape's full and mask-only launch: events, device time, bound."""
        batched = ff.dim() == 3
        full = ((lambda: ck.delta_encode_batched(ff, rr, threshold=0.01)) if batched
                else (lambda: ck.delta_encode(ff, rr, threshold=0.01)))
        mask_only = lambda: ck._delta_mask(ff, rr, threshold=0.01)
        plain = lambda: ck.delta_encode_plain(ff if batched else ff[None],
                                              rr if batched else rr[None], threshold=0.01)
        h, w = ff.shape[-2:]
        plain_ms = _time_ms(torch, plain, 20)
        for variant, fn, write in (("full", full, True), ("mask-only", mask_only, False)):
            ms = _time_ms(torch, fn, reps)
            dev = _device_ms(torch, fn, 50, ["delta_encode_kernel"])
            nbytes = codec_bytes(planes, h, w, write)
            bound, by = _bound(0, nbytes)
            log(f"[time] {label}, {variant}: {_us(ms)} (device {_us(dev)}), plain "
                f"{_us(plain_ms)}, bound {bound * 1e3:.4f} us ({nbytes} B)")
            if key and write:
                out[key] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound,
                                bound_by=by, library_ms=None)
            elif key:
                out[key]["mask_only"] = dict(ms=ms, device_ms=dev, bound_ms=bound)

    t_count, h, w = frames.shape
    f, r = frames[1], frames[0]
    wide_f, wide_r = _codec_planes(torch, frames, 240, 320, device, seed=1)
    time_encode("k3", "K3 at 128x128", f, r, 1, 500)
    time_encode(None, "K3 at 240x320", wide_f[0], wide_r[0], 1, 500)
    time_encode("k3b", f"K3b at ({t_count - 1}, {h}, {w}) (change_density's call)",
                frames[1:], frames[:-1], t_count - 1, 500)

    delta, _ = ck.delta_encode(f, r)
    dec = lambda: ck.delta_decode(delta, r)
    ms = _time_ms(torch, dec, 500)
    dev = _device_ms(torch, dec, 50, ["delta_decode_kernel"])
    xor = lambda: torch.bitwise_xor(r.view(torch.int32), delta).view(torch.float32)
    library = _time_ms(torch, xor, 500)
    library_dev = _device_ms(torch, xor, 50, ["Xor"])
    plain_ms = _time_ms(torch, lambda: ck.delta_decode_plain(delta, r), 500)
    nbytes = 4 * 3 * h * w
    bound, by = _bound(0, nbytes)
    out["k4"] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     library_ms=library)
    log(f"[time] K4 at {h}x{w}: {_us(ms)} (device {_us(dev)}), plain {_us(plain_ms)}, "
        f"library (torch.bitwise_xor) {_us(library)} (device {_us(library_dev)}), "
        f"bound {bound * 1e3:.4f} us ({nbytes} B)")
    return out


def phase_slice3_timing(torch, ck, frames, step_inputs, device, lo, hi):
    """K5, K5b, K6, K6b and K7 at their paths' shapes (128x128, bits 8;
    B = 4 for the batched kernels), and K6/K7 also at 240x320: CUDA
    events, profiler device time, plain version, bound."""
    bits = 8
    out = {}

    def row(key, label, fn, plain, names, ops, nbytes, reps=500):
        ms = _time_ms(torch, fn, reps)
        dev = _device_ms(torch, fn, 50, names)
        plain_ms = _time_ms(torch, plain, 50)
        bound, by = _bound(ops, nbytes)
        log(f"[time] {label}: {_us(ms)} (device {_us(dev)}), plain {_us(plain_ms)}, bound "
            f"{bound * 1e3:.4f} us ({nbytes} B, {ops} ops; {by}); no single PyTorch call "
            f"packs codes or scans bit widths")
        if key:
            out[key] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, library_ms=None)

    # ops per pixel: K6 clip (2), subtract, divide, round, clip (2), convert,
    # shift, or = 10; K7 shift, and, convert, multiply, add = 5; K5 one
    # unsigned max per word.
    wide, _ = _codec_planes(torch, frames, 240, 320, device, seed=1)
    for key, label, x in (("k6", "K6 at 128x128", frames[1]), (None, "K6 at 240x320", wide[0])):
        h, w = x.shape
        row(key, label + f", {bits} bits", lambda: ck.quantize_pack(x, lo, hi, bits=bits),
            lambda: ck.quantize_pack_plain(x, lo, hi, bits=bits), ["quantize_pack_kernel"],
            10 * h * w, 4 * h * w + h * w * bits // 8)
        words = ck.quantize_pack(x, lo, hi, bits=bits)
        row("k7" if key else None, label.replace("K6", "K7") + f", {bits} bits",
            lambda: ck.unpack_dequantize(words, lo, hi, bits=bits),
            lambda: ck.unpack_dequantize_plain(words, lo, hi, bits=bits),
            ["unpack_dequantize_kernel"], 5 * h * w, 4 * h * w + h * w * bits // 8)
    xs = step_inputs["frames"]
    b, h, w = xs.shape
    row("k6b", f"K6b at ({b}, {h}, {w}), {bits} bits",
        lambda: ck.quantize_pack_batched(xs, lo, hi, bits=bits),
        lambda: ck.quantize_pack_plain(xs, lo, hi, bits=bits), ["quantize_pack_kernel"],
        10 * b * h * w, 4 * b * h * w + b * h * w * bits // 8)
    tiles = -(-h // 8) * -(-w // 128)
    delta, _ = ck.delta_encode(frames[1], frames[0])
    row("k5", f"K5 at {h}x{w}", lambda: ck.significant_bit_widths(delta),
        lambda: ck.significant_bit_widths_plain(delta[None]), ["sig_width_kernel"],
        h * w, 4 * (h * w + tiles))
    residuals = step_inputs["residuals"]
    row("k5b", f"K5b at ({b}, {h}, {w})", lambda: ck.significant_bit_widths_batched(residuals),
        lambda: ck.significant_bit_widths_plain(residuals), ["sig_width_kernel"],
        b * h * w, 4 * b * (h * w + tiles))
    return out


def phase_fused_timing(torch, ck, cref, wire, frames, step_inputs, device, lo, hi):
    """Each one-launch path beside the composition it replaces, in this
    run: CUDA events, profiler device time and device activities per
    call, the plain version, the bound and its bytes; device activities
    per quantized closed-loop delta frame, old path against new; and K4
    against torch.bitwise_xor at 128x128, 240x320 and 480x640."""
    out = {}
    h, w = frames.shape[1:]
    tiles = -(-h // 8) * -(-w // 128)

    def row(key, label, new, old, old_label, plain, nbytes, reps=500):
        ms, old_ms = _time_ms(torch, new, reps), _time_ms(torch, old, reps)
        dev, acts, _ = _device_ms(torch, new, 50)
        old_dev, old_acts, old_names = _device_ms(torch, old, 50)
        plain_ms = _time_ms(torch, plain, 50)
        bound, by = _bound(0, nbytes)
        log(f"[time] {label}: {_us(ms)} (device {_us(dev)}, {acts} activities a call); "
            f"{old_label}: {_us(old_ms)} (device {_us(old_dev)}, {old_acts} activities a "
            f"call: {old_names}); plain {_us(plain_ms)}; bound {bound * 1e3:.4f} us "
            f"({nbytes} B, {by})")
        if key:
            out[key] = dict(ms=ms, device_ms=dev, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, library_ms=None,
                            composition=dict(ms=old_ms, device_ms=old_dev, activities=old_acts))

    f = frames[2]
    for bits in QUANT_BITS:
        # the closed loop's call: the next frame against the receiver's
        # reconstruction of the last
        ref = ck.unpack_dequantize(ck.quantize_pack(frames[1], lo, hi, bits=bits), lo, hi,
                                   bits=bits)
        key = bits == 8
        words, mask = wire.encode_frame(f, ref, lo, hi, bits=bits)
        row("quant_encode" if key else None, f"one-launch encode at {h}x{w}, {bits} bits",
            lambda: wire.encode_frame(f, ref, lo, hi, bits=bits),
            lambda: old_encode_frame(ck, cref, f, ref, lo, hi, bits),
            "K6, K7, K6, K7 and K3 mask-only",
            lambda: ck.quant_encode_plain(f, ref, lo, hi, bits=bits),
            8 * h * w + h * w * bits // 8 + 4 * tiles)
        changed = int(mask.sum())
        # the changed tiles' words and the other tiles' reference are read
        row("quant_decode" if key else None,
            f"one-launch decode at {h}x{w}, {bits} bits ({changed} of {tiles} tiles changed)",
            lambda: wire.decode_frame(words, mask, ref, lo, hi, bits=bits),
            lambda: old_decode_frame(ck, cref, words, mask, ref, lo, hi, bits),
            "K7 and the select's eager ops",
            lambda: ck.quant_decode_plain(words, mask, ref, lo, hi, bits=bits),
            4 * h * w + 4 * tiles + 8 * 128 * (changed * bits // 8 + (tiles - changed) * 4))
        new_frame = lambda: wire.decode_frame(*wire.encode_frame(f, ref, lo, hi, bits=bits),
                                              ref, lo, hi, bits=bits)
        old_frame = lambda: old_decode_frame(
            ck, cref, *old_encode_frame(ck, cref, f, ref, lo, hi, bits), ref, lo, hi, bits)
        _, new_acts, _ = _device_ms(torch, new_frame, 20)
        _, old_acts, _ = _device_ms(torch, old_frame, 20)
        out.setdefault("activities_per_frame", {})[bits] = dict(old=old_acts, new=new_acts)
        log(f"[profile] device activities per quantized closed-loop delta frame (encode_frame "
            f"+ decode_frame) at {bits} bits: old path {old_acts}, new path {new_acts}")

    r = frames[1]
    row("k3_recon", f"K3 with the reconstruction at {h}x{w}",
        lambda: ck._delta_encode_recon(f, r, threshold=0.01),
        lambda: ck.delta_decode(ck.delta_encode(f, r, threshold=0.01)[0], r), "K3 then K4",
        lambda: ck.delta_decode_plain(ck.delta_encode_plain(f[None], r[None],
                                                            threshold=0.01)[0][0], r),
        16 * h * w + 4 * tiles)
    delta, _ = ck.delta_encode(f, r, threshold=0.01)
    row("k4_pair", f"two-output K4 at {h}x{w}", lambda: ck._delta_decode_pair(delta, r),
        lambda: ck.delta_decode(delta, r).clone(), "K4 then a device copy",
        lambda: (lambda o: (o, o.clone()))(ck.delta_decode_plain(delta, r)), 16 * h * w)

    # the entropy stage's call (threshold 0) and the batched step's; bytes:
    # two float planes read, the delta, mask and widths written
    def widths_plain(ff, rr):
        d, _ = ck.delta_encode_plain(ff, rr)
        return ck.significant_bit_widths_plain(d)

    row("k3_widths", f"K3 with the widths at {h}x{w}, threshold 0",
        lambda: ck._delta_encode_widths(f, r),
        lambda: ck.significant_bit_widths(ck.delta_encode(f, r)[0]), "K3 then K5",
        lambda: widths_plain(f[None], r[None]), 12 * h * w + 8 * tiles)
    xs, prev = step_inputs["frames"], step_inputs["prev"]
    b = xs.shape[0]
    k3b = lambda: ck.delta_encode_batched(xs, prev)
    row("k3b_widths", f"K3b with the widths at ({b}, {h}, {w}), threshold 0",
        lambda: ck._delta_encode_widths(xs, prev),
        lambda: ck.significant_bit_widths_batched(k3b()[0]), "K3b then K5b",
        lambda: widths_plain(xs, prev), b * (12 * h * w + 8 * tiles))
    alone = dict(ms=_time_ms(torch, k3b, 500),
                 device_ms=_device_ms(torch, k3b, 50, ["delta_encode_kernel"]))
    out["k3b_widths"]["k3b_alone"] = alone
    log(f"[time] K3b alone at ({b}, {h}, {w}), threshold 0: {_us(alone['ms'])} (device "
        f"{_us(alone['device_ms'])})")
    for bits in QUANT_BITS:
        row("k6_recon" if bits == 8 else None, f"keyframe launch at {h}x{w}, {bits} bits",
            lambda: ck._quantize_pack_recon(f, lo, hi, bits=bits),
            lambda: ck.unpack_dequantize(ck.quantize_pack(f, lo, hi, bits=bits), lo, hi,
                                         bits=bits), "K6 then K7",
            lambda: ck._quantize_pack_recon(f.cpu(), lo, hi, bits=bits),
            8 * h * w + h * w * bits // 8)

    sizes = []
    gen = torch.Generator(device=device).manual_seed(17)
    for ph, pw in ((128, 128), (240, 320), (480, 640)):
        ref = torch.rand((ph, pw), generator=gen, device=device) + 0.5
        moved = ref + 0.01 * torch.rand((ph, pw), generator=gen, device=device)
        bits_delta, _ = ck.delta_encode(moved, ref)
        dec = lambda: ck.delta_decode(bits_delta, ref)
        xor = lambda: torch.bitwise_xor(ref.view(torch.int32), bits_delta).view(torch.float32)
        ms, xor_ms = _time_ms(torch, dec, 500), _time_ms(torch, xor, 500)
        dev, _, _ = _device_ms(torch, dec, 50)
        xor_dev, _, _ = _device_ms(torch, xor, 50)
        nbytes = 12 * ph * pw
        bound, _ = _bound(0, nbytes)
        sizes.append(dict(shape=[ph, pw], ms=ms, device_ms=dev, library_ms=xor_ms,
                          library_device_ms=xor_dev, bound_ms=bound))
        log(f"[time] K4 at {ph}x{pw}: {_us(ms)} (device {_us(dev)}); torch.bitwise_xor on "
            f"the bit views {_us(xor_ms)} (device {_us(xor_dev)}); bound {bound * 1e3:.4f} "
            f"us ({nbytes} B); device / bound "
            f"{'not measured' if dev is None else f'{dev / bound:.2f}'}")
    out["k4_sizes"] = sizes
    return out


# ---------------------------------------------------------------------------
# The paper's offload path: the container tax measured on the card, and the
# 12 deployments of examples/edge_offload_serve executed at full width.

# The example's clip length.  If the script ever outgrows its time limit,
# cut this first (and say so in the log).
GRID_FRAMES = 36


def phase_offload(torch, rs, pu, device, card):
    """``measure_wrapper`` on the card beside ``paper_wrapper``; then the
    12 deployments through ``runtime.executed_run`` at
    ``hardware.PAPER_TRACKER_CFG`` on a ``Camera()`` clip with the
    example's fast burst, the clock charged with ``paper_staged()``.
    Each deployment processes the frames ``analytic_run`` replays for the
    same plan and seed, and its step, the frame captured into a CUDA
    graph, runs K1 31 and K2 30 times on the card a processed frame and
    once more in its warm-up (the profiler's kernel records); the local
    server runs track to < 3 cm; the paper's orderings hold.  Returns the
    grid's K1 and K2 runs on the card and each deployment's processed
    frame indices."""
    from repro_torch.core import wrapper
    from repro_torch.data import rgbd
    from repro_torch.examples import edge_offload_serve as serve
    from repro_torch.kernels import _build
    from repro_torch.sim import hardware, runtime

    fit, paper = wrapper.measure_wrapper(device=device), wrapper.paper_wrapper()
    log(f"[offload] container tax measured on {card} (pinned host <-> card round trips, "
        f"1 KiB and 4 MiB, min of 5): call_overhead {fit.call_overhead * 1e6:.2f} us, "
        f"staging bandwidth {fit.serialization_bandwidth / 1e9:.3f} GB/s; paper_wrapper() "
        f"(the paper's JNI/JVM container, modelled): call_overhead "
        f"{paper.call_overhead * 1e6:.2f} us, serialization {paper.serialization_bandwidth / 1e6:.1f}"
        f" MB/s, JNI {paper.jni_bandwidth / 1e6:.1f} MB/s")
    for value in (fit.call_overhead, fit.serialization_bandwidth):
        check(value == value and 0 < value < float("inf"),
              f"measure_wrapper on the card gave {fit}")

    cfg, comp = hardware.PAPER_TRACKER_CFG, hardware.paper_staged()
    # the tracker's camera, Camera() 128x128
    seq = rgbd.SequenceConfig(num_frames=GRID_FRAMES, camera=cfg.camera, fast_burst=(18, 26))
    frames, truth = rgbd.render_sequence(seq, device=device)
    per_frame = (1 + cfg.pso.num_generations, cfg.pso.num_generations)
    log(f"[offload] the paper's 12 deployments executed on {card}: camera "
        f"{cfg.camera.width}x{cfg.camera.height}, {cfg.pso.num_particles} particles x "
        f"{cfg.pso.num_generations} generations, {GRID_FRAMES} frames (fast burst 18-26); fps "
        f"and drop rate are the cost model's prediction for the paper's modelled tiers, not "
        f"this card's speed; error and wall time are this card's")
    torch.cuda.synchronize()
    rs.launches = 0
    pu.launches = pu.launches_projected = 0
    processed_total, tracked, grid = 0, {}, {"k1": 0, "k2": 0}
    for name, env, policy, gran in serve.deployments():
        wrapped = (rs.launches, pu.launches)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res, runs = _build.kernel_runs(
            lambda: runtime.executed_run(cfg, env, policy, frames, truth, gran, seed=0,
                                         timing_comp=comp, device=device), KERNEL_NAMES)
        end.record()
        end.synchronize()
        k1, k2 = runs[KERNEL_NAMES[0]], runs[KERNEL_NAMES[1]]
        wrapped = (rs.launches - wrapped[0], pu.launches - wrapped[1])
        grid["k1"], grid["k2"] = grid["k1"] + k1, grid["k2"] + k2
        processed = [e.index for e in res.sim.stats.processed]
        replay = runtime.analytic_run(comp, env, policy, gran, GRID_FRAMES, seed=0)
        n = len(processed)
        processed_total += n
        tracked[name] = processed
        log(f"[offload] {name:44s} simulated {res.sim.fps:6.2f} fps, drop rate "
            f"{res.sim.stats.drop_rate:.3f}; processed {n:2d}; mean position error "
            f"{res.mean_pos_error * 100:.3f} cm (lost {res.track_lost_frames}); wall "
            f"{start.elapsed_time(end) / max(n, 1):.3f} ms a processed frame by CUDA events, "
            f"under the profiler; on the card K1 {k1}, K2 {k2}, by the wrappers K1 "
            f"{wrapped[0]}, K2 {wrapped[1]}")
        check(processed == [e.index for e in replay.stats.processed],
              f"{name}: processed frames {processed} differ from analytic_run's replay")
        # one graph a deployment: the warm-up and each processed frame's
        # replay run the frame on the card; the wrappers launch the
        # warm-up's kernels and the capture's
        runs_expected = [(n + 1) * k if n else 0 for k in per_frame]
        check([k1, k2] == runs_expected,
              f"{name}: the card ran K1 {k1} and K2 {k2} times for {n} processed frames, "
              f"expected {runs_expected}: {per_frame[0]} and {per_frame[1]} a frame and the "
              f"warm-up's")
        check(list(wrapped) == [2 * k if n else 0 for k in per_frame],
              f"{name}: the wrappers launched K1 {wrapped[0]} and K2 {wrapped[1]} times")
        check(res.mean_pos_error == res.mean_pos_error, f"{name}: no position error")
        if name.startswith("local/server/"):
            check(res.mean_pos_error < 0.03,
                  f"{name}: mean position error {res.mean_pos_error:.4f} m >= 3 cm")
    check(pu.launches_projected == pu.launches,
          "the grid's K2 launches did not fuse the quaternion projection")
    claims = serve.paper_claims()
    log(f"[offload] the paper's orderings (cost model, 200 frames): "
        f"{sum(claims.values())} of {len(claims)} hold")
    check(all(claims.values()), f"paper orderings that fail: "
          f"{[k for k, ok in claims.items() if not ok]}")
    deployed = sum(1 for processed in tracked.values() if processed)
    log(f"[offload] over the grid: the card ran K1 {grid['k1']} and K2 {grid['k2']} times for "
        f"{processed_total} processed frames and {deployed} warm-ups, of which "
        f"{grid['k1'] - deployed * per_frame[0]} and {grid['k2'] - deployed * per_frame[1]} in "
        f"the replays; the wrappers launched K1 {rs.launches} and K2 {pu.launches} times")
    return {**grid, "processed": tracked}


# ---------------------------------------------------------------------------
# Phase 16: the fleet (``repro_torch.cluster``).  Host code, as in the
# reference: both engines, the card's density calibration in the rate
# controller, the one-client limit against the frames the card tracked.

# BENCH_fleet_events.json's smoke shape: clients, edges (capacity 8), frames
FLEET_EVENTS_SHAPE = (256, 16, 120)
FLEET_EVENTS_REPS = 3  # best of, as the reference's benchmark
# the reference's gate_min_speedup, a CPU record of an earlier machine:
# printed beside this host's ratio, not checked
FLEET_EVENTS_GATE = 2.0


def fleet_golden_configs():
    """The 13 golden configs of the reference's engine-equivalence tests
    (``tests/test_engine_equivalence.py::_golden_configs``), restated on
    the port; ``tests/test_torch_fleet.py`` holds the two equal."""
    from repro_torch.cluster import MigrationConfig
    from repro_torch.cluster.events import AdaptiveWindow
    from repro_torch.cluster.fleet import LinkDrift, ServiceDrift
    from repro_torch.codec import rate as crate
    from repro_torch.core.workloads import workload_suite
    from repro_torch.net import links
    from repro_torch.sim import hardware

    comp = hardware.paper_staged()
    drifts = (
        LinkDrift(time=0.3, link="5g_edge_0", latency=0.05, jitter=0.01),
        ServiceDrift(time=0.6, edge="edge_1", factor=2.5),
        LinkDrift(time=0.9, link="5g_edge_0", latency=0.004, jitter=0.0015),
    )
    # a narrow shared cell: every spoke contends for one transmission slot
    cell_topo = hardware.shared_cell_star(
        num_edges=3, edge_capacity=2, cell_capacity=1,
        base_link=dataclasses.replace(links.FIVE_G_EDGE, bandwidth=15e6))
    topo = hardware.fleet_star(num_edges=3, edge_capacity=2)
    btopo = hardware.fleet_star(num_edges=3, edge_capacity=2, batching=True)
    het_topo, het_classes = hardware.hetero_fleet_star(num_edges=3, edge_capacity=2)
    late_drift = [LinkDrift(time=0.4, link="5g_edge_0", latency=0.06, jitter=0.012)]
    return {
        "plain": dict(topo=topo, comp=comp, num_clients=9, num_frames=40),
        "batching": dict(topo=btopo, comp=comp, num_clients=9, num_frames=40,
                         gather_window=3e-3),
        "adaptive": dict(topo=btopo, comp=comp, num_clients=7, num_frames=40,
                         gather_window=3e-3,
                         adaptive_window=AdaptiveWindow(alpha=0.3, idle_factor=1.5)),
        "migration": dict(topo=hardware.hotspot_star(), comp=comp, num_clients=8,
                          num_frames=45, dispatch="least_queue",
                          migration=MigrationConfig()),
        "codec": dict(topo=topo, comp=comp, num_clients=6, num_frames=40,
                      codec=crate.CodecConfig(base=hardware.codec_point())),
        "drift": dict(topo=topo, comp=comp, num_clients=8, num_frames=60,
                      drifts=list(drifts), drift_window=12, drift_min_samples=5),
        "entropy_codec": dict(topo=topo, comp=comp, num_clients=6, num_frames=40,
                              codec=crate.CodecConfig(
                                  base=hardware.codec_point(entropy=True))),
        "contended": dict(topo=cell_topo, comp=comp, num_clients=8, num_frames=40,
                          dispatch="latency_weighted",
                          codec=crate.CodecConfig(
                              base=hardware.codec_point(entropy=True),
                              bits_ladder=(16, 8, 4, 2),
                              cell_threshold=0.1e-3, cell_stagger=0.05)),
        "keyframe_loss": dict(topo=cell_topo, comp=comp, num_clients=10, num_frames=50,
                              dispatch="latency_weighted",
                              codec=crate.CodecConfig(
                                  base=hardware.codec_point(entropy=True),
                                  cell_threshold=0.1e-3, resync_bound=4,
                                  drop_threshold=0.2)),
        "hetero": dict(topo=het_topo, comp=comp, num_clients=9, num_frames=40,
                       client_classes=het_classes),
        "everything": dict(topo=het_topo, comp=comp, num_clients=10, num_frames=50,
                           dispatch="least_queue", client_classes=het_classes,
                           batching=True, gather_window=2e-3,
                           migration=MigrationConfig(),
                           codec=crate.CodecConfig(base=hardware.codec_point()),
                           drifts=list(late_drift)),
        "mixed": dict(topo=topo, comp=comp, num_clients=9, num_frames=40,
                      granularity="multi_step", workloads=workload_suite()),
        "mixed_everything": dict(topo=btopo, comp=comp, num_clients=10, num_frames=50,
                                 dispatch="least_queue", granularity="multi_step",
                                 workloads=workload_suite(), gather_window=2e-3,
                                 migration=MigrationConfig(min_dwell_frames=10),
                                 drifts=list(late_drift)),
    }


def fleet_outcome(res):
    """A fleet result as plain values, on the fields the reference's
    engine-equivalence check compares: events and duration; per client
    its edge, replans, migrations, total wait, rate changes, processed
    frame events, duration and codec; per edge its load; the shared
    media; the plan cache's counters; the migration records."""
    def astuple(x):
        return None if x is None else dataclasses.astuple(x)

    mig = res.migration
    return (
        res.events, res.duration,
        tuple((c.edge, c.replans, c.migrations, c.total_wait, c.rate_changes,
               tuple(astuple(e) for e in c.stats.processed), c.stats.duration,
               astuple(c.codec)) for c in res.clients),
        tuple(astuple(e) for e in res.edges),
        tuple(astuple(m) for m in res.links),
        (res.cache.stats.hits, res.cache.stats.misses, res.cache.stats.invalidations),
        None if mig is None else (
            mig.count, mig.considered, mig.rejected_dwell, mig.rejected_threshold,
            tuple((r.client, r.src, r.dst, r.time) for r in mig.records)),
    )


def _host_cpu():
    """The host CPU as /proc/cpuinfo names it: model name, vendor, family
    and model number (some hosts give the name as "unknown"), and the
    logical CPUs this process sees."""
    fields = {}
    for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip(), value.strip())
    keys = ("model name", "vendor_id", "cpu family", "model")
    return (", ".join(f"{k} {fields[k]}" for k in keys if k in fields)
            + f"; {len(os.sched_getaffinity(0))} logical CPUs")


def phase_fleet(fit, cpu_fit, executed, card):
    """The fleet on the port.  ``fit`` is phase 12's (gain, floor) from
    the card, ``cpu_fit`` the CPU's; ``executed`` maps each deployment of
    phase 15's grid to the frames ``executed_run`` tracked on the card."""
    from repro_torch.cluster import PlanCache, capacity_sweep, run_fleet
    from repro_torch.codec import rate
    from repro_torch.core.offload import Policy, Topology
    from repro_torch.examples import edge_offload_serve as serve
    from repro_torch.sim import hardware

    t_start = time.perf_counter()
    comp = hardware.paper_staged()

    def both(**kw):
        """The object engine's result, its outcome, and whether the vector
        engine's outcome equals it."""
        res = run_fleet(engine="object", cache=PlanCache(), **kw)
        vec = run_fleet(engine="vector", cache=PlanCache(), **kw)
        outcome = fleet_outcome(res)
        return res, outcome, outcome == fleet_outcome(vec)

    # a. the codec golden config's fleet under the card's calibration
    topo = hardware.fleet_star(num_edges=3, edge_capacity=2)
    motion = rate.sequence_motion()
    fits = {"card": fit, "cpu": cpu_fit,
            "defaults": (rate.DEFAULT_DENSITY_GAIN, rate.DEFAULT_DENSITY_FLOOR)}
    runs = {}
    for label, (gain, floor) in fits.items():
        codec = rate.CodecConfig(base=hardware.codec_point(), motion=motion,
                                 density_gain=gain, density_floor=floor)
        res, outcome, same = both(topo=topo, comp=comp, num_clients=6, num_frames=40,
                                  codec=codec)
        check(same, f"fleet under the {label} density fit: object and vector engines differ")
        runs[label] = outcome
        points = "; ".join(
            f"client {c.client}: {c.codec.quant_bits}-bit, keyframe every "
            f"{c.codec.keyframe_interval}, density {c.codec.change_density}, "
            f"{c.rate_changes} rate changes" for c in res.clients)
        log(f"[fleet] codec fleet (fleet_star 3 x 2, 6 clients, 40 frames, sequence "
            f"motion) under the {label} fit (gain {gain!r}, floor {floor!r}): "
            f"{res.events} events, object == vector; {points}")
    fits_equal = ("bit-equal" if fit == cpu_fit
                  else f"not bit-equal: {fit!r} on the card, {cpu_fit!r} on the CPU")
    check(runs["card"] == runs["cpu"],
          f"the fleet under the card's density fit differs from the same run under the "
          f"CPU's (the fits are {fits_equal})")
    log(f"[fleet] the card's fit and the CPU's are {fits_equal}; they give the same fleet, "
        f"event for event, on both engines")

    # b. the golden configs, object engine against vector engine
    for name, kw in sorted(fleet_golden_configs().items()):
        res, _, same = both(**kw)
        check(same and res.events > 0, f"golden config {name}: object and vector engines differ")
        log(f"[fleet] golden {name:16s} object == vector: {res.events} events, mean fps "
            f"{res.mean_achieved_fps!r}, drop rate {res.drop_rate!r}, p99 "
            f"{res.p99_loop_time * 1e3!r} ms")

    # c. the one-client limit against the frames the card tracked
    for name, env, policy, gran in serve.deployments():
        star = Topology.star(("client", env.client), [("server", env.server, env.link)],
                             wrapper=env.wrapper, wrapped=env.wrapped)
        (point,) = capacity_sweep(star, comp, client_counts=(1,), num_frames=GRID_FRAMES,
                                  policy=policy, granularity=gran, seed=0)
        frames = [e.index for e in point.result.clients[0].stats.processed]
        admitted = point.result.edges[0].admitted
        check(frames == executed[name],
              f"{name}: the one-client fleet processed {frames}, executed_run tracked "
              f"{executed[name]} on the card")
        # Forced sends every processed frame to the edge, Local none;
        # Auto sends what its plan chose
        want = {Policy.FORCED: len(frames), Policy.LOCAL: 0}.get(policy, admitted)
        check(admitted == want,
              f"{name}: the capacity-1 edge admitted {admitted} frames, expected {want}")
        log(f"[fleet] one client, capacity-1 edge, {name:44s} processed {len(frames):2d} "
            f"frames = executed_run's on {card}; edge admitted {admitted}"
            + (" (the plan keeps every stage on the client: the edge stays idle and only "
               "the client's clock is held)" if admitted == 0 else ""))

    # d. engine throughput on this host (host numbers, not the card's)
    clients, edges, frames = FLEET_EVENTS_SHAPE
    wide = hardware.fleet_star(num_edges=edges, edge_capacity=8)
    best, events = {}, {}
    for engine in ("object", "vector"):
        best[engine] = float("inf")
        for _ in range(FLEET_EVENTS_REPS):
            t0 = time.perf_counter()
            res = run_fleet(wide, comp, num_clients=clients, num_frames=frames,
                            policy=Policy.AUTO, cache=PlanCache(), engine=engine)
            best[engine] = min(best[engine], time.perf_counter() - t0)
            check(events.setdefault(engine, res.events) == res.events,
                  f"the {engine} engine's event count varied across reps")
    check(events["object"] == events["vector"],
          f"engine event counts differ: {events}")
    rate_o, rate_v = events["object"] / best["object"], events["vector"] / best["vector"]
    log(f"[fleet] engine throughput on the host CPU ({_host_cpu()}; host numbers, not the "
        f"card's), {clients} clients x {edges} edges x {frames} frames, {events['object']} "
        f"events, best of {FLEET_EVENTS_REPS}: object {rate_o!r} events/s, vector "
        f"{rate_v!r} events/s, ratio {rate_v / rate_o!r} (the reference's "
        f"gate_min_speedup {FLEET_EVENTS_GATE}, a CPU record of an earlier machine: not "
        f"checked)")
    log(f"[fleet] phase took {time.perf_counter() - t_start:.2f} s")


LLM_TOL = 1e-4  # reduced archs, float32 with TF32 off: the card against the port's CPU
LLM_STEPS = 10  # decode steps after a 10-token prefill, 20 tokens in all
LLM_FULL_ARCH = "gemma-2b"
# full width, float32: prefill on 16 tokens + 16 decode steps against the
# forward over all 32, at every position.  The reference holds its 2-layer
# reduced configs to 5e-5 (tests/test_decode_consistency.py); 18 layers of
# d_model 2,048 and a 16,384-wide MLP accumulate more rounding.
LLM_FULL_DECODE_BOUND = 2e-4


def _llm_inputs(torch, cfg, device, batch=2, seq=2 * LLM_STEPS):
    """(forward batch, prefill kwargs, decode positions per step) for one
    reduced arch, built as tests/test_decode_consistency.py builds them."""
    import numpy as np

    from repro_torch.models import multimodal

    half = seq // 2
    tokens = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
        device=device)
    if cfg.mrope:
        f = cfg.frontend_tokens
        fe = multimodal.fake_frontend_embeds(cfg, batch, device=device)
        pos = multimodal.mrope_positions(batch, seq, image_grid=(4, 4), device=device)
        return ({"tokens": tokens, "positions": pos, "frontend_embeds": fe},
                {"positions": pos[:, :, : f + half], "frontend_embeds": fe},
                [pos[:, :, f + t: f + t + 1] for t in range(half, seq)])
    if cfg.encoder_layers:
        enc = multimodal.fake_frontend_embeds(cfg, batch, device=device)
        return ({"tokens": tokens, "encoder_tokens": enc}, {"encoder_tokens": enc},
                [None] * (seq - half))
    return {"tokens": tokens}, {}, [None] * (seq - half)


def _llm_logits(torch, transformer, cfg, params, device):
    """forward, prefill and each decode step's logits, on the host."""
    batch, pkw, dpos = _llm_inputs(torch, cfg, device)
    half = batch["tokens"].shape[1] // 2
    with torch.no_grad():
        logits, _ = transformer.forward(cfg, params, batch)
        max_len = logits.shape[1] + 4
        lp, cache = transformer.prefill(cfg, params, batch["tokens"][:, :half], max_len, **pkw)
        out = {"forward": logits.cpu(), "prefill": lp.cpu()}
        for i, pos in enumerate(dpos):
            t = half + i
            ld, cache = transformer.decode_step(cfg, params, cache,
                                                batch["tokens"][:, t: t + 1], positions=pos)
            out[f"decode {i}"] = ld.cpu()
    return out


def _top2_gap(torch, logits):
    """The smallest gap between the two largest logits of any row."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


def phase_llm(torch, card):
    """The LLM analogue's serving path on the port (slice 6).  a: every
    reduced arch on the card against the port's CPU run, and the engines'
    greedy tokens; b: gemma-2b at full width in bfloat16 through
    ``launch.serve.run``, then timed by CUDA events; c: the full-width
    decode against the forward in float32."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.engine import Engine, Request

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 must stay off where the card's results are compared")

    # a. reduced parity: parameters drawn once on the CPU and copied to the card
    worst = 0.0
    for arch in registry.list_archs():
        cfg = registry.get(arch).reduced()
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        on_card = transformer.tree_map(lambda t: t.to(device), params)
        got = _llm_logits(torch, transformer, cfg, on_card, device)
        want = _llm_logits(torch, transformer, cfg, params, "cpu")
        errs = {k: float((got[k] - want[k]).abs().max()) for k in want}
        finite = all(bool(torch.isfinite(v).all()) for v in got.values())
        err = max(errs.values())
        worst = max(worst, err)
        check(finite and err < LLM_TOL,
              f"{cfg.name}: the card's logits differ from the CPU's by {err!r} (bound "
              f"{LLM_TOL}), finite {finite}: {errs}")
        log(f"[llm] {cfg.name:30s} on {card} vs the CPU, float32, TF32 off: forward "
            f"{tuple(got['forward'].shape)} max |err| {errs['forward']:.3e}, prefill "
            f"{errs['prefill']:.3e}, {LLM_STEPS} decode steps "
            f"{max(v for k, v in errs.items() if k.startswith('decode')):.3e} (bound {LLM_TOL})")

    cfg = registry.get(LLM_FULL_ARCH).reduced()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = transformer.tree_map(lambda t: t.to(device), params)
    rng = np.random.default_rng(0)
    requests = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 16).astype(np.int32),
                        max_new_tokens=24) for i in range(8)]
    want = Engine(cfg, params, max_len=64).generate(requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = Engine(cfg, on_card, max_len=64).generate(requests)
    dt = time.perf_counter() - t0
    cont = ContinuousEngine(cfg, on_card, num_slots=4, max_len=64)
    for r in requests:
        cont.submit(r)
    streamed = cont.run_to_completion()
    for g, w, c in zip(got, want, streamed):
        check(np.array_equal(g.tokens, w.tokens),
              f"{cfg.name}: request {g.uid}'s tokens on the card {g.tokens.tolist()} differ "
              f"from the CPU's {w.tokens.tolist()}")
        check(np.array_equal(c.tokens, g.tokens),
              f"{cfg.name}: request {g.uid}'s tokens from ContinuousEngine "
              f"{c.tokens.tolist()} differ from Engine's {g.tokens.tolist()}")
    total = sum(len(c.tokens) for c in got)
    log(f"[llm] {cfg.name}: Engine served the example's 8 requests (16-token prompts, 24 new "
        f"tokens) on {card}: {total} tokens equal to the CPU's, and ContinuousEngine (4 slots) "
        f"gives each request the same tokens; {total / dt:.1f} tok/s on {card} (host clock, "
        f"eager, a 2-layer model: launch-bound)")

    # b. full width through the normal entry point
    cfg = registry.get(LLM_FULL_ARCH)
    shapes = transformer.param_shapes(cfg)
    n_params = sum(leaf.numel() for _, leaf in transformer.tree_leaves(shapes))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = serve.run(LLM_FULL_ARCH, reduced=False, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    check(sorted(out) == ["arch", "new_tokens", "requests", "sample", "seconds",
                          "tokens_per_second"]
          and out["arch"] == cfg.name and out["requests"] == 8 and out["new_tokens"] == 8 * 32
          and all(0 <= t < cfg.vocab_size for t in out["sample"]),
          f"serve.run at full width returned {out}")
    log(f"[llm] {cfg.name} at full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV head, head_dim "
        f"{cfg.resolved_head_dim}, {cfg.mlp} d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
        f"embeddings, {cfg.dtype}) through launch.serve.run(device='cuda') on {card}: "
        f"{n_params} parameters in the port's tree (cfg.param_count() {cfg.param_count()}), "
        f"peak memory allocated {peak / 2**30:.3f} GiB; 8 requests x 32-token prompts x 32 new "
        f"tokens = {out['new_tokens']} tokens in {out['seconds']:.3f} s, "
        f"{out['tokens_per_second']:.1f} tok/s (host clock, first call); sample "
        f"{out['sample']}")

    # the same run again (same seed, same parameters), timed by CUDA events
    params = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                     device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=32).astype(np.int32) for _ in range(8)]
    engine = Engine(cfg, params, max_len=32 + 32 + 8)
    tokens = torch.as_tensor(np.stack(prompts), device=device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(33)]
    with torch.no_grad():
        ev[0].record()
        logits, cache = engine._prefill(engine.params, tokens)
        ev[1].record()
        cur = engine._sample(logits)
        steps, generated = [logits], [cur]
        for i in range(31):
            step, cache = engine._decode(engine.params, cache, cur[:, None])
            ev[i + 2].record()
            cur = engine._sample(step[:, 0])
            steps.append(step[:, 0])
            generated.append(cur)
    torch.cuda.synchronize()
    first_logits = logits
    finite = all(bool(torch.isfinite(x).all()) for x in steps)
    gap = min(_top2_gap(torch, x) for x in steps)
    del steps
    gen = torch.stack(generated, dim=1).cpu().numpy()
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = [ev[j].elapsed_time(ev[j + 1]) for j in range(1, 32)]
    check(finite, f"{cfg.name} at full width: a logit is not finite")
    check(((gen >= 0) & (gen < cfg.vocab_size)).all(),
          f"{cfg.name} at full width: a token outside the vocabulary")
    check(gen[0, :16].tolist() == out["sample"],
          f"{cfg.name} at full width: the timed run's tokens {gen[0, :16].tolist()} differ from "
          f"serve.run's {out['sample']} for the same seed")
    decode_ms = statistics.mean(step_ms)
    total_ms = prefill_ms + sum(step_ms)
    log(f"[llm] {cfg.name} at full width on {card}, timed by CUDA events (the same seed and "
        f"tokens as serve.run): prefill of 8 x 32 tokens {prefill_ms:.3f} ms; decode "
        f"{decode_ms:.3f} ms a step (median {statistics.median(step_ms):.3f}, min "
        f"{min(step_ms):.3f}, max {max(step_ms):.3f} over 31 steps of 8 tokens); "
        f"{8 * 32 / (total_ms / 1e3):.1f} tok/s over prefill + decode; every logit finite, every "
        f"token in the vocabulary; smallest top-2 logit gap {gap:.3e}")

    # c. full-width decode against the forward, in float32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = transformer.tree_map(lambda t: t.float(), params)
    del params, engine, cache, logits, step
    seq, half = 32, 16
    with torch.no_grad():
        full, _ = transformer.forward(cfg32, params32, {"tokens": tokens})
        lp, cache = transformer.prefill(cfg32, params32, tokens[:, :half], max_len=seq + 8)
        errs = [float((lp - full[:, half - 1]).abs().max())]
        for t in range(half, seq):
            ld, cache = transformer.decode_step(cfg32, params32, cache, tokens[:, t: t + 1])
            errs.append(float((ld[:, 0] - full[:, t]).abs().max()))
    scale = float(full.abs().max())
    agree = int((first_logits.float().argmax(-1) == full[:, -1].argmax(-1)).sum())
    del params32, full, cache, lp, ld
    torch.cuda.empty_cache()
    err = max(errs)
    check(err < LLM_FULL_DECODE_BOUND,
          f"{cfg.name} at full width, float32: prefill + decode differ from the forward by "
          f"{err!r} (bound {LLM_FULL_DECODE_BOUND}); per position {errs}")
    log(f"[llm] {cfg.name} at full width in float32 on {card} (TF32 off): prefill on 16 "
        f"tokens + 16 decode steps against the forward over all 32, 8 sequences: max |err| "
        f"{err!r} (bound {LLM_FULL_DECODE_BOUND}; largest |logit| {scale:.3f}); the bfloat16 "
        f"run's first token equals the float32 forward's argmax on {agree} of 8 requests "
        f"(printed, not checked)")
    log(f"[llm] phase took {time.perf_counter() - t_start:.2f} s; worst reduced error "
        f"{worst:.3e}")
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms}


# ---------------------------------------------------------------------------
# Phase 18: the LLM analogue's training path (``repro_torch.optim``,
# ``checkpoint``, ``data.tokens``, ``launch.train``).

TRAIN_TOL = 1e-5  # reduced archs, float32, TF32 off: the card against the port's CPU
TRAIN_REMAT_TOL = 1e-6  # the card's gradients, remat on against off
# A dense step's operations are 6 N tokens (forward 2, backward 4); remat
# recomputes the forward, which this bound does not count.
PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bfloat16, 700 W
TRAIN_TIMED_STEPS = 6  # full width: the first pays the allocator's growth, 5 are timed
TRAIN_SPLIT_STEPS = 3  # full width, with remat and without: forward + backward, update


def _train_batch(torch, cfg, device, batch=2, seq=32):
    """tests/test_models_smoke.py's batch for one arch (B 2, S 32), its
    tokens drawn with numpy."""
    import numpy as np

    from repro_torch.models import multimodal

    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"tokens": torch.as_tensor(tokens, device=device),
           "targets": torch.as_tensor(np.roll(tokens, -1, axis=1), device=device),
           "loss_mask": torch.ones((batch, seq), dtype=torch.float32, device=device)}
    if cfg.mrope:
        n = seq + cfg.frontend_tokens
        out["positions"] = torch.arange(n, dtype=torch.int32, device=device).expand(3, batch, n)
    if cfg.mrope or cfg.modality == "vision":
        out["frontend_embeds"] = multimodal.fake_frontend_embeds(cfg, batch, device=device)
    if cfg.encoder_layers:
        out["encoder_tokens"] = multimodal.fake_frontend_embeds(cfg, batch, device=device)
        out.pop("frontend_embeds", None)
    return out


def _grad_errs(torch, transformer, got, want):
    """{path: max |got - want| / max |want|} over two gradient trees."""
    want = dict(transformer.tree_leaves(want))
    out = {}
    for path, g in transformer.tree_leaves(got):
        w = want[path].to(g.device)
        out[path] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return out


def _bit_equal_trees(torch, transformer, got, want):
    """Paths where two trees (any devices) differ in a bit."""
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    want = dict(transformer.tree_leaves(want))
    return [p for p, t in transformer.tree_leaves(got)
            if t.dtype != want[p].dtype or not torch.equal(bits(t.cpu()), bits(want[p].cpu()))]


def phase_train(torch, card):
    """The LLM analogue's training path on the port (slice 7).  a: every
    reduced arch's loss and gradients on the card against the port's CPU,
    and remat on against off; b: ``launch.train.run`` at the reference's
    integration settings, then a checkpoint written from the card and
    restored on the CPU; c: gemma-2b trained at full width in bfloat16
    through ``train.run``, then its step timed by CUDA events, its peak
    memory with and without remat, and one AdamW update at lr_scale 1."""
    import contextlib
    import io
    import math
    import tempfile

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.optim import adamw

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must stay off where the card's results are compared")

    # a. reduced parity: parameters drawn once on the CPU and copied to the card
    worst, worst_remat = 0.0, 0.0
    for arch in registry.list_archs():
        cfg = registry.get(arch).reduced()
        params = transformer.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        on_card = transformer.tree_map(lambda t: t.to(device), params)
        (want_loss, _), want = train.value_and_grad(cfg, params,
                                                    _train_batch(torch, cfg, "cpu"))
        batch = _train_batch(torch, cfg, device)
        (loss, _), got = train.value_and_grad(cfg, on_card, batch)
        (loss0, _), got0 = train.value_and_grad(cfg, on_card, batch, remat=False)
        errs = _grad_errs(torch, transformer, got, want)
        remat_errs = _grad_errs(torch, transformer, got0, got)
        finite = all(bool(torch.isfinite(g).all()) for _, g in transformer.tree_leaves(got))
        err, remat_err = max(errs.values()), max(remat_errs.values())
        loss_err = abs(float(loss) - float(want_loss))
        worst, worst_remat = max(worst, err, loss_err), max(worst_remat, remat_err)
        check(finite and loss_err < TRAIN_TOL and err < TRAIN_TOL,
              f"{cfg.name}: the card's loss differs from the CPU's by {loss_err!r} and its "
              f"gradients by {err!r} of a leaf's largest (bound {TRAIN_TOL}), finite {finite}")
        check(torch.equal(loss0, loss) and remat_err < TRAIN_REMAT_TOL,
              f"{cfg.name}: remat changed the card's loss ({float(loss)!r} against "
              f"{float(loss0)!r}) or its gradients by {remat_err!r} (bound {TRAIN_REMAT_TOL})")
        log(f"[train] {cfg.name:30s} on {card} vs the CPU, float32, TF32 off: loss "
            f"{float(loss):.6f} (|err| {loss_err:.3e}), {len(errs)} gradient leaves, worst "
            f"{err:.3e} of the leaf's largest |g| at {max(errs, key=errs.get)} (bound "
            f"{TRAIN_TOL}); remat off: loss bit-equal, gradients {remat_err:.3e} (bound "
            f"{TRAIN_REMAT_TOL})")

    # b. the reference's integration run on the card, and a checkpoint crossing to the CPU
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = train.run("gemma-2b", steps=40, batch=4, seq=64, reduced=True, lr=1e-3,
                            log_every=39, device="cuda", ckpt_dir=os.path.join(tmp, "run"))
        dt = time.perf_counter() - t0
        for line in out.getvalue().splitlines():
            log(f"[train] {line}")
        check(res["final_loss"] < res["first_loss"],
              f"train.run on the card did not lower the loss: {res['losses']}")
        check(ckpt_io.latest_step(os.path.join(tmp, "run")) == 40,
              "train.run's checkpoint is not at step 40")
        cfg = train.train_config("gemma-2b", seq=64)
        ran = ckpt_io.restore(os.path.join(tmp, "run"), 40,
                              {"params": transformer.param_shapes(cfg)})["params"]
        check(all(bool(torch.isfinite(t).all()) for _, t in transformer.tree_leaves(ran)),
              "train.run's final checkpoint holds a non-finite parameter")
        log(f"[train] train.run('gemma-2b', steps=40, batch=4, seq=64, reduced=True, lr=1e-3) on "
            f"{card}: {res['params']} parameters, loss {res['first_loss']:.4f} -> "
            f"{res['final_loss']:.4f} in {dt:.2f} s (host clock, first call); its step-40 "
            f"checkpoint restored on the CPU, every parameter finite")

        params = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(1),
                                         device=device)
        state = adamw.init(params)
        step_fn = train.build_train_step(cfg, adamw.AdamWConfig(lr=1e-3), None,
                                         adamw.cosine_schedule(40))
        pipe = iter(TokenPipeline(TokenPipelineConfig(cfg.vocab_size, 64, 4, seed=1)))
        for _ in range(3):
            batch = {k: torch.as_tensor(v, device=device) for k, v in next(pipe).items()}
            params, state, _ = step_fn(params, state, batch)
        ckpt_io.save(os.path.join(tmp, "state"), 3, {"params": params, "opt": state})
        check(ckpt_io.latest_step(os.path.join(tmp, "state")) == 3, "latest_step is not 3")
        back = ckpt_io.restore(os.path.join(tmp, "state"), 3, {
            "params": transformer.param_shapes(cfg), "opt": adamw.init(transformer.param_shapes(cfg))})
        differ = (_bit_equal_trees(torch, transformer, back["params"], params)
                  + _bit_equal_trees(torch, transformer, back["opt"].mu, state.mu)
                  + _bit_equal_trees(torch, transformer, back["opt"].nu, state.nu))
        check(not differ and back["opt"].step.device.type == "cpu"
              and int(back["opt"].step) == int(state.step) == 3,
              f"the checkpoint from the card restored on the CPU differs at {differ}")
        log(f"[train] {cfg.name}: parameters and AdamW state after 3 steps on the card, saved "
            f"by checkpoint.io and restored on the CPU: bit-equal "
            f"({len(transformer.tree_leaves(params))} x 3 leaves and the step), latest_step 3")
    del params, state, back, ran

    # c. gemma-2b at full width in bfloat16 through the normal entry point
    full = registry.get(LLM_FULL_ARCH)
    n_params = sum(t.numel() for _, t in transformer.tree_leaves(transformer.param_shapes(full)))
    batch_n, seq = 8, 256
    tokens = batch_n * seq
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train.run(LLM_FULL_ARCH, reduced=False, steps=4, batch=batch_n, seq=seq,
                        log_every=1, device="cuda")
    run_peak = torch.cuda.max_memory_allocated()
    logged = []
    for line in out.getvalue().splitlines():
        log(f"[train] {line}")
        words = line.split()
        logged.append((float(words[3]), float(words[5])))
    check(len(logged) == 4 and all(math.isfinite(x) for pair in logged for x in pair),
          f"train.run at full width logged a non-finite loss or grad norm: {logged}")
    check(res["arch"] == full.name and res["params"] == n_params,
          f"train.run at full width returned {res}")
    log(f"[train] {full.name} at full width ({full.num_layers} layers, d_model {full.d_model}, "
        f"vocab {full.vocab_size}, {full.dtype}) through train.run(reduced=False, steps=4, "
        f"batch={batch_n}, seq={seq}, device='cuda') on {card}: {n_params} parameters; first "
        f"loss {res['first_loss']:.4f} (ln {full.vocab_size} = "
        f"{math.log(full.vocab_size):.4f}), losses {[round(l, 4) for l, _ in logged]}, grad "
        f"norms {[round(g, 4) for _, g in logged]}; peak memory allocated "
        f"{run_peak / 2**30:.3f} GiB")

    # the step timed by CUDA events, on the same config and state sizes
    opt_cfg = adamw.AdamWConfig()
    params = transformer.init_params(full, torch.Generator(device=device).manual_seed(0),
                                     device=device)
    state = adamw.init(params)
    step_fn = train.build_train_step(full, opt_cfg, None, adamw.cosine_schedule(300))
    pipe = iter(TokenPipeline(TokenPipelineConfig(full.vocab_size, seq, batch_n)))
    batches = [{k: torch.as_tensor(v, device=device) for k, v in next(pipe).items()}
               for _ in range(TRAIN_TIMED_STEPS)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED_STEPS + 1)]
    ev[0].record()
    for i, batch in enumerate(batches):
        params, state, metrics = step_fn(params, state, batch)
        ev[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TRAIN_TIMED_STEPS)]
    check(math.isfinite(float(metrics["loss"])), "the timed full-width step's loss is not finite")
    median = statistics.median(step_ms[1:])
    bound_ms = 6 * n_params * tokens / PEAK_BF16_FLOPS * 1e3
    log(f"[train] {full.name} at full width, train step by CUDA events on {card} ({batch_n} x "
        f"{seq} = {tokens} tokens, remat on): first {step_ms[0]:.3f} ms, then median "
        f"{median:.3f} ms (min {min(step_ms[1:]):.3f}, max {max(step_ms[1:]):.3f} over "
        f"{TRAIN_TIMED_STEPS - 1} steps), {tokens / (median / 1e3):.1f} tok/s; bound "
        f"{bound_ms:.3f} ms (6 x {n_params} x {tokens} = {6 * n_params * tokens:.3e} FLOP at "
        f"the data sheet's {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bfloat16, 700 W; remat's "
        f"recomputation not counted), {bound_ms / median:.3f} of it")

    # each step with remat and without (the train step's body: loss_fn and
    # torch.autograd.grad, then adamw.update at lr_scale 0, which leaves the
    # parameters as they are), on the same state: its peak memory, and its
    # forward + backward and its update timed by CUDA events
    peaks, split = {}, {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for batch in batches[:TRAIN_SPLIT_STEPS]:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            _, grads = train.value_and_grad(full, params, batch, remat=remat)
            ev[1].record()
            adamw.update(opt_cfg, grads, state, params, 0.0)
            ev[2].record()
            del grads
            torch.cuda.synchronize()
            ms.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        peaks[remat] = torch.cuda.max_memory_allocated()
        split[remat] = [statistics.median(x) for x in zip(*ms)]
    total = torch.cuda.get_device_properties(device).total_memory
    check(peaks[True] < peaks[False] and max(peaks.values()) < total,
          f"peak memory with remat {peaks[True]} B, without {peaks[False]} B, card {total} B: "
          f"remat must peak lower, and both under the card's memory")
    for remat in (True, False):
        fb, upd = split[remat]
        log(f"[train] {full.name} at full width on {card}, remat {'on' if remat else 'off'}: "
            f"peak memory allocated {peaks[remat] / 2**30:.3f} GiB (card {total / 2**30:.3f} "
            f"GiB); by CUDA events, median of {TRAIN_SPLIT_STEPS}: forward + backward "
            f"{fb:.3f} ms, adamw.update {upd:.3f} ms, step {fb + upd:.3f} ms, "
            f"{tokens / ((fb + upd) / 1e3):.1f} tok/s")

    # one update at lr_scale 1 must move the bfloat16 parameters
    _, grads = train.value_and_grad(full, params, batches[0])
    before = transformer.tree_map(torch.clone, params)
    adamw.update(opt_cfg, grads, state, params, 1.0)
    before = dict(transformer.tree_leaves(before))
    moved = [p for p, t in transformer.tree_leaves(params) if not torch.equal(t, before[p])]
    check(bool(moved), "adamw.update at lr_scale 1 moved no bfloat16 parameter")
    log(f"[train] {full.name}: one adamw.update at lr_scale 1 (lr {opt_cfg.lr}) moved "
        f"{len(moved)} of {len(before)} bfloat16 leaves; unmoved: "
        f"{sorted(set(before) - set(moved))}")
    del params, state, before, grads, batches, metrics
    torch.cuda.empty_cache()
    log(f"[train] phase took {time.perf_counter() - t_start:.2f} s; worst reduced error "
        f"{worst:.3e}, remat {worst_remat:.3e}")
    return {"step_ms": median}


# ---------------------------------------------------------------------------
# Phase 19: the mesh and the dry run (``launch.mesh``, ``sharding.specs``,
# the sharded tracker, ``roofline``, ``launch.dryrun``).

MESH_FRAMES = 10  # the sharded tracker's clip: the main path's first 10 frames, 9 tracked
# (arch, shape) on the (16, 16) production mesh; each runs in a process of
# its own (its fake process group must not meet this process's NCCL one),
# started as phase 19 begins: started earlier, their host load slowed the
# host-bound phases 5 and 17 by half
DRYRUN_COMBOS = (("gemma-2b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"))
DRYRUN_TIMEOUT = 900


def start_dryruns(out_dir):
    """The dry-run combos, each ``python -m repro_torch.launch.dryrun`` in a
    process of its own writing to ``out_dir``; every one is killed at exit
    if it still runs.  Returns (out_dir, the runs)."""
    import atexit

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    runs = []
    for arch, shape in DRYRUN_COMBOS:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", "single", "--out", out_dir, "--force"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        runs.append((arch, shape, proc, time.perf_counter()))
        atexit.register(lambda p=proc: p.poll() is None and (p.kill(), p.wait()))
    return out_dir, runs


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _stand_in_mesh(shape, axes):
    """An object with a mesh's axis names and shape: all the sharding
    rules read."""
    import types

    return types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _dryrun_arg_bytes(arch, shape_name):
    """The dry run's arguments per device on the (16, 16) mesh, summed from
    the port's specs: what ``build_*`` places, counted from shapes alone."""
    from repro_torch.configs import registry, shapes as shp
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.sharding import specs

    mesh = _stand_in_mesh((16, 16), ("data", "model"))
    cfg, shape = registry.get(arch), shp.ALL_SHAPES[shape_name]
    params = transformer.param_shapes(cfg)
    p_specs = specs.param_specs(params, mesh)
    total = specs.local_nbytes(params, p_specs, mesh)
    batch = shp.token_inputs(cfg, shape)
    if shape.kind == "train":
        opt = adamw.init(params)
        total += specs.local_nbytes(opt, adamw.AdamWState((), p_specs, p_specs), mesh)
    if shape.kind == "decode":
        cache = transformer.cache_shapes(cfg, shape.global_batch, shape.seq_len)
        total += specs.local_nbytes(cache, specs.cache_specs(cache, mesh), mesh)
        batch = {k: v for k, v in batch.items()
                 if k == "tokens" or (k == "positions" and cfg.mrope)}
    return total + specs.local_nbytes(batch, specs.input_specs_tree(batch, mesh), mesh)


def phase_mesh(torch, tracker_mod, rs, pu, frames, truth, card, timed):
    """The multi-device path on one card (slice 8).  a: a one-rank NCCL
    group and ``make_host_mesh()``; b: ``make_track_frame_sharded`` at full
    width against ``make_track_frame`` on the same draws; c: the reduced
    train step over the one-rank mesh against the meshless step; d: the op
    census around one full-width decode step and one train step, beside
    phases 17 and 18's times; e: the dry-run combos' records.  Returns the
    sharded tracker's K1 and K2 launches."""
    import json as json_mod
    import math

    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import registry, shapes as shp
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.roofline import analysis, op_cost
    from repro_torch.sharding import specs

    import shutil
    import tempfile

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    # e's host processes first: they run while a-d use the card
    dryrun_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    atexit.register(shutil.rmtree, dryrun_dir, True)
    dryruns = start_dryruns(dryrun_dir)

    # a. one rank, one card
    port = _free_port()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=device)
    mesh = lmesh.make_host_mesh()
    check(mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
          and mesh.mesh_dim_names == ("data", "model"),
          f"make_host_mesh() gave {mesh}")
    log(f"[mesh] NCCL group of 1 rank (tcp://localhost:{port}), make_host_mesh(): {mesh}")

    # b. the sharded tracker at full width, on the main path's draws
    cfg = configs()[1]
    sharded = tracker_mod.make_track_frame_sharded(cfg, mesh, "model", device=device)
    local = tracker_mod.make_track_frame(cfg, device=device)
    sharded(torch.Generator(device=device).manual_seed(5), truth[0], frames[1])  # NCCL set-up
    torch.cuda.synchronize()

    def track(step):
        gen = torch.Generator(device=device).manual_seed(0)
        h, out, ms = truth[0], [], []
        for i in range(1, MESH_FRAMES):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            h, score = step(gen, h, frames[i])
            ev[1].record()
            ev[1].synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
            out.append((h, score))
        return out, ms

    rs.launches = 0
    pu.launches = pu.launches_projected = 0
    got, sharded_ms = track(sharded)
    torch.cuda.synchronize()
    k1, k2, k2_projected = rs.launches, pu.launches, pu.launches_projected
    want, local_ms = track(local)
    tracked = MESH_FRAMES - 1
    differ = [i + 1 for i, ((h, s), (hw, sw)) in enumerate(zip(got, want))
              if not (torch.equal(h, hw) and torch.equal(s, sw))]
    errs = [float(torch.linalg.vector_norm(h[:3] - truth[i + 1][:3]))
            for i, (h, _) in enumerate(got)]
    mean_err = statistics.fmean(errs)
    log(f"[mesh] make_track_frame_sharded over the mesh's 'model' axis, {cfg.camera.width}x"
        f"{cfg.camera.height}, {cfg.pso.num_particles} particles x {cfg.pso.num_generations} "
        f"generations, {tracked} frames on {card}: K1 {k1} and K2 {k2} launches (expected "
        f"{tracked * (1 + cfg.pso.num_generations)} and {tracked * cfg.pso.num_generations}, "
        f"{k2_projected} with the projection fused); h and score of the eager sharded frame "
        f"bit-equal to make_track_frame's captured frame (the graph) on the same draws on "
        f"{tracked - len(differ)} of {tracked} frames; mean position "
        f"error {mean_err * 100:.3f} cm; frame time by CUDA events: median "
        f"{statistics.median(sharded_ms):.3f} ms sharded (eager), "
        f"{statistics.median(local_ms):.3f} ms unsharded (the graph, its capture in the first "
        f"frame)")
    check(not differ, f"the sharded tracker differs from make_track_frame at frames {differ}")
    check(k1 == tracked * (1 + cfg.pso.num_generations)
          and k2 == k2_projected == tracked * cfg.pso.num_generations,
          f"the sharded tracker launched K1 {k1} and K2 {k2} ({k2_projected} fused) times")
    check(mean_err < 0.03, f"the sharded tracker's mean position error {mean_err:.4f} m >= 3 cm")

    # c. the reduced train step over the one-rank mesh against the meshless one
    tcfg = train.train_config("gemma-2b", seq=64)
    params = transformer.init_params(tcfg, torch.Generator(device=device).manual_seed(1),
                                     device=device)
    placed = specs.distribute(transformer.tree_map(torch.clone, params),
                              specs.param_specs(params, mesh), mesh)
    state, placed_state = adamw.init(params), adamw.init(placed)
    opt_cfg, schedule = adamw.AdamWConfig(lr=1e-3), adamw.cosine_schedule(40)
    step = train.build_train_step(tcfg, opt_cfg, None, schedule)
    mesh_step = train.build_train_step(tcfg, opt_cfg, mesh, schedule)
    pipe = iter(TokenPipeline(TokenPipelineConfig(tcfg.vocab_size, 64, 4, seed=1)))
    losses = []
    for _ in range(3):
        host = next(pipe)
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        params, state, m = step(params, state, batch)
        placed, placed_state, pm = mesh_step(
            placed, placed_state, specs.distribute(batch, specs.input_specs_tree(batch, mesh),
                                                   mesh))
        losses.append((float(m["loss"]), float(pm["loss"].full_tensor())))
    gathered = transformer.tree_map(lambda t: t.full_tensor(), placed)
    differ = _bit_equal_trees(torch, transformer, gathered, params)
    differ += [f"mu/{p}" for p in _bit_equal_trees(
        torch, transformer, transformer.tree_map(lambda t: t.full_tensor(), placed_state.mu),
        state.mu)]
    log(f"[mesh] {tcfg.name}: 3 train steps of 4 x 64 over the one-rank mesh (DTensors, the "
        f"gradients redistributed to the parameters' placements) against the meshless step "
        f"on {card}: losses {losses}; parameters and AdamW moments bit-equal on "
        f"{len(transformer.tree_leaves(params)) * 2 - len(differ)} of "
        f"{len(transformer.tree_leaves(params)) * 2} leaves")
    check(not differ and all(a == b for a, b in losses),
          f"the one-rank mesh's train step differs from the meshless step at {differ}, "
          f"losses {losses}")
    del params, placed, state, placed_state, gathered
    dist.destroy_process_group()

    # d. the op census of one full-width decode step and one train step
    full = registry.get(LLM_FULL_ARCH)
    n_params = sum(t.numel() for _, t in transformer.tree_leaves(transformer.param_shapes(full)))
    params = transformer.init_params(full, torch.Generator(device=device).manual_seed(0),
                                     device=device)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, full.vocab_size, size=(8, 32)), dtype=torch.int32,
                             device=device)
    with torch.no_grad():
        logits, cache = transformer.prefill(full, params, tokens, max_len=32 + 32 + 8)
        cur = logits.argmax(-1).to(torch.int32)[:, None]
        (step_logits, _), decode_cost = op_cost.op_cost(
            transformer.decode_step, full, params, cache, cur)
    check(bool(torch.isfinite(step_logits.float()).all()), "the censused decode step is not finite")
    del cache, logits, step_logits
    step_fn = train.build_train_step(full, adamw.AdamWConfig(), None, adamw.cosine_schedule(300))
    state = adamw.init(params)
    host = next(iter(TokenPipeline(TokenPipelineConfig(full.vocab_size, 256, 8))))
    batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    (_, _, metrics), train_cost = op_cost.op_cost(step_fn, params, state, batch)
    check(math.isfinite(float(metrics["loss"])), "the censused train step's loss is not finite")
    del params, state, batch, metrics
    torch.cuda.empty_cache()
    for label, cost, tokens_n, factor, measured in (
            ("decode step, 8 sequences x 1 token (phase 17's)", decode_cost, 8, 2,
             timed["decode_ms"]),
            ("train step, 8 x 256 tokens, remat on (phase 18's)", train_cost, 8 * 256, 6,
             timed["step_ms"])):
        rep = analysis.RooflineReport(
            arch=full.name, shape=label, mesh="one card", chips=1, hlo_flops=cost.flops,
            hlo_bytes=cost.mem_bytes, coll_bytes=cost.coll_bytes,
            coll_by_kind={k: int(v) for k, v in cost.coll_by_kind.items()},
            model_flops=factor * n_params * tokens_n)
        log(f"[mesh] op census of one {full.name} {label} on {card}: {cost.flops:.4e} FLOP "
            f"({cost.transcendentals:.4e} transcendentals apart), {cost.mem_bytes:.4e} B of "
            f"operands + outputs, collectives {cost.coll_bytes:.0f} B; model FLOPs "
            f"{factor} N D = {factor} x {n_params} x {tokens_n} = {rep.model_flops:.4e}, useful "
            f"ratio {rep.useful_ratio:.4f}; roofline terms at the data sheet's H100 SXM peaks "
            f"(989 TFLOP/s dense bfloat16, 3.35 TB/s, 450 GB/s a direction): compute "
            f"{rep.compute_s * 1e3:.4f} ms, memory {rep.memory_s * 1e3:.4f} ms, collective "
            f"{rep.collective_s * 1e3:.4f} ms, dominant {rep.dominant}; measured by CUDA events "
            f"in phase {17 if factor == 2 else 18}: {measured:.3f} ms")
        check(cost.flops > 0 and 0 < rep.useful_ratio <= 1.0 and cost.coll_bytes == 0,
              f"the {label}'s census is off: {cost}, useful ratio {rep.useful_ratio}")

    # e. the dry-run combos, each run in its own process (host time)
    out_dir, runs = dryruns
    for arch, shape_name, proc, t0 in runs:
        try:
            out, err = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"the dry run of {arch} {shape_name} outlived {DRYRUN_TIMEOUT} s")
        seconds = time.perf_counter() - t0
        check(proc.returncode == 0, f"the dry run of {arch} {shape_name} exited "
              f"{proc.returncode}: {out[-1000:]} {err[-2000:]}")
        rec = json_mod.loads((pathlib.Path(out_dir) /
                              f"{arch}__{shape_name}__pod16x16.json").read_text())
        want_args = _dryrun_arg_bytes(arch, shape_name)
        r, notes = rec["roofline"], rec["notes"]
        log(f"[dryrun] {arch} {shape_name} on pod16x16 (a fake group of 256 ranks): status "
            f"{rec['status']}, {seconds:.2f} s of host time for the process "
            f"(build {rec['lower_s']} s, step {rec['compile_s']} s); per device: arguments "
            f"{rec['memory']['argument_size_in_bytes']} B (the specs' sum {want_args} B), peak "
            f"{rec['memory']['bytes_per_chip'] / 2**30:.3f} GiB, {r['hlo_flops']:.4e} FLOP, "
            f"{r['hlo_bytes']:.4e} B, collectives {r['coll_by_kind']}; model FLOPs "
            f"{r['model_flops']:.4e}, useful ratio {r['useful_ratio']:.4f}; roofline at the "
            f"data sheet's H100 SXM peaks: compute {r['compute_s']:.4e} s, memory "
            f"{r['memory_s']:.4e} s, collective {r['collective_s']:.4e} s ({r['dominant']}); "
            f"expert-parallel combines {notes['expert_parallel_combines']}; replicated "
            f"fallbacks {notes['fallbacks']}")
        check(rec["status"] == "ok" and rec["memory"]["argument_size_in_bytes"] == want_args,
              f"the dry run of {arch} {shape_name}: {rec.get('status')} "
              f"{rec.get('error', '')[:500]}")
        cfg_d = registry.get(arch)
        if shp.ALL_SHAPES[shape_name].kind == "train":
            check(r["coll_by_kind"]["all-reduce"] > 0, "the dry-run train step has no all-reduce")
        else:
            check(notes["expert_parallel_combines"] == cfg_d.num_layers
                  and r["coll_by_kind"]["all-reduce"] > 0,
                  f"the dry-run decode ran {notes['expert_parallel_combines']} expert-parallel "
                  f"combines (expected {cfg_d.num_layers}, one a layer, each a sum over model)")
    log(f"[mesh] phase took {time.perf_counter() - t_start:.2f} s")
    return {"k1": k1, "k2": k2}


SLICE3_KERNELS = [
    # key, name, replaces (all in src/repro_torch/csrc/quant_codec.cu)
    ("k5", "significant_bit_widths", "src/repro/codec/kernels.py:229"),
    ("k5b", "significant_bit_widths_batched", "src/repro/codec/kernels.py:260"),
    ("k6", "quantize_pack", "src/repro/codec/kernels.py:331"),
    ("k6b", "quantize_pack_batched", "src/repro/codec/kernels.py:409"),
    ("k7", "unpack_dequantize", "src/repro/codec/kernels.py:370"),
]


FUSED_KERNELS = [
    # key, name, source, replaces: the launches that took over K7's, K4's
    # and K5's work (the TPU kernel whose work each took)
    ("quant_encode", "quant_encode", "src/repro_torch/csrc/quant_codec.cu",
     "src/repro/codec/kernels.py:370"),
    ("quant_decode", "quant_decode", "src/repro_torch/csrc/quant_codec.cu",
     "src/repro/codec/kernels.py:370"),
    ("k3_recon", "delta_encode_recon", "src/repro_torch/csrc/delta_codec.cu",
     "src/repro/codec/kernels.py:130"),
    ("k4_pair", "delta_decode_pair", "src/repro_torch/csrc/delta_codec.cu",
     "src/repro/codec/kernels.py:130"),
    ("k3_widths", "delta_encode_widths", "src/repro_torch/csrc/delta_codec.cu",
     "src/repro/codec/kernels.py:229"),
    ("k3b_widths", "delta_encode_widths_batched", "src/repro_torch/csrc/delta_codec.cu",
     "src/repro/codec/kernels.py:260"),
    ("k6_recon", "quantize_pack_recon", "src/repro_torch/csrc/quant_codec.cu",
     "src/repro/codec/kernels.py:370"),
]

# rows whose launches are also counted in another row's: the row's name
SUBSET_OF = {"k3_recon": "delta_encode", "k4_pair": "delta_decode",
             "k3_widths": "delta_encode", "k3b_widths": "delta_encode_batched",
             "k6_recon": "quantize_pack"}


SLICE2_KERNELS = [
    # key, name, source, replaces
    ("k1b", "render_score_sums_batched", "src/repro_torch/csrc/render_score.cu",
     "src/repro/kernels/render_score.py:183"),
    ("k2b", "pso_update_batched", "src/repro_torch/csrc/pso_update.cu",
     "src/repro/kernels/pso_update.py:120"),
    ("k3", "delta_encode", "src/repro_torch/csrc/delta_codec.cu",
     "src/repro/codec/kernels.py:91"),
    ("k3b", "delta_encode_batched", "src/repro_torch/csrc/delta_codec.cu",
     "src/repro/codec/kernels.py:160"),
    ("k4", "delta_decode", "src/repro_torch/csrc/delta_codec.cu",
     "src/repro/codec/kernels.py:130"),
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
    from repro_torch.codec import kernels as ck
    from repro_torch.codec import rate
    from repro_torch.codec import ref as cref
    from repro_torch.codec import wire
    from repro_torch.core.camera import BACKGROUND_DEPTH
    from repro_torch.kernels import _build
    from repro_torch.kernels import hand_spheres
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels import pso_update as pu
    from repro_torch.kernels import render_score as rs

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = phase_card(torch)
    phase_build(_build)

    seq, cfg = configs()
    frames, truth = rgbd.render_sequence(seq, device=device)
    check(frames.shape == (seq.num_frames, seq.camera.height, seq.camera.width)
          and bool(torch.isfinite(frames).all()), "rendered sequence is malformed")
    inputs = _population(torch, hm, cfg.camera, truth, frames, cfg.pso.num_particles,
                         device, seed=1)
    k1_err = phase_k1(torch, rs, inputs)
    k2_err = phase_k2(torch, pu, device)
    fk_err = phase_fk(torch, hm, hand_spheres,
                      _particles(torch, hm, truth[0], cfg.pso.num_particles, device, seed=1))
    phase_eval_agrees(tracker_mod, _particles(torch, hm, truth[0], 16, device, seed=4),
                      frames, truth)
    launches, paths = phase_main_path(torch, tracker_mod, rs, pu, frames, truth, device)
    profiled = phase_profile(torch, tracker_mod, frames, truth, device, paths)
    log("[frame] " + json.dumps({label: {**paths[label], "profile": profiled[label]}
                                 for label in ("graph", "eager")}))
    kernels = phase_timing(torch, rs, pu, inputs, device, k1_err, k2_err, fk_err, launches)

    for key in ck.launches:
        ck.launches[key] = 0
    decoded, densities = phase_uplink(torch, cref, wire, frames)
    torch.cuda.synchronize()
    launches.update({"k3": ck.launches["delta_encode"],
                     "k3b": ck.launches["delta_encode_batched"],
                     "k4": ck.launches["delta_decode"],
                     "k3_recon": ck.launches["delta_encode_recon"],
                     "k4_pair": ck.launches["delta_decode_pair"]})
    mask_only = ck.launches["delta_encode_mask_only"]
    log(f"[uplink] launches: K3 {launches['k3']} ({launches['k3_recon']} with the "
        f"reconstruction, by the stream encoder), K3b {launches['k3b']} ({mask_only} "
        f"mask-only, by change_density), K4 {launches['k4']} ({launches['k4_pair']} with two "
        f"outputs, by the stream decoder)")
    check(min(launches["k3"], launches["k3b"], launches["k4"]) > 0,
          "a kernel of the uplink path was not launched")
    check(mask_only == launches["k3b"] == len(densities),
          f"change_density launched K3b mask-only {mask_only} times, expected {len(densities)}")
    check(launches["k3_recon"] == launches["k3"] and launches["k4_pair"] == launches["k4"],
          "the stream machines launched a K3 without the reconstruction or a K4 with one "
          "output: the encoder must launch no K4, the decoder no copy after K4")
    errs = phase_codec_kernels(torch, ck, frames, densities, device)

    # the quantized uplink and its entropy stage, on a clip with 2 mm noise
    # and on the same clip without noise (rendered before the counts reset)
    lo, hi = 0.0, BACKGROUND_DEPTH
    clean, _ = rgbd.render_sequence(dataclasses.replace(seq, noise_std=0.0), device=device)
    torch.cuda.synchronize()
    for key in ck.launches:
        ck.launches[key] = 0
    _, encoded, keyframes = phase_quant_uplink(torch, ck, cref, wire, frames, lo, hi)
    clips = {"noise 2 mm": frames, "noise-free": clean}
    _, residuals = phase_entropy(torch, ck, cref, wire, clips)
    torch.cuda.synchronize()
    c = ck.launches
    quant = {"k3_widths": c["delta_encode_widths"], "k6_recon": c["quantize_pack_recon"],
             "quant_encode": c["quant_encode"], "quant_decode": c["quant_decode"]}
    # the standalone launches of K3, K5, K6 and K7 (the flagged ones are
    # counted under K3's and K6's names too)
    standalone = {"k3": c["delta_encode"] - c["delta_encode_widths"],
                  "k5": c["significant_bit_widths"],
                  "k6": c["quantize_pack"] - c["quantize_pack_recon"],
                  "k7": c["unpack_dequantize"]}
    named = ("delta_encode", "delta_encode_widths", "significant_bit_widths", "quantize_pack",
             "quantize_pack_recon", "unpack_dequantize", "quant_encode", "quant_decode")
    others = sum(v for k, v in c.items() if k not in named)
    residual_planes = sum(clip.shape[0] - 1 for clip in clips.values())
    log(f"[quant] launches on the quantized uplink and entropy stage: one-launch encode "
        f"{quant['quant_encode']} and decode {quant['quant_decode']} (one each a delta frame), "
        f"the keyframe launch {quant['k6_recon']} (K6 writing K7's reconstruction), K3 with "
        f"the widths {quant['k3_widths']} (the entropy stage's residuals); standalone K3 "
        f"{standalone['k3']}, K5 {standalone['k5']}, K6 {standalone['k6']}, K7 "
        f"{standalone['k7']}; {others} others")
    check(min(quant.values()) > 0, "a kernel of the quantized uplink path was not launched")
    check(quant["quant_encode"] == quant["quant_decode"] == len(encoded)
          and quant["k6_recon"] == len(QUANT_BITS) and quant["k3_widths"] == residual_planes
          and not any(standalone.values()) and others == 0,
          f"encode_frame and decode_frame must be one launch a delta frame ({len(encoded)}), "
          f"the keyframe one launch for each of the {len(QUANT_BITS)} keyframes, and the "
          f"entropy stage one K3 with the widths a residual ({residual_planes}), with no "
          f"standalone K3, K5, K6 or K7: got {quant}, standalone {standalone}, {others} other "
          f"launches")
    launches["k3"] += c["delta_encode"]
    launches.update({"k5": standalone["k5"], "k6": c["quantize_pack"],
                     "k7": standalone["k7"], **quant})
    def merge(new_errs):  # the largest error of each kernel over the phases
        for key, err in new_errs.items():
            errs[key] = max(errs.get(key, 0.0), err)

    merge(phase_path_compositions(torch, ck, wire, keyframes, residuals, frames[0], lo, hi))
    phase_encode_masks(torch, ck, cref, wire, encoded, lo, hi)
    merge(phase_fused_shapes(torch, ck, cref, wire, device, lo, hi))
    merge(phase_quant_kernels(torch, ck, cref, frames, device))
    fit, cpu_fit = phase_calibration(torch, ck, wire, rate, rgbd)

    step_launches, step_inputs, step_errs = phase_batched_step(
        torch, hm, tracker_mod, ops_mod, rs, pu, ck, wire, decoded, truth, device, lo, hi)
    launches["k3b"] += step_launches.pop("k3b")
    launches.update(step_launches)
    merge(step_errs)
    timing = phase_slice2_timing(torch, rs, pu, ck, frames, step_inputs, device)
    timing.update(phase_slice3_timing(torch, ck, frames, step_inputs, device, lo, hi))
    timing.update(phase_fused_timing(torch, ck, cref, wire, frames, step_inputs, device, lo,
                                     hi))
    timing["k4"]["sizes"] = timing.pop("k4_sizes")
    grid = phase_offload(torch, rs, pu, device, card)
    def counts():
        return (rs.launches, rs.launches_batched, pu.launches, pu.launches_batched,
                dict(ck.launches))

    before = counts()
    phase_fleet(fit, cpu_fit, grid["processed"], card)
    check(counts() == before, "the fleet phase launched a kernel: it is host code")
    timed = phase_llm(torch, card)
    check(counts() == before, "the LLM phase launched a kernel: its products are "
          "torch.matmul/einsum")
    timed.update(phase_train(torch, card))
    check(counts() == before, "the training phase launched a kernel: its products are "
          "torch.matmul/einsum, its optimizer elementwise torch ops")
    sharded = phase_mesh(torch, tracker_mod, rs, pu, frames, truth, card, timed)
    for row, key in zip(kernels, ("k1", "k2")):
        row["launches_by_path"] = {"tracker": row["launches"], "offload_grid": grid[key],
                                   "sharded_tracker": sharded[key]}
        row["launches"] += grid[key] + sharded[key]
    rows = (SLICE2_KERNELS
            + [(key, name, "src/repro_torch/csrc/quant_codec.cu", replaces)
               for key, name, replaces in SLICE3_KERNELS]
            + FUSED_KERNELS)
    extras = ("mask_only", "composition", "sizes", "k3b_alone")
    for key, name, source, replaces in rows:
        t = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": errs[key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            **{k: t[k] for k in extras if k in t},
            **({"subset_of": SUBSET_OF[key]} if key in SUBSET_OF else {})})
    log(f"[profile] device activities per quantized closed-loop delta frame, old path -> new: "
        + ", ".join(f"{b} bits {a['old']} -> {a['new']}"
                    for b, a in timing["activities_per_frame"].items()))
    check(len(kernels) == 20, f"{len(kernels)} kernels in the kernels line, expected 20")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
