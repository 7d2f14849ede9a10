"""The edge serving simulator: the paper's experiments, end to end.

Two fidelities:

* ``analytic_run`` — pure cost-model playback: per-frame loop times are
  drawn from the offload plan (resampling the exact latency legs the
  cost engine recorded, so link jitter is reproduced leg-for-leg), fed
  through the Fig. 3 frame-drop accounting. Generates Fig. 4 / Fig. 5.

* ``executed_run`` — *actually executes* the port's tracker on a
  synthetic RGBD sequence, on the device it is given, while charging
  simulated time for network/wrapper legs.  Tracker output is what local
  execution gives (the data never really leaves the device); the clock
  reflects the modeled deployment, so its fps and drop rate are the cost
  model's prediction for the modelled tiers, not the device's speed.
  This couples frame drops to tracking quality: dropped frames widen the
  inter-frame motion the PSO must cover, exactly the degradation path the
  paper describes.

Both fidelities accept either the two-tier ``Environment`` shim or a
full multi-tier ``Topology`` — placement and cost arithmetic live in
``core.costengine`` either way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import offload, tracker
from repro_torch.core.offload import PlanReport, Policy, Topology
from repro_torch.core.stages import StagedComputation
from repro_torch.sim.clock import FrameLoop, LoopStats

EnvironmentLike = offload.EnvironmentLike


@dataclasses.dataclass
class SimResult:
    stats: LoopStats
    plan: PlanReport
    policy: Policy
    network: str
    granularity: str

    @property
    def fps(self) -> float:
        """Sustainable loop rate 1/loop_time — the paper's Fig. 4/5 metric
        (the server's native rate exceeds the camera's 30 Hz, so the
        figures report the loop rate, not camera-capped throughput)."""
        lt = self.stats.mean_loop_time
        return 1.0 / lt if lt > 0 else 0.0

    @property
    def camera_capped_fps(self) -> float:
        """Frames actually processed per second against a 30 Hz camera."""
        return self.stats.achieved_fps


def _network_name(env: EnvironmentLike) -> str:
    """Label for reports: the shim's link name, or the topology's links."""
    if isinstance(env, Topology):
        return "+".join(l.name for l in env.links.values())
    return env.link.name


def analytic_run(
    comp: StagedComputation,
    env: EnvironmentLike,
    policy: Policy,
    granularity: str = "single_step",
    num_frames: int = 300,
    seed: int = 0,
) -> SimResult:
    """Cost-model playback of one experimental configuration."""
    if granularity == "single_step":
        comp_used = comp.fused()
    elif granularity == "multi_step":
        comp_used = comp
    else:
        raise ValueError(granularity)
    rep = offload.plan(comp_used, env, policy)
    rng = np.random.default_rng(seed)
    loop = FrameLoop()
    stats = loop.run(
        lambda i, gap: rep.jittered_total(rng), num_frames
    )
    return SimResult(stats, rep, policy, _network_name(env), granularity)


@dataclasses.dataclass
class TrackingResult:
    sim: SimResult
    mean_pos_error: float  # meters, over processed frames
    mean_angle_error: float  # radians
    track_lost_frames: int  # frames with pos error > 5 cm


def executed_run(
    cfg: tracker.TrackerConfig,
    env: EnvironmentLike,
    policy: Policy,
    depth_frames,  # (T, H, W) observed depth sequence, tensor or array
    truth,  # (T, 27) ground-truth configurations, tensor or array
    granularity: str = "single_step",
    seed: int = 0,
    timing_comp: Optional[StagedComputation] = None,
    device: torch.device | str = "cuda",
) -> TrackingResult:
    """Execute the tracker under simulated deployment conditions.

    The frame-drop accounting decides *which* frames get processed; the
    tracker then really processes exactly those frames, so slow loops
    degrade quality through the physics of the sequence, not through a
    fudge factor.

    ``timing_comp`` lets the clock charge a different (e.g. paper-scale)
    workload than the one executed — examples run a reduced-resolution
    tracker for CPU tractability while the simulated deployment charges
    the full workload the tiers were calibrated against.

    The tracker runs on ``device`` (frames and truth are moved there)
    with a ``torch.Generator`` on it seeded by ``seed``; the plan, the
    numpy jitter stream and the frame loop are the reference's, so the
    same frames are processed as there.
    """
    comp = timing_comp or tracker.build_staged(cfg)
    comp_used = comp.fused() if granularity == "single_step" else comp
    rep = offload.plan(comp_used, env, policy)
    rng = np.random.default_rng(seed)

    loop = FrameLoop()
    stats = loop.run(
        lambda i, gap: rep.jittered_total(rng),
        int(depth_frames.shape[0]),
    )

    device = torch.device(device)
    depth_frames = torch.as_tensor(depth_frames, dtype=torch.float32, device=device)
    truth = torch.as_tensor(truth, dtype=torch.float32, device=device)
    step = tracker.make_track_frame(cfg, device)
    generator = torch.Generator(device).manual_seed(seed)
    h = truth[0]
    pos_errs: List[float] = []
    ang_errs: List[float] = []
    lost = 0
    for ev in stats.processed:
        h, _ = step(generator, h, depth_frames[ev.index])
        gt = truth[ev.index]
        pe = float(torch.linalg.vector_norm(h[:3] - gt[:3]))
        ae = float(torch.mean(torch.abs(h[7:] - gt[7:])))
        pos_errs.append(pe)
        ang_errs.append(ae)
        if pe > 0.05:
            lost += 1
    sim = SimResult(stats, rep, policy, _network_name(env), granularity)
    return TrackingResult(
        sim=sim,
        mean_pos_error=float(np.mean(pos_errs)) if pos_errs else float("nan"),
        mean_angle_error=float(np.mean(ang_errs)) if ang_errs else float("nan"),
        track_lost_frames=lost,
    )


def experiment_grid(
    comp: StagedComputation,
    environments: Dict[str, EnvironmentLike],
    policies: Tuple[Policy, ...] = (Policy.FORCED, Policy.AUTO),
    granularities: Tuple[str, ...] = ("single_step", "multi_step"),
    num_frames: int = 300,
) -> List[SimResult]:
    """The full Fig. 5 grid: networks x policies x granularities."""
    out = []
    for net_name, env in environments.items():
        for pol in policies:
            for gran in granularities:
                out.append(
                    analytic_run(comp, env, pol, gran, num_frames)
                )
    return out
