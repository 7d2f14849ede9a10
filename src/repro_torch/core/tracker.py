"""The 4-stage generative 3D hand tracker (paper §3.1, Fig. 2).

Per frame, the optimization happens in 4 consecutive steps, each an
offloadable unit (Multi-Step) or fused into one (Single-Step):

  1. ``preprocess`` — extract the bounding box B around the previous
     solution, mask the observed depth map.
  2. ``spawn``      — initialize the particle swarm around h_t ("particles
     are initialized around the solution of the previous frame").
  3. ``optimize``   — run the PSO generations; the population evaluation
     is the GPGPU-heavy part (the CUDA kernel, or the plain objective).
  4. ``refine``     — select the global best, renormalize the quaternion,
     apply temporal smoothing; emit h_{t+1}.

The serial frame dependency (Fig. 3 category A) lives *outside* this
module: ``track_frame`` maps (h_t, frame) -> h_{t+1}, and whoever drives
it must wait for each frame's result before submitting the next.

The frame is one function of device tensors, ``_frame``, and runs two
ways.  Eagerly it is a Python loop of ops, dispatched one by one: the
CPU's path, and on the card the yardstick the graph is held to
(``make_track_frame(..., capture=False)``).  On the card,
``make_track_frame`` by default builds the frame once and runs it as one
device program a call, as the reference's ``@jax.jit`` frame does: the
first call captures the whole frame (mask, spawn, every generation's K1
and K2, refine) into one ``torch.cuda.CUDAGraph``, and every call copies
its inputs into the graph's static buffers and replays it.  Nothing in
the frame reads a device value on the host or makes a shape that depends
on one, which is what lets it be captured; the frame's one
synchronization is ``Tracker.step`` reading the score at the end.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.core import handmodel, objective, pso
from repro_torch.core.camera import Camera
from repro_torch.core.stages import CLIENT, DataItem, Stage, StagedComputation
from repro_torch.kernels import hand_spheres
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    camera: Camera = dataclasses.field(default_factory=Camera)
    pso: pso.PSOConfig = dataclasses.field(default_factory=pso.PSOConfig)
    pos_range: float = 0.10  # search-box half width around h_t, meters
    quat_range: float = 0.25
    smoothing: float = 0.15  # exponential temporal smoothing on h
    bbox_half_width: float = 0.25  # meters around previous depth (B)
    # Route the evaluation through the render_score kernel wrapper on the
    # CPU too (its plain version there).  On the card it always is.
    use_kernel: bool = False


def _make_eval_fn(
    cfg: TrackerConfig, d_o: torch.Tensor, mask: torch.Tensor
) -> pso.EvalFn:
    if cfg.use_kernel or d_o.is_cuda:
        rays = cfg.camera.rays_flat(d_o.device)
        d_flat, m_flat = d_o.reshape(-1), mask.reshape(-1)

        def eval_fn(hs: torch.Tensor) -> torch.Tensor:
            spheres = hand_spheres.pack_spheres(hs)
            return kernel_ops.render_score(spheres, rays, d_flat, m_flat)

        return eval_fn

    def eval_fn(hs: torch.Tensor) -> torch.Tensor:
        return objective.batched_objective(hs, d_o, cfg.camera, mask)

    return eval_fn


# ---------------------------------------------------------------------------
# The four stages as standalone functions
# ---------------------------------------------------------------------------


def stage_preprocess(
    cfg: TrackerConfig, h_prev: torch.Tensor, depth: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: ROI/bounding-box extraction. Returns (depth, mask)."""
    mask = objective.bounding_box_mask(depth, h_prev[2], cfg.bbox_half_width)
    return depth, mask


def stage_spawn(
    cfg: TrackerConfig, generator: Optional[torch.Generator],
    h_prev: torch.Tensor, eval_fn: pso.EvalFn, draws: Optional[Sequence] = None,
) -> Tuple[pso.SwarmState, torch.Tensor, torch.Tensor]:
    """Stage 2: swarm initialization around h_t. Returns (state, lo, hi).
    ``draws`` replaces the generator's, as ``pso.init_swarm``'s."""
    lo = handmodel.parameter_lower_bounds(h_prev, cfg.pos_range, cfg.quat_range)
    hi = handmodel.parameter_upper_bounds(h_prev, cfg.pos_range, cfg.quat_range)
    state = pso.init_swarm(h_prev, lo, hi, eval_fn, cfg.pso, generator=generator,
                           draws=draws)
    return state, lo, hi


def stage_optimize(
    cfg: TrackerConfig,
    state: pso.SwarmState,
    lo: torch.Tensor,
    hi: torch.Tensor,
    eval_fn: pso.EvalFn,
    generator: Optional[torch.Generator],
    draws: Optional[Sequence] = None,
) -> pso.SwarmState:
    """Stage 3: the PSO generations — the GPGPU-heavy step.  Each
    generation's update renormalizes the quaternion in the same launch
    (``handmodel.normalize_configuration`` fused into K2).  ``draws``, one
    entry a generation, replaces the generator's, as
    ``pso.swarm_step``'s."""
    for g in range(cfg.pso.num_generations):
        state = pso.swarm_step(
            state, lo, hi, eval_fn, cfg.pso, generator=generator,
            draws=None if draws is None else draws[g], project_quaternion=True,
        )
    return state


def stage_refine(
    cfg: TrackerConfig, state: pso.SwarmState, h_prev: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 4: decode the solution + temporal smoothing."""
    h = handmodel.normalize_configuration(state.global_best)
    h = (1.0 - cfg.smoothing) * h + cfg.smoothing * h_prev
    h = handmodel.normalize_configuration(h)
    return h, state.global_best_score


# ---------------------------------------------------------------------------
# Fused per-frame step (Single-Step granularity)
# ---------------------------------------------------------------------------


def make_track_frame(
    cfg: TrackerConfig, device: torch.device | str = "cuda",
    capture: Optional[bool] = None,
) -> Callable:
    """Build the (generator, h_prev, depth) -> (h_next, score) step on
    ``device``.  ``generator`` is a ``torch.Generator`` on that device;
    h_prev and depth may be tensors or arrays, and are moved there.  The
    step's ``draws`` = (spawn draws, one entry a generation) replaces the
    generator's draws: the parity tests feed the reference's through it.

    ``capture=None`` captures the frame into a CUDA graph on a CUDA
    device and runs it eagerly on the CPU; ``capture=True`` asks for the
    graph (a ``ValueError`` on the CPU), ``capture=False`` for the eager
    step on any device.  The graph and the eager step give the same bits
    on the same draws (``FrameGraphs`` says what the graph asks of its
    callers)."""
    device = torch.device(device)
    if capture is None:
        capture = device.type == "cuda"
    if not capture:
        return _track_frame_fn(cfg, device, lambda eval_fn: eval_fn)
    if device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device, not {device}")
    return FrameGraphs(cfg, device)


def make_track_frame_sharded(
    cfg: TrackerConfig, mesh, axis: str = "model", device: torch.device | str = "cuda"
) -> Callable:
    """Distributed variant: the particle population is sharded over a mesh
    axis (the paper's GPGPU parallel axis mapped onto the mesh's
    devices) through ``pso.sharded_eval``.  Every rank runs the same step
    on the same frame and draws (a generator seeded alike on each rank, or
    ``draws``), so the swarm stays replicated; the scores' all-gather is
    the step's one collective.  It runs eagerly."""
    return _track_frame_fn(cfg, torch.device(device),
                           lambda eval_fn: pso.sharded_eval(eval_fn, mesh, axis))


def _frame(cfg: TrackerConfig, wrap_eval, generator: Optional[torch.Generator],
           h_prev: torch.Tensor, depth: torch.Tensor, draws=None):
    """One frame on device tensors: the body that the eager step runs and
    that the graph captures.  Each stage is a ``torch.profiler`` range
    while a session records, which names its kernels on the eager paths
    (a replay runs no Python, so a graph's stages show only in its
    warm-up and capture)."""
    with obs.ranged("stage.preprocess"):
        d_o, mask = stage_preprocess(cfg, h_prev, depth)
        eval_fn = wrap_eval(_make_eval_fn(cfg, d_o, mask))
    spawn, gens = (None, None) if draws is None else draws
    with obs.ranged("stage.spawn"):
        state, lo, hi = stage_spawn(cfg, generator, h_prev, eval_fn, spawn)
    with obs.ranged("stage.optimize"):
        state = stage_optimize(cfg, state, lo, hi, eval_fn, generator, gens)
    with obs.ranged("stage.refine"):
        return stage_refine(cfg, state, h_prev)


def _track_frame_fn(cfg: TrackerConfig, device: torch.device, wrap_eval) -> Callable:
    def track_frame(generator: Optional[torch.Generator], h_prev, depth, draws=None):
        h_prev = torch.as_tensor(h_prev, dtype=torch.float32, device=device)
        depth = torch.as_tensor(depth, dtype=torch.float32, device=device)
        return _frame(cfg, wrap_eval, generator, h_prev, depth, draws)

    return track_frame


# ---------------------------------------------------------------------------
# The frame as one CUDA graph
# ---------------------------------------------------------------------------

def _draw_layout(draws) -> Tuple:
    """The shapes of ``draws`` = (spawn draws, one entry a generation)."""
    spawn, gens = draws
    return (tuple(tuple(u.shape) for u in spawn),
            tuple(tuple(tuple(u.shape) for u in g) for g in gens))


class FrameInputs:
    """A frame's static inputs on ``device``: h_prev (27,), the depth map
    and, when the frame is given its draws, every draw in one flat buffer
    that the frame reads through views.  ``load`` copies a call's inputs
    into them in place; ``run`` runs the frame on them."""

    def __init__(self, cfg: TrackerConfig, device: torch.device,
                 depth_shape: Sequence[int], draws=None):
        self.cfg = cfg
        self.h_prev = torch.zeros(handmodel.NUM_PARAMS, dtype=torch.float32, device=device)
        self.depth = torch.zeros(tuple(depth_shape), dtype=torch.float32, device=device)
        self.layout = None if draws is None else _draw_layout(draws)
        self.draws = None
        if self.layout is not None:
            spawn, gens = self.layout
            shapes = [*spawn, *(s for g in gens for s in g)]
            sizes = [math.prod(s) for s in shapes]
            self.flat = torch.zeros(sum(sizes), dtype=torch.float32, device=device)
            views = iter([v.view(s) for v, s in zip(self.flat.split(sizes), shapes)])
            self.draws = (tuple(next(views) for _ in spawn),
                          [tuple(next(views) for _ in g) for g in gens])

    def load(self, h_prev, depth, draws=None) -> None:
        """Copy a call's inputs into the buffers.  Raises ``ValueError``
        on a shape other than the buffers'."""
        h_prev = torch.as_tensor(h_prev, dtype=torch.float32)
        depth = torch.as_tensor(depth, dtype=torch.float32)
        if tuple(h_prev.shape) != tuple(self.h_prev.shape):
            raise ValueError(f"h_prev has shape {tuple(h_prev.shape)}, expected "
                             f"{tuple(self.h_prev.shape)}")
        if depth.shape != self.depth.shape:
            raise ValueError(f"depth has shape {tuple(depth.shape)}; this frame was "
                             f"built for {tuple(self.depth.shape)}")
        if (draws is None) != (self.layout is None):
            raise ValueError("this frame was built to draw from the generator" if draws
                             is not None else "this frame was built to be given its draws")
        self.h_prev.copy_(h_prev)
        self.depth.copy_(depth)
        if draws is not None:
            if _draw_layout(draws) != self.layout:
                raise ValueError(f"draws of shapes {_draw_layout(draws)}; this frame was "
                                 f"built for {self.layout}")
            spawn, gens = draws
            self.flat.copy_(torch.cat([
                torch.as_tensor(u, dtype=torch.float32, device=self.flat.device).reshape(-1)
                for u in [*spawn, *(u for g in gens for u in g)]]))

    def run(self, generator: Optional[torch.Generator]):
        """The frame on the buffers: (h_next, score)."""
        return _frame(self.cfg, lambda eval_fn: eval_fn, generator, self.h_prev,
                      self.depth, self.draws)


class _FrameGraph:
    """One frame captured into a CUDA graph, for one mode: drawn from
    ``generator``, or given its draws (``generator`` None).  The graph's
    first and last nodes record two timing events, which ``obs`` reads
    for the replay's device time."""

    def __init__(self, cfg: TrackerConfig, device: torch.device,
                 generator: Optional[torch.Generator], h_prev, depth, draws):
        with obs.span("capture"):
            depth = torch.as_tensor(depth)
            self.generator = generator if draws is None else None
            self.inputs = FrameInputs(cfg, device, depth.shape, draws)
            self.inputs.load(h_prev, depth, draws)
            # Warm-up, eagerly on a side stream: builds and loads the kernel
            # library, the hand geometry's constants and the allocator's
            # blocks, none of which may happen inside the capture.  It draws
            # from a generator of its own, so the caller's does not move.
            with obs.span("capture.warmup") as warmup:
                warm_gen = (None if draws is not None
                            else torch.Generator(device=device).manual_seed(0))
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    self.inputs.run(warm_gen)
                torch.cuda.current_stream(device).wait_stream(side)
                # the events are created by a first record outside the capture
                self.started, self.ended = (torch.cuda.Event(enable_timing=True, external=True)
                                            for _ in range(2))
                self.started.record()
                self.ended.record()
                torch.cuda.synchronize(device)
            with obs.span("capture.record") as record:
                self.graph = torch.cuda.CUDAGraph(keep_graph=True)
                if draws is None and generator is not None:  # the default one registers itself
                    self.graph.register_generator_state(generator)
                with torch.cuda.graph(self.graph):
                    self.started.record()
                    self.h_next, self.score = self.inputs.run(generator)
                    self.ended.record()
            with obs.span("capture.instantiate") as instantiate:
                self.graph.instantiate()
                torch.cuda.synchronize(device)
        obs.count("frame.captures")
        self.cost_ms = {"warmup": warmup.ms, "capture": record.ms,
                        "instantiate": instantiate.ms}

    def __call__(self, generator, h_prev, depth, draws):
        if draws is None and generator is not self.generator:
            raise ValueError("this frame's graph draws from the generator it was captured "
                             "with; build another step for another generator")
        obs.frame(lambda: self.inputs.load(h_prev, depth, draws), self.graph.replay,
                  (self.started, self.ended))
        return self.h_next.clone(), self.score.clone()


class FrameGraphs:
    """The frame as one CUDA graph a call: the counterpart of the
    reference's ``@jax.jit`` ``track_frame``, with its call signature.

    One graph draws from a generator, another is given its draws; each is
    captured at its first use, or ahead of it by ``capture``.  A graph is
    tied to what it captured: a depth or draws of another shape, or
    another generator, raises ``ValueError`` (it is never recaptured
    silently).  A failed capture or replay raises CUDA's error.  Each
    call returns fresh tensors, which no later replay overwrites.

    Each call is a frame row of ``repro_torch.obs``: the host's input
    copies (``frame.load``) and its enqueue of the replay
    (``frame.launch``), and the replay's device time, sampled from the
    graph's own timing events; it counts ``frame.replays``.  A capture is
    a ``capture`` span holding the spans ``capture.warmup``,
    ``capture.record`` and ``capture.instantiate``, and counts
    ``frame.captures``; ``capture`` returns those three in ms of host
    time.  The kernel wrappers' ``launches`` count the launches they make,
    the warm-up's and the capture's, never a replay's; the card's own
    records count a replay's K1 and K2 (N + 1 and N a frame of N
    generations; ``kernels._build.kernel_runs``)."""

    def __init__(self, cfg: TrackerConfig, device: torch.device):
        self.cfg, self.device = cfg, device
        self._graphs: Dict[bool, _FrameGraph] = {}

    def capture(self, generator: Optional[torch.Generator], h_prev, depth,
                draws=None) -> Dict[str, float]:
        """Capture the graph of this call's mode without running a frame
        (the generator does not move); returns its one-time cost."""
        given = draws is not None
        if given in self._graphs:
            raise ValueError("this mode's graph is captured already")
        self._graphs[given] = _FrameGraph(self.cfg, self.device, generator, h_prev, depth,
                                          draws)
        return self._graphs[given].cost_ms

    def __call__(self, generator: Optional[torch.Generator], h_prev, depth, draws=None):
        given = draws is not None
        if given not in self._graphs:
            self.capture(generator, h_prev, depth, draws)
        return self._graphs[given](generator, h_prev, depth, draws)


class Tracker:
    """Stateful convenience wrapper holding h_t across frames."""

    def __init__(self, cfg: TrackerConfig, h0=None, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.h = (handmodel.default_pose(device=self.device) if h0 is None
                  else torch.as_tensor(h0, dtype=torch.float32, device=self.device))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._step = make_track_frame(cfg, self.device)

    def step(self, depth) -> Tuple[torch.Tensor, float]:
        self.h, score = self._step(self.generator, self.h, depth)
        return self.h, float(score)


# ---------------------------------------------------------------------------
# Byte/FLOP-annotated staged description (for the offload engine)
# ---------------------------------------------------------------------------


def _eval_flops_per_generation(cfg: TrackerConfig) -> float:
    """Analytic FLOP count of one population evaluation.

    Per (particle, pixel, sphere): dot products + discriminant + sqrt
    ~= 14 fused ops; the min-reduction and scoring add ~3 per (particle,
    pixel). See csrc/render_score.cu for the exact expression the
    kernel evaluates."""
    n = cfg.pso.num_particles
    p = cfg.camera.num_pixels
    s = handmodel.NUM_SPHERES
    fk_flops = n * 600.0 * 5  # forward kinematics per particle (tiny)
    return n * p * (s * 14.0 + 3.0) + fk_flops


def build_staged(
    cfg: TrackerConfig, frame_nbytes: Optional[int] = None
) -> StagedComputation:
    """The Fig. 2 pipeline with measured byte sizes and analytic FLOPs.

    ``frame_nbytes`` overrides the size of the sensor frame that crosses
    the network (the paper ships RGB + depth at sensor resolution while
    hypotheses are rendered at a reduced working resolution; see
    sim/hardware.py PAPER_FRAME_BYTES)."""
    cam = cfg.camera
    n, d = cfg.pso.num_particles, handmodel.NUM_PARAMS
    frame_bytes = (
        frame_nbytes if frame_nbytes is not None else cam.num_pixels * 4
    )
    # ROI items are at the tracker's *working* resolution regardless of
    # the sensor frame size that crosses the network.
    roi_bytes = cam.num_pixels * 4
    mask_bytes = cam.num_pixels  # bool mask
    h_bytes = d * 4
    swarm_bytes = (3 * n * d + 2 * n + d + 1 + 2) * 4  # SwarmState payload

    gens = cfg.pso.num_generations
    eval_flops = _eval_flops_per_generation(cfg)

    sources = (
        DataItem("frame_depth", frame_bytes, CLIENT),
        DataItem("h_prev", h_bytes, CLIENT),
        DataItem("rng_key", 8, CLIENT),
    )
    stages = (
        Stage(
            name="preprocess",
            flops=cam.num_pixels * 4.0,
            inputs=("frame_depth", "h_prev"),
            outputs=(
                DataItem("roi_depth", roi_bytes),
                DataItem("roi_mask", mask_bytes),
            ),
            parallel_fraction=0.5,
        ),
        Stage(
            name="spawn",
            # init includes one population evaluation (scores of gen 0)
            flops=n * d * 8.0 + eval_flops,
            inputs=("rng_key", "h_prev", "roi_depth", "roi_mask"),
            outputs=(DataItem("swarm_state", swarm_bytes),),
            parallel_fraction=0.95,
        ),
        Stage(
            name="optimize",
            flops=gens * (eval_flops + n * d * 12.0),
            inputs=("swarm_state", "roi_depth", "roi_mask"),
            outputs=(DataItem("swarm_final", swarm_bytes),),
            parallel_fraction=0.98,
        ),
        Stage(
            name="refine",
            flops=d * 30.0,
            inputs=("swarm_final", "h_prev"),
            outputs=(DataItem("h_next", h_bytes), DataItem("score", 4)),
            parallel_fraction=0.0,
        ),
    )
    comp = StagedComputation(
        name="hand_tracker_frame",
        sources=sources,
        stages=stages,
        results=("h_next", "score"),
    )
    comp.validate()
    return comp
