"""Particle Swarm Optimization (paper §3.1, "PSO").

Canonical Clerc–Kennedy constriction PSO: particles keep a position and
velocity; each is pulled towards its personal best and the swarm's
global best.  The objective is a black-box population evaluator
``(N, D) -> (N,)`` — the part the paper runs on the GPGPU.

The velocity/position update goes through the fused kernel
``kernels.pso_update`` (CUDA on the card, its plain version on the
CPU); ``swarm_step(project_quaternion=True)`` has that launch
renormalize the quaternion columns too, which the tracker's generation would otherwise
run as a ``project_fn`` of several eager kernels.  A generation keeps
everything on the device: the argmin, the best-of gathers and the
restart scatter are tensor ops, so a run of generations never waits
for the host.

Randomness: the uniform draws come from a ``torch.Generator`` on the
run's device, or from a ``draws`` argument — the parity tests feed the
reference's own ``jax.random`` draws through it, since torch cannot
reproduce JAX's threefry streams.  Both ways run inside a CUDA graph
(``core.tracker.FrameGraphs``): a generator registered with the graph
advances at each replay as it would eagerly, and ``_as_draw`` reads a
draw that is already a float32 tensor on the device in place, so a
graph's static draw buffers are read without a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import pso_update as _pso_kernel

EvalFn = Callable[[torch.Tensor], torch.Tensor]  # (N, D) -> (N,)


@dataclasses.dataclass(frozen=True)
class PSOConfig:
    num_particles: int = 64
    num_generations: int = 30
    # Clerc-Kennedy constriction coefficients (paper ref [21]).
    inertia: float = 0.7298
    cognitive: float = 1.49618
    social: float = 1.49618
    # Fraction of the search-box size used to cap |velocity|.
    velocity_clip: float = 0.5
    # Re-randomize this fraction of the worst particles each generation
    # (stochastic restart — keeps the swarm exploring under fast motion).
    restart_fraction: float = 0.0


class SwarmState(NamedTuple):
    positions: torch.Tensor  # (N, D)
    velocities: torch.Tensor  # (N, D)
    personal_best: torch.Tensor  # (N, D)
    personal_best_score: torch.Tensor  # (N,)
    global_best: torch.Tensor  # (D,)
    global_best_score: torch.Tensor  # ()


def swarm_state_from_numpy(
    positions: np.ndarray,
    velocities: np.ndarray,
    personal_best: np.ndarray,
    personal_best_score: np.ndarray,
    global_best: np.ndarray,
    global_best_score: np.ndarray,
    *,
    device: torch.device | str = "cuda",
) -> SwarmState:
    """A swarm given as numpy arrays — e.g. the reference's ``SwarmState``
    fields through ``np.asarray`` — as float32 tensors on ``device``."""
    fields = (positions, velocities, personal_best, personal_best_score,
              global_best, global_best_score)
    return SwarmState(*(
        torch.as_tensor(np.array(f, dtype=np.float32), device=device) for f in fields
    ))


def _uniform(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def _as_draw(u, like: torch.Tensor) -> torch.Tensor:
    """u as a tensor like ``like``: u itself when it already is one."""
    return torch.as_tensor(u, dtype=like.dtype, device=like.device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for a 0-dim index tensor, as a gather on the device (plain
    indexing with a tensor scalar would read it on the host)."""
    return torch.index_select(x, 0, idx.reshape(1)).squeeze(0)


def init_swarm(
    center: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    eval_fn: EvalFn,
    config: PSOConfig,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence] = None,
) -> SwarmState:
    """Particles initialized uniformly in [lo, hi] around `center`; particle
    0 is pinned to `center` itself (the previous frame's solution), which
    guarantees tracking never regresses below the motion-continuity prior.

    ``draws`` = (u_pos, u_vel), two (N, D) uniforms, replaces the
    generator's draws.
    """
    n = config.num_particles
    d = center.shape[-1]
    if draws is None:
        u_pos = _uniform((n, d), center, generator)
        u_vel = _uniform((n, d), center, generator)
    else:
        u_pos, u_vel = (_as_draw(u, center) for u in draws)
    span = hi - lo
    positions = lo + u_pos * span
    positions = torch.cat([center[None], positions[1:]])
    velocities = (u_vel - 0.5) * span * 0.1
    scores = eval_fn(positions)
    best_idx = torch.argmin(scores)  # first occurrence on ties
    return SwarmState(
        positions=positions,
        velocities=velocities,
        personal_best=positions,
        personal_best_score=scores,
        global_best=_take(positions, best_idx),
        global_best_score=_take(scores, best_idx),
    )


def swarm_step(
    state: SwarmState,
    lo: torch.Tensor,
    hi: torch.Tensor,
    eval_fn: EvalFn,
    config: PSOConfig,
    project_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence] = None,
    project_quaternion: bool = False,
) -> SwarmState:
    """One PSO generation: velocity update, move, clamp, evaluate, rebest.

    ``draws`` = (r1, r2) or (r1, r2, u_restart) replaces the generator's
    draws: r1, r2 are (N, D) uniforms, u_restart (n_restart, D).
    ``project_quaternion`` renormalizes the quaternion columns of the
    moved positions inside the update's launch, as ``project_fn=
    handmodel.normalize_configuration`` does; give one or the other.  Either way the restart's fresh rows come after
    the projection and stay unprojected, as in the reference.
    """
    if project_fn is not None and project_quaternion:
        raise ValueError("give project_fn or project_quaternion, not both")
    n, d = state.positions.shape
    x = state.positions
    if draws is None:
        r1 = _uniform((n, d), x, generator)
        r2 = _uniform((n, d), x, generator)
    else:
        r1, r2 = _as_draw(draws[0], x), _as_draw(draws[1], x)
    consts = dict(inertia=config.inertia, cognitive=config.cognitive,
                  social=config.social, velocity_clip=config.velocity_clip)
    args = (x, state.velocities, state.personal_best, state.global_best, r1, r2, lo, hi)
    if project_quaternion:
        pos, vel = _pso_kernel.pso_update_projected(*args, **consts)
    else:
        pos, vel = _pso_kernel.pso_update(*args, **consts)
    if project_fn is not None:
        pos = project_fn(pos)

    if config.restart_fraction > 0.0:
        n_restart = max(1, int(n * config.restart_fraction))
        worst = torch.argsort(state.personal_best_score, stable=True)[-n_restart:]
        if draws is None:
            u = _uniform((n_restart, d), x, generator)
        else:
            u = _as_draw(draws[2], x)
        pos = pos.index_copy(0, worst, lo + u * (hi - lo))

    scores = eval_fn(pos)
    improved = scores < state.personal_best_score
    pbest = torch.where(improved[:, None], pos, state.personal_best)
    pbest_score = torch.where(improved, scores, state.personal_best_score)
    gidx = torch.argmin(pbest_score)
    return SwarmState(pos, vel, pbest, pbest_score, _take(pbest, gidx),
                      _take(pbest_score, gidx))


def run(
    center: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    eval_fn: EvalFn,
    config: PSOConfig,
    project_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full PSO search. Returns (best_position (D,), best_score ())."""
    state = init_swarm(center, lo, hi, eval_fn, config, generator=generator)
    for _ in range(config.num_generations):
        state = swarm_step(state, lo, hi, eval_fn, config, project_fn,
                           generator=generator)
    return state.global_best, state.global_best_score


def run_chunked(
    center: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    eval_fn: EvalFn,
    config: PSOConfig,
    num_chunks: int,
    project_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[SwarmState, ...]]:
    """PSO split into `num_chunks` host-visible pieces (Multi-Step offload:
    each chunk is a separately offloadable method whose swarm state crosses
    the client<->server boundary). Returns intermediate states for byte
    accounting by the offload engine."""
    per = max(1, config.num_generations // num_chunks)
    state = init_swarm(center, lo, hi, eval_fn, config, generator=generator)
    states = []
    for _ in range(num_chunks):
        for _ in range(per):
            state = swarm_step(state, lo, hi, eval_fn, config, project_fn,
                               generator=generator)
        states.append(state)
    return state.global_best, state.global_best_score, tuple(states)


def sharded_eval(eval_fn: EvalFn, mesh, axis: str = "model") -> EvalFn:
    """Wrap a population evaluator so particles are sharded over a mesh
    axis — the paper's GPGPU parallelism mapped onto the mesh's devices.
    Every rank holds the whole swarm; rank r of ``axis`` evaluates rows
    [r N/ranks, (r+1) N/ranks) through ``eval_fn`` (K1 on the card), and
    the N scores are all-gathered (tiny: N floats), so the only
    collective in the PSO loop is O(N) bytes.  N must divide by the
    axis' size, as the reference's ``shard_map`` requires."""
    from torch.distributed import _functional_collectives as funcol

    group = mesh.get_group(axis)
    ranks = mesh.size(mesh.mesh_dim_names.index(axis))
    rank = mesh.get_local_rank(axis)

    def _eval(hs: torch.Tensor) -> torch.Tensor:
        n = hs.shape[0]
        if n % ranks:
            raise ValueError(f"{n} particles do not divide over {ranks} ranks of {axis!r}")
        per = n // ranks
        local = eval_fn(hs.narrow(0, rank * per, per))
        return funcol.all_gather_tensor(local.contiguous(), 0, group).wait()

    return _eval
