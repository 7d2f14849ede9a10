"""The port's PSO and its update kernel path against the JAX reference.

torch cannot reproduce JAX's threefry streams, so the parity tests draw
the reference's own uniforms with ``jax.random`` (the same key splits
``repro.core.pso`` makes) and feed them to the port through ``draws``.
Tolerance: 1e-6 (rtol and atol) on the update, as
``tests/test_pso_kernel.py`` holds the Pallas kernel; 1e-5 on states
after several generations, where those differences compound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import handmodel as jhm
from repro.core import pso as jpso
from repro.kernels import pso_ref as jpso_ref
from repro_torch.core import handmodel as thm
from repro_torch.core import pso as tpso
from repro_torch.kernels import pso_update as tkernel

CONSTS = dict(inertia=0.7298, cognitive=1.49618, social=1.49618,
              velocity_clip=0.5)
CPU = torch.device("cpu")


def _update_inputs(n, d, seed=0):
    """numpy (x, v, pbest, gbest, r1, r2, lo, hi)."""
    rng = np.random.default_rng(seed)
    lo = (-np.abs(rng.normal(size=d)) - 0.5).astype(np.float32)
    hi = (np.abs(rng.normal(size=d)) + 0.5).astype(np.float32)
    span = hi - lo
    x = (lo + rng.uniform(size=(n, d)) * span).astype(np.float32)
    v = (rng.normal(size=(n, d)) * 0.5).astype(np.float32)  # some clip
    pb = (lo + rng.uniform(size=(n, d)) * span).astype(np.float32)
    r1, r2 = rng.uniform(size=(2, n, d)).astype(np.float32)
    return x, v, pb, pb[0].copy(), r1, r2, lo, hi


def _quadratic(target):
    t_ref, t_port = jnp.asarray(target), torch.from_numpy(target)
    return (lambda xs: jnp.sum((xs - t_ref) ** 2, axis=-1),
            lambda xs: torch.sum((xs - t_port) ** 2, dim=-1))


def _box(d, seed):
    """(center, lo, hi, target) for a d-dim search around a center."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-0.2, 0.2, d).astype(np.float32)
    if d == 27:
        center[3:7] = [1.0, 0.0, 0.0, 0.0]
    lo, hi = center - 0.3, center + 0.3
    target = (center + rng.uniform(-0.2, 0.2, d)).astype(np.float32)
    return center, lo.astype(np.float32), hi.astype(np.float32), target


def _assert_states_close(port, ref, atol):
    for name in tpso.SwarmState._fields:
        np.testing.assert_allclose(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=atol, atol=atol, err_msg=name)


@pytest.mark.parametrize("n,d", [(8, 32), (16, 27), (13, 27)])
def test_pso_update_plain_matches_reference(n, d):
    args = _update_inputs(n, d, seed=n)
    rx, rv = jpso_ref.pso_update(*(jnp.asarray(a) for a in args), **CONSTS)
    px, pv = tkernel.pso_update(*(torch.from_numpy(a) for a in args), **CONSTS)
    np.testing.assert_allclose(px.numpy(), np.asarray(rx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-6)
    lo, hi = args[6], args[7]
    assert np.all(px.numpy() >= lo) and np.all(px.numpy() <= hi)
    assert np.all(np.abs(pv.numpy()) <= CONSTS["velocity_clip"] * (hi - lo) + 1e-7)


def test_init_swarm_matches_reference_draws():
    n, d = 16, 27
    center, lo, hi, target = _box(d, 1)
    f_ref, f_port = _quadratic(target)
    cfg = tpso.PSOConfig(num_particles=n)
    key = jax.random.PRNGKey(3)
    ref = jpso.init_swarm(key, jnp.asarray(center), jnp.asarray(lo),
                          jnp.asarray(hi), f_ref, jpso.PSOConfig(num_particles=n))
    _, kpos, kvel = jax.random.split(key, 3)
    draws = (np.array(jax.random.uniform(kpos, (n, d))),
             np.array(jax.random.uniform(kvel, (n, d))))
    port = tpso.init_swarm(torch.from_numpy(center), torch.from_numpy(lo),
                           torch.from_numpy(hi), f_port, cfg, draws=draws)
    _assert_states_close(port, ref, 1e-6)
    np.testing.assert_array_equal(port.positions[0].numpy(), center)  # pinned


@pytest.mark.parametrize("restart_fraction", [0.0, 0.25])
def test_swarm_steps_match_reference_draws(restart_fraction):
    """Three generations with the quaternion projection (and, in one
    case, the stochastic restart), fed the reference's draws."""
    n, d = 16, 27
    center, lo, hi, target = _box(d, 2)
    f_ref, f_port = _quadratic(target)
    jcfg = jpso.PSOConfig(num_particles=n, restart_fraction=restart_fraction)
    tcfg = tpso.PSOConfig(num_particles=n, restart_fraction=restart_fraction)
    j_lo, j_hi = jnp.asarray(lo), jnp.asarray(hi)
    ref = jpso.init_swarm(jax.random.PRNGKey(4), jnp.asarray(center), j_lo, j_hi,
                          f_ref, jcfg)
    port = tpso.swarm_state_from_numpy(*(np.asarray(f) for f in ref[:6]), device=CPU)
    n_restart = max(1, int(n * restart_fraction))
    for _ in range(3):
        _, k1, k2, k3 = jax.random.split(ref.key, 4)
        draws = (np.array(jax.random.uniform(k1, (n, d))),
                 np.array(jax.random.uniform(k2, (n, d))),
                 np.array(jax.random.uniform(k3, (n_restart, d))))
        ref = jpso.swarm_step(ref, j_lo, j_hi, f_ref, jcfg,
                              project_fn=jhm.normalize_configuration)
        port = tpso.swarm_step(port, torch.from_numpy(lo), torch.from_numpy(hi),
                               f_port, tcfg, project_fn=thm.normalize_configuration,
                               draws=draws)
        _assert_states_close(port, ref, 1e-5)


def test_argmin_takes_first_of_ties():
    """Equal scores everywhere: the global best is particle 0, the pinned
    center, in the spawn and after a generation."""
    center, lo, hi, _ = _box(5, 3)
    flat = lambda xs: torch.zeros(xs.shape[0])
    cfg = tpso.PSOConfig(num_particles=8)
    gen = torch.Generator().manual_seed(0)
    args = [torch.from_numpy(a) for a in (center, lo, hi)]
    state = tpso.init_swarm(*args, flat, cfg, generator=gen)
    np.testing.assert_array_equal(state.global_best.numpy(), center)
    state = tpso.swarm_step(state, args[1], args[2], flat, cfg, generator=gen)
    np.testing.assert_array_equal(state.global_best.numpy(), center)


def test_run_chunked_equals_run_and_converges():
    d = 8
    target = np.linspace(-0.5, 0.5, d).astype(np.float32)
    f_port = _quadratic(target)[1]
    cfg = tpso.PSOConfig(num_particles=48, num_generations=60)
    args = (torch.zeros(d), torch.full((d,), -1.0), torch.full((d,), 1.0), f_port, cfg)
    best, score = tpso.run(*args, generator=torch.Generator().manual_seed(7))
    best_c, score_c, states = tpso.run_chunked(
        *args, num_chunks=4, generator=torch.Generator().manual_seed(7))
    assert len(states) == 4
    assert torch.equal(best, best_c) and torch.equal(score, score_c)
    assert float(score) < 1e-3
    np.testing.assert_allclose(best.numpy(), target, atol=0.05)


def _reference_draws(n, d, seed):
    """(r1, r2) as numpy: the reference's ``jax.random`` uniforms."""
    _, k1, k2 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (np.array(jax.random.uniform(k1, (n, d))),
            np.array(jax.random.uniform(k2, (n, d))))


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("n", [13, 16, 64])
def test_pso_update_projected_plain_matches_reference(n, batched):
    """The fused update's plain version (the update, then the tracker's
    quaternion projection) against the reference's ``pso_ref.pso_update``
    followed by ``handmodel.normalize_configuration``, on the reference's
    draws, at the update's 1e-6."""
    d = 27
    x, v, pb, gb, _, _, lo, hi = _update_inputs(n, d, seed=n)
    x[:, 3:7] = x[:, 3:7] * np.float32(2.0)  # off the unit sphere, as PSO leaves it
    r1, r2 = _reference_draws(n, d, seed=n)
    args = (x, v, pb, gb, r1, r2, lo, hi)
    rx, rv = jpso_ref.pso_update(*(jnp.asarray(a) for a in args), **CONSTS)
    rx = jhm.normalize_configuration(rx)
    t_args = [torch.from_numpy(np.asarray(a, dtype=np.float32)) for a in args]
    if batched:  # two swarms: this one and a shifted copy, per-swarm bounds
        t_args = [torch.stack([a, a + 0.01]) for a in t_args]
        px, pv = tkernel.pso_update_projected_batched(*t_args, **CONSTS)
        px, pv = px[0], pv[0]
    else:
        px, pv = tkernel.pso_update_projected(*t_args, **CONSTS)
    np.testing.assert_allclose(px.numpy(), np.asarray(rx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(px.numpy()[:, 3:7], axis=-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("n", [16, 13])
@pytest.mark.parametrize("restart_fraction", [0.0, 0.25])
def test_swarm_step_fused_projection_equals_project_fn(restart_fraction, n):
    """``swarm_step(project_quaternion=True)`` equals ``project_fn=
    normalize_configuration`` bit for bit on the CPU, for three
    generations on the same draws, with and without the restart (whose
    fresh rows stay unprojected), at N = 16 and 13; giving both is an
    error."""
    d = 27
    center, lo, hi, target = _box(d, 5)
    f_port = _quadratic(target)[1]
    cfg = tpso.PSOConfig(num_particles=n, restart_fraction=restart_fraction)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    rng = np.random.default_rng(6)
    init = tuple(rng.uniform(size=(n, d)).astype(np.float32) for _ in range(2))
    fused = unfused = tpso.init_swarm(torch.from_numpy(center), lo_t, hi_t, f_port, cfg,
                                      draws=init)
    n_restart = max(1, int(n * restart_fraction))
    for _ in range(3):
        draws = (rng.uniform(size=(n, d)).astype(np.float32),
                 rng.uniform(size=(n, d)).astype(np.float32),
                 rng.uniform(size=(n_restart, d)).astype(np.float32))
        unfused = tpso.swarm_step(unfused, lo_t, hi_t, f_port, cfg,
                                  project_fn=thm.normalize_configuration, draws=draws)
        fused = tpso.swarm_step(fused, lo_t, hi_t, f_port, cfg, project_quaternion=True,
                                draws=draws)
        for name in tpso.SwarmState._fields:
            assert torch.equal(getattr(fused, name), getattr(unfused, name)), name
    with pytest.raises(ValueError, match="not both"):
        tpso.swarm_step(fused, lo_t, hi_t, f_port, cfg, thm.normalize_configuration,
                        project_quaternion=True, draws=draws)

