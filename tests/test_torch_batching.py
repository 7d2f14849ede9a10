"""The port's batched edge-server step (K1b, K2b paths) against the JAX
reference.

Inputs are numpy arrays made from a seed and handed to both packages;
the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_batching.py`` does.  Tolerances:
* ``ops.render_score_batched`` as K1: rtol 2e-5 plus one silhouette-pixel
  flip per particle (CLAMP_T / |B_b| + 1e-6, per client);
* ``pso_update_batched`` at rtol = atol = 1e-6, as
  ``tests/test_batching.py`` holds the Pallas pair.
Within the port, each client's row equals the unbatched wrapper on that
client exactly.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import pso_ref as jpso_ref
from repro.kernels import pso_update as jpso
from repro_torch.core.objective import CLAMP_T
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pso_update as tpso

CONSTS = dict(inertia=0.7298, cognitive=1.49618, social=1.49618,
              velocity_clip=0.5)


def _render_inputs(b, n, s, p, seed=0):
    """numpy (spheres (B,N,S,4), rays (B,P,3), depth (B,P), mask (B,P)):
    spheres around z = 0.5, rays with d_z = 1, each client its own mask."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 0.1, (b, n, s, 3)) + np.array([0.0, 0.0, 0.5])
    radii = np.abs(rng.normal(0.0, 0.05, (b, n, s, 1))) + 0.02
    spheres = np.concatenate([centers, radii], axis=-1).astype(np.float32)
    rays = np.concatenate([rng.normal(0.0, 0.2, (b, p, 2)), np.ones((b, p, 1))],
                          axis=-1).astype(np.float32)
    depth = rng.uniform(0.3, 1.2, (b, p)).astype(np.float32)
    mask = rng.uniform(size=(b, p)) < np.linspace(0.3, 0.9, b)[:, None]
    return spheres, rays, depth, mask.astype(np.float32)


def _pso_inputs(b, n, d, seed=0, per_swarm_bounds=False):
    rng = np.random.default_rng(seed)
    rows = (b, d) if per_swarm_bounds else (d,)
    lo = (-np.abs(rng.normal(size=rows)) - 0.5).astype(np.float32)
    hi = (np.abs(rng.normal(size=rows)) + 0.5).astype(np.float32)
    lo_b, span = np.broadcast_to(lo, (b, d))[:, None], (hi - lo)
    span_b = np.broadcast_to(span, (b, d))[:, None]
    x = (lo_b + rng.uniform(size=(b, n, d)) * span_b).astype(np.float32)
    v = (rng.normal(size=(b, n, d)) * 0.5).astype(np.float32)  # some clip
    pb = (lo_b + rng.uniform(size=(b, n, d)) * span_b).astype(np.float32)
    r1, r2 = rng.uniform(size=(2, b, n, d)).astype(np.float32)
    return x, v, pb, pb[:, 0].copy(), r1, r2, lo, hi


def _assert_rows_close(got, want, mask):
    for row_got, row_want, m in zip(np.asarray(got), np.asarray(want), mask):
        denom = max(float(m.sum()), 1.0)
        np.testing.assert_allclose(row_got, row_want, rtol=2e-5,
                                   atol=CLAMP_T / denom + 1e-6)


@pytest.mark.parametrize("b,n,s,p", [(1, 8, 6, 512), (3, 5, 6, 300)])
def test_render_score_batched_matches_reference(b, n, s, p):
    """B = 1 and B = 3 with ragged N (5) and P (300, padded to 512)."""
    args = _render_inputs(b, n, s, p, seed=b)
    ref = jops.render_score_batched(*args)
    port = tops.render_score_batched(*(torch.from_numpy(a) for a in args))
    assert port.shape == (b, n) and port.dtype == torch.float32
    _assert_rows_close(port, ref, args[3])
    # each row is the unbatched wrapper on that client, exactly
    for i in range(b):
        solo = tops.render_score(*(torch.from_numpy(a[i]) for a in args))
        assert torch.equal(port[i], solo)


def test_render_score_batched_normalizes_per_client():
    """A client with an empty mask scores 0; the others are unaffected."""
    spheres, rays, depth, mask = _render_inputs(2, 4, 6, 256, seed=7)
    mask[1] = 0.0
    port = tops.render_score_batched(*(torch.from_numpy(a) for a in
                                       (spheres, rays, depth, mask)))
    assert bool((port[1] == 0).all())
    ref = jops.render_score_batched(spheres, rays, depth, mask)
    _assert_rows_close(port, ref, mask)


@pytest.mark.parametrize("per_swarm_bounds", [False, True])
@pytest.mark.parametrize("path", ["grid", "vmap"])
@pytest.mark.parametrize("b,n,d", [(1, 16, 32), (3, 13, 27)])
def test_pso_update_batched_matches_reference(b, n, d, path, per_swarm_bounds):
    args = _pso_inputs(b, n, d, seed=b + 10 * per_swarm_bounds,
                       per_swarm_bounds=per_swarm_bounds)
    port = tpso.pso_update_batched(*(torch.from_numpy(a) for a in args),
                                   path=path, **CONSTS)
    oracle = jpso_ref.pso_update_batched(*args, **CONSTS)
    for got, want in zip(port, oracle):
        assert got.shape == (b, n, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if n % 8 == 0:  # the Pallas kernel takes whole particle blocks only
        kernel = jpso.pso_update_batched(*args, **CONSTS)
        for got, want in zip(port, kernel):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    # each swarm equals the unbatched wrapper on that swarm, exactly
    x, v, pb, gb, r1, r2, lo, hi = (torch.from_numpy(a) for a in args)
    for i in range(b):
        lo_i = lo[i] if per_swarm_bounds else lo
        hi_i = hi[i] if per_swarm_bounds else hi
        ux, uv = tpso.pso_update(x[i], v[i], pb[i], gb[i], r1[i], r2[i], lo_i, hi_i,
                                 **CONSTS)
        assert torch.equal(port[0][i], ux) and torch.equal(port[1][i], uv)


def test_pso_update_batched_rejects_bad_path_and_shapes():
    args = [torch.from_numpy(a) for a in _pso_inputs(2, 8, 4)]
    with pytest.raises(ValueError, match="unknown path"):
        tpso.pso_update_batched(*args, path="nope", **CONSTS)
    bad_gbest = list(args)
    bad_gbest[3] = args[3][0]  # (D,) where (B, D) is due
    with pytest.raises(ValueError, match="gbest"):
        tpso.pso_update_batched(*bad_gbest, **CONSTS)
    bad_bounds = list(args)
    bad_bounds[6] = torch.zeros(3, 4)  # three swarms' rows for two swarms
    with pytest.raises(ValueError, match="lo"):
        tpso.pso_update_batched(*bad_bounds, **CONSTS)
