"""The port's objective and render/score kernel path against the JAX
reference.

Inputs are numpy arrays made from a seed and handed to both packages.
Tolerances:
* depth maps and E_D at 1e-5 absolute: the same float32 expressions on
  both sides, apart from fusion and FMA contraction;
* ``ops.render_score`` as ``tests/test_kernels.py`` holds the Pallas
  kernel: rtol 2e-5 plus one silhouette-pixel flip per particle
  (CLAMP_T / |B|), since a grazing ray's discriminant is ~0 and the
  rounding of the dot product may flip hit and miss.  The JAX side runs
  its Pallas kernel in interpret mode, as its own tests do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import camera as jcam
from repro.core import handmodel as jhm
from repro.core import objective as jobj
from repro.kernels import ops as jops
from repro_torch.core import camera as tcam
from repro_torch.core import objective as tobj
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL = 1e-5
CAM_ARGS = dict(width=40, height=24, fx=36.0, fy=36.0, cx=19.5, cy=11.5)


def _assert_scores_close(a, b, mask):
    denom = max(float(np.asarray(mask, dtype=np.float32).sum()), 1.0)
    atol = tobj.CLAMP_T / denom + 1e-6
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=atol)


def _poses(n, distance=0.4):
    """n configurations near a default pose (the test_kernels recipe)."""
    hs = np.tile(np.asarray(jhm.default_pose(distance)), (n, 1))
    for i in range(n):
        hs[i, 0] += 0.02 * i
        hs[i, 7 + i % 20] += 0.1 * i
    return hs


@functools.lru_cache(maxsize=None)
def _population():
    """numpy spheres and rendered depth maps of 32 poses (JAX side, jitted
    once); the first n poses are the n-particle population."""
    cam = jcam.Camera(**CAM_ARGS)
    hs = jnp.asarray(_poses(32))
    spheres = jax.jit(jax.vmap(jhm.pack_spheres))(hs)
    maps = jax.jit(jax.vmap(lambda h: jobj.render_depth(h, cam)))(hs)
    # writable copies: torch.from_numpy warns on read-only arrays
    return np.array(spheres), np.array(cam.rays_flat()), np.array(maps)


def _score_inputs(n):
    """numpy (spheres, rays, observed depth, mask) for n particles."""
    spheres, rays, maps = _population()
    d_o = maps[n // 2].reshape(-1)
    return spheres[:n], rays, d_o, d_o < 5.0


def _observation():
    """An observed depth map of a pose near the particles, plus noise."""
    d = _population()[2][1]
    return d + np.random.default_rng(0).normal(0, 0.003, d.shape).astype(np.float32)


def test_sphere_depth_and_render_depth_match_reference():
    cam_t = tcam.Camera(**CAM_ARGS)
    spheres, rays, maps = _population()
    spheres, maps = spheres[:5], maps[:5]
    port = tobj.sphere_depth(torch.from_numpy(rays), torch.from_numpy(spheres))
    ref = jax.jit(jax.vmap(jobj.sphere_depth, in_axes=(None, 0)))(
        jnp.asarray(rays), jnp.asarray(spheres))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    port_maps = tobj.render_depth(torch.from_numpy(_poses(5)), cam_t)
    assert port_maps.shape == (5, cam_t.height, cam_t.width)
    np.testing.assert_allclose(port_maps.numpy(), maps, rtol=0, atol=ATOL)
    assert float(port_maps.max()) == tobj.BACKGROUND_DEPTH  # background present


@pytest.mark.parametrize("with_mask", [False, True])
def test_discrepancy_and_batched_objective_match_reference(with_mask):
    cam_j, cam_t = jcam.Camera(**CAM_ARGS), tcam.Camera(**CAM_ARGS)
    d_o = _observation()
    mask = np.array(jobj.bounding_box_mask(jnp.asarray(d_o), 0.4)) if with_mask else None
    hs = _poses(7) + np.float32(0.01)
    t_mask = None if mask is None else torch.from_numpy(mask)
    j_mask = None if mask is None else jnp.asarray(mask)
    d_h = _population()[2][3]
    np.testing.assert_allclose(
        float(tobj.discrepancy(torch.from_numpy(d_h), torch.from_numpy(d_o), t_mask)),
        float(jobj.discrepancy(jnp.asarray(d_h), jnp.asarray(d_o), j_mask)),
        rtol=1e-6, atol=1e-7)
    port = tobj.batched_objective(torch.from_numpy(hs), torch.from_numpy(d_o), cam_t, t_mask)
    ref = jax.jit(lambda h, d, m: jobj.batched_objective(h, d, cam_j, m))(
        jnp.asarray(hs), jnp.asarray(d_o), j_mask)
    assert port.shape == (7,)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_bounding_box_mask_matches_reference():
    d_o = _observation()
    for center, half in ((0.4, 0.25), (0.45, 0.05), (9.0, 1.5)):
        np.testing.assert_array_equal(
            tobj.bounding_box_mask(torch.from_numpy(d_o), center, half).numpy(),
            np.asarray(jobj.bounding_box_mask(jnp.asarray(d_o), center, half)))


@pytest.mark.parametrize("n", [1, 7, 8, 13, 32])
def test_render_score_matches_reference(n):
    spheres, rays, d_o, mask = _score_inputs(n)
    ref = jops.render_score(jnp.asarray(spheres), jnp.asarray(rays),
                            jnp.asarray(d_o), jnp.asarray(mask))
    port = tops.render_score(torch.from_numpy(spheres), torch.from_numpy(rays),
                             torch.from_numpy(d_o), torch.from_numpy(mask))
    assert port.shape == (n,) and port.dtype == torch.float32
    _assert_scores_close(port, ref, mask)
    # the oracle is the same function
    _assert_scores_close(
        tref.render_score(torch.from_numpy(spheres), torch.from_numpy(rays),
                          torch.from_numpy(d_o), torch.from_numpy(mask)), ref, mask)


def test_render_score_empty_mask_scores_zero():
    spheres, rays, d_o, _ = _score_inputs(4)
    zero = torch.zeros(d_o.shape, dtype=torch.bool)
    port = tops.render_score(torch.from_numpy(spheres), torch.from_numpy(rays),
                             torch.from_numpy(d_o), zero)
    np.testing.assert_array_equal(port.numpy(), np.zeros(4, np.float32))


def test_render_score_padding_is_invisible():
    """Padding to the block grid changes nothing a caller can see: the
    sums of padded particles and pixels are cropped or masked out."""
    spheres, rays, d_o, mask = _score_inputs(5)
    args = [torch.from_numpy(a) for a in (spheres, rays, d_o, mask)]
    base = tops.render_score(*args)
    for block_n, block_p in ((2, 128), (4, 256), (16, 1024)):
        np.testing.assert_allclose(
            tops.render_score(*args, block_n=block_n, block_p=block_p).numpy(),
            base.numpy(), rtol=1e-6, atol=1e-7)


def _nan_depth(d_o, mask, where):
    """d_o with one NaN: at the first pixel inside the mask ("masked") or
    the first outside it ("unmasked")."""
    d_o = d_o.copy()
    d_o[np.flatnonzero(mask if where == "masked" else ~mask)[0]] = np.nan
    return d_o


@pytest.mark.parametrize("where", ["masked", "unmasked"])
def test_nan_depth_makes_every_sum_nan(where):
    """One NaN observed depth, masked or not, gives a NaN sum for every
    particle in the reference's oracle, its Pallas kernel (interpret mode)
    and the port's K1 wrapper on CPU tensors (its plain version):
    ``jnp.minimum`` and ``torch.clamp(max=)`` propagate NaN, and NaN * 0
    is NaN.  The CUDA kernel must follow (``tests/test_torch_kernels.py``
    holds it there on the card)."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import render_score as trs

    spheres, rays, d_o, mask = _score_inputs(8)
    d_o = _nan_depth(d_o, mask, where)
    j_args = [jnp.asarray(a) for a in (spheres, rays, d_o, mask)]
    t_args = [torch.from_numpy(a) for a in (spheres, rays, d_o, mask)]
    for got in (jref.render_score_sums(*j_args), jops.render_score(*j_args),
                trs.render_score_sums(*t_args), tops.render_score(*t_args)):
        got = np.asarray(got)
        assert got.shape == (8,) and np.isnan(got).all()


@pytest.mark.parametrize("where", ["masked", "unmasked"])
def test_nan_depth_in_one_client_stays_in_its_row(where):
    """The batched pair with a NaN depth in client 1 of 3: that row is NaN
    for every particle, in the reference (Pallas, interpret mode) and in
    the port (K1b's wrapper on CPU tensors, and ``ops``); the other rows
    stay finite and within K1's tolerance of the reference."""
    from repro_torch.kernels import render_score as trs

    spheres, rays, d_o, mask = _score_inputs(8)
    spheres = np.stack([spheres, spheres + np.float32(0.01), spheres[::-1].copy()])
    rays = np.stack([rays] * 3)
    depth = np.stack([d_o, _nan_depth(d_o, mask, where), d_o[::-1].copy()])
    masks = np.stack([mask, mask, mask[::-1].copy()]).astype(np.float32)
    ref = np.asarray(jops.render_score_batched(*(jnp.asarray(a) for a in (
        spheres, rays, depth, masks))))
    t_args = [torch.from_numpy(a) for a in (spheres, rays, depth, masks)]
    sums = trs.render_score_sums_batched(*t_args).numpy()
    port = tops.render_score_batched(*t_args).numpy()
    for got in (ref, sums, port):
        assert got.shape == (3, 8)
        assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2]]).all()
    for b in (0, 2):
        _assert_scores_close(port[b], ref[b], masks[b])
        _assert_scores_close(sums[b] / max(float(masks[b].sum()), 1.0), ref[b], masks[b])


BACKGROUNDS = [tcam.BACKGROUND_DEPTH, 0.55, float("inf"), float("nan")]
CLAMPS = [tobj.CLAMP_T, float("inf")]


def _assert_sums_close(got, want, background, clamp_t):
    """Raw sums at the render tolerance: rtol 2e-5 plus one silhouette
    flip, the most one pixel's term can change when a grazing ray flips
    between a hit (under 1 m on these poses) and ``background``:
    min(clamp_t, |background| + 1).  NaN where the reference has NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    flip = min(clamp_t, abs(background) + 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=flip + 1e-6)


@pytest.mark.parametrize("clamp_t", CLAMPS)
@pytest.mark.parametrize("background", BACKGROUNDS)
def test_render_score_sums_honour_background_and_clamp(background, clamp_t):
    """``render_score_sums(..., background=, clamp_t=)`` and its batched
    form (their plain versions on CPU tensors) against the reference's
    Pallas kernels in interpret mode, which take both keywords: a NaN
    background, inf - inf and inf * 0 give NaN sums there, and here too."""
    from repro.kernels import render_score as jrs
    from repro_torch.kernels import render_score as trs

    spheres, rays, d_o, mask = _score_inputs(8)
    mask = mask.astype(np.float32)
    kw = dict(clamp_t=clamp_t, background=background)
    ref = jrs.render_score_sums(*(jnp.asarray(a) for a in (spheres, rays, d_o, mask)),
                                block_p=480, interpret=True, **kw)
    t_args = [torch.from_numpy(a) for a in (spheres, rays, d_o, mask)]
    port = trs.render_score_sums(*t_args, **kw)
    _assert_sums_close(port, ref, background, clamp_t)
    if background == tcam.BACKGROUND_DEPTH and clamp_t == tobj.CLAMP_T:
        assert torch.equal(trs.render_score_sums(*t_args), port)

    b_args = [np.stack([a, a[::-1].copy()]) for a in (spheres, rays, d_o, mask)]
    b_args[0][1] = spheres  # client 1: the same population, rays and image reversed
    ref_b = jrs.render_score_sums_batched(*(jnp.asarray(a) for a in b_args), block_p=480,
                                          interpret=True, **kw)
    port_b = trs.render_score_sums_batched(*(torch.from_numpy(a) for a in b_args), **kw)
    _assert_sums_close(port_b, ref_b, background, clamp_t)
    assert np.array_equal(port_b[0].numpy(), port.numpy(), equal_nan=True)
