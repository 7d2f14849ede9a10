"""The port's CUDA kernels against their plain versions, and the wrappers'
CPU routing.

This file imports neither JAX nor the reference package, so the card's
machine, which has no JAX, runs it:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py

The tests marked ``gpu`` need a CUDA card and nvcc; elsewhere they skip
with that reason.  Tolerances: K1 and K1b as ``tests/test_kernels.py``
holds the Pallas kernel (rtol 2e-5 plus one silhouette-pixel flip,
CLAMP_T / |B|, on the normalized score), and NaN for every particle of
a client with a NaN depth anywhere, as in the reference; K2 and K2b at
rtol = atol = 1e-6, as ``tests/test_pso_kernel.py``; the codec (K3,
K3b, K4, K5, K5b, K6, K6b, K7) bit for bit.  A batched kernel's rows
equal its unbatched kernel bit for bit.  The quantizer's plain version
divides by a float32 tensor on the input's device, so on the card it
rounds as on the CPU; the tests hold each codec kernel against the
plain version run on the CPU copy of its input, and the plain version
on the card against that too.
"""

import numpy as np
import pytest
import torch

from repro_torch.codec import kernels as ck
from repro_torch.codec import ref as cref
from repro_torch.codec import wire
from repro_torch.core import handmodel as hm
from repro_torch.core.camera import Camera, crop_camera
from repro_torch.core.objective import CLAMP_T, render_depth
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import pso_update as pu
from repro_torch.kernels import render_score as rs

CONSTS = dict(inertia=0.7298, cognitive=1.49618, social=1.49618,
              velocity_clip=0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; run on the GPU machine")
    return torch.device("cuda")


def _score_inputs(n, device, cam=Camera()):
    """A population of n poses near a hand, rendered rays and depth."""
    rng = np.random.default_rng(n)
    hs = np.tile(np.asarray(hm.default_pose(0.45, device="cpu")), (n, 1))
    hs[:, :3] += rng.uniform(-0.03, 0.03, (n, 3)).astype(np.float32)
    hs[:, 7:] += rng.uniform(0.0, 0.8, (n, 20)).astype(np.float32)
    hs = torch.from_numpy(hs).to(device)
    depth = render_depth(hs[0], cam).reshape(-1)
    mask = (torch.abs(depth - 0.45) < 0.25).to(torch.float32)
    return hm.pack_spheres(hs), cam.rays_flat(device), depth, mask


def _update_inputs(n, d, device, seed=0):
    rng = np.random.default_rng(seed)
    lo = -np.abs(rng.normal(size=d)) - 0.5
    hi = np.abs(rng.normal(size=d)) + 0.5
    x = lo + rng.uniform(size=(n, d)) * (hi - lo)
    v = rng.normal(size=(n, d)) * 0.5
    pb = lo + rng.uniform(size=(n, d)) * (hi - lo)
    r1, r2 = rng.uniform(size=(2, n, d))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (x, v, pb, pb[0], r1, r2, lo, hi)]


def _assert_scores_close(got, want, mask, flip=CLAMP_T, equal_nan=False):
    """Within rtol 2e-5 plus one silhouette flip (``flip``: the most one
    pixel's term can change) on the normalized score."""
    denom = max(float(mask.sum()), 1.0)
    torch.testing.assert_close(got / denom, want / denom, rtol=2e-5,
                               atol=flip / denom + 1e-6, equal_nan=equal_nan)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU each wrapper runs its plain version and counts no launch."""
    k1, k2 = rs.launches, pu.launches
    args = _score_inputs(3, "cpu", Camera(width=24, height=16, fx=20.0, fy=20.0,
                                          cx=11.5, cy=7.5))
    assert torch.equal(rs.render_score_sums(*args), rs.render_score_sums_plain(*args))
    upd = _update_inputs(5, 27, "cpu")
    for a, b in zip(pu.pso_update(*upd, **CONSTS), pu.pso_update_plain(*upd, **CONSTS)):
        assert torch.equal(a, b)
    assert (rs.launches, pu.launches) == (k1, k2)


def _batched_update_inputs(b, n, d, device, per_swarm_bounds):
    swarms = [_update_inputs(n, d, device, seed=i) for i in range(b)]
    x, v, pb, gb, r1, r2, lo, hi = (torch.stack(a) for a in zip(*swarms))
    if not per_swarm_bounds:
        lo, hi = lo[0], hi[0]
    return [x, v, pb, gb, r1, r2, lo, hi]


# K3's tiles: the default 8x128 (1,024 pixels, one chunk a block), 32x64
# (2,048 pixels on the vector path where the width allows) and 9x130
# (1,170 pixels, always the scalar path): the last two run the kernel's
# loops over a tile's later chunks.
TILES = [(8, 128), (32, 64), (9, 130)]


def _codec_pair(h, w, device, b=None, seed=0):
    """(frame, ref) planes, (h, w) or (b, h, w): noise, a tile moved by
    more than any threshold but holding a NaN, a tile whose only
    difference is -0.0 against +0.0, and a moved last tile."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if b is None else (b, h, w)
    ref = rng.normal(0.5, 0.1, shape).astype(np.float32)
    frame = ref + rng.normal(0.0, 0.002, shape).astype(np.float32)
    frame[..., :4, :16] += 0.2
    frame[..., 2, 3] = np.nan
    frame[..., 8:16, :128] = ref[..., 8:16, :128]
    ref[..., 9, 3], frame[..., 9, 3] = 0.0, -0.0
    frame[..., h - 1, w - 1] += 0.5
    return torch.from_numpy(frame).to(device), torch.from_numpy(ref).to(device)


def _counts():
    return (rs.launches, rs.launches_batched, pu.launches, pu.launches_batched,
            dict(ck.launches))


def test_batched_and_codec_wrappers_take_the_plain_versions_on_cpu():
    """On the CPU the new wrappers run their plain versions, exactly, and
    count no launch."""
    before = _counts()
    cam = Camera(width=24, height=16, fx=20.0, fy=20.0, cx=11.5, cy=7.5)
    rows = [_score_inputs(3, "cpu", cam) for _ in range(2)]
    args = [torch.stack(a) for a in zip(*rows)]
    assert torch.equal(rs.render_score_sums_batched(*args),
                       rs.render_score_sums_batched_plain(*args))
    upd = _batched_update_inputs(2, 5, 27, "cpu", per_swarm_bounds=True)
    for a, b in zip(pu.pso_update_batched(*upd, **CONSTS),
                    pu.pso_update_batched_plain(*upd, **CONSTS)):
        assert torch.equal(a, b)
    frame, ref = _codec_pair(16, 256, "cpu")
    for got, want in zip(ck.delta_encode(frame, ref, threshold=0.01),
                         cref.delta_encode(frame, ref, threshold=0.01)):
        assert torch.equal(got, want)
    frames, refs = _codec_pair(16, 256, "cpu", b=2)
    for got, want in zip(ck.delta_encode_batched(frames, refs),
                         ck.delta_encode_plain(frames, refs)):
        assert torch.equal(got, want)
    delta, _ = ck.delta_encode(frame, ref)
    assert torch.equal(ck.delta_decode(delta, ref).view(torch.int32),
                       ck.delta_decode_plain(delta, ref).view(torch.int32))
    assert _counts() == before


def _quant_planes(h, w, lo, hi, bits, device, b=4, seed=0):
    """(b, h, w) float32 planes: uniform over 10% beyond [lo, hi] on both
    sides, exact half-step ties ``lo + (k + 1/2) * step`` in every other
    row, and in tile (0, 0) NaN, +-inf, -0.0, the range's ends and points
    just outside them."""
    rng = np.random.default_rng(seed)
    span = hi - lo
    x = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, (b, h, w)).astype(np.float32)
    step = np.float32(cref.quant_step(lo, hi, bits))
    k = rng.integers(0, (1 << bits) - 1, (b, h // 2, w))
    x[:, ::2] = np.float32(lo) + (k + 0.5).astype(np.float32) * step
    x[:, 1, :10] = [np.nan, np.inf, -np.inf, -0.0, 0.0, lo, hi, lo - 1.0, hi + 1.0, np.nan]
    return torch.from_numpy(x).to(device)


def _residual_planes(h, w, device, b=4, seed=0):
    """K3's threshold-0 residuals of b (frame, ref) pairs, with a tile
    whose max word has the sign bit set and an all-zero tile."""
    frames, refs = _codec_pair(h, w, device, b=b, seed=seed)
    deltas, _ = ck.delta_encode_batched(frames, refs)
    deltas[:, :8, -128:] = 0
    deltas[:, 8, -1] = -1
    return deltas


def test_quant_wrappers_take_the_plain_versions_on_cpu():
    """On the CPU the K5/K5b, K6/K6b and K7 wrappers run their plain
    versions, exactly, and count no launch."""
    before = _counts()
    x = _quant_planes(16, 256, 0.1, 10.0, 8, "cpu", b=2)
    words = ck.quantize_pack_batched(x, 0.1, 10.0, bits=8)
    assert torch.equal(words, ck.quantize_pack_plain(x, 0.1, 10.0, bits=8))
    assert torch.equal(ck.quantize_pack(x[1], 0.1, 10.0, bits=8), words[1])
    values = ck.unpack_dequantize(words[0], 0.1, 10.0, bits=8)
    assert torch.equal(values.view(torch.int32), ck.unpack_dequantize_plain(
        words[0], 0.1, 10.0, bits=8).view(torch.int32))
    deltas = _residual_planes(16, 256, "cpu", b=2)
    widths = ck.significant_bit_widths_batched(deltas)
    assert torch.equal(widths, ck.significant_bit_widths_plain(deltas))
    assert torch.equal(ck.significant_bit_widths(deltas[0]), widths[0])
    assert widths[0, 0, 1] == 0 and widths[0, 1, 1] == 32
    assert _counts() == before


def _old_quant_encode(frame, ref, lo, hi, bits, block_h, block_w):
    """encode_frame as it ran before its one launch: K6, K7, K6, K7 and
    K3's mask-only launch at threshold step/2."""
    words = ck.quantize_pack(frame, lo, hi, bits=bits)
    recon = ck.unpack_dequantize(words, lo, hi, bits=bits)
    ref_recon = ck.unpack_dequantize(ck.quantize_pack(ref, lo, hi, bits=bits), lo, hi,
                                     bits=bits)
    mask = ck._delta_mask(recon, ref_recon, threshold=cref.quant_step(lo, hi, bits) / 2,
                          block_h=block_h, block_w=block_w)
    return words, mask


def _old_quant_decode(words, mask, ref, lo, hi, bits, block_h, block_w):
    """decode_frame as it ran before its one launch: K7 and the select."""
    return cref.select_tiles(ck.unpack_dequantize(words, lo, hi, bits=bits), mask, ref,
                             block_h, block_w)


def test_fused_codec_wrappers_take_the_plain_versions_on_cpu():
    """On the CPU the one-launch encode and decode of the quantized
    format, K3 with the reconstruction, the two-output K4, K3/K3b with
    the widths and K6's keyframe launch run their plain compositions,
    exactly, and count no launch; the reconstruction and both of K4's
    outputs are new tensors."""
    before = _counts()
    x = _quant_planes(16, 256, 0.1, 10.0, 8, "cpu", b=2)
    for bits in (16, 8, 4, 2):
        words, mask = ck._quant_encode(x[1], x[0], 0.1, 10.0, bits=bits)
        old_words, old_mask = _old_quant_encode(x[1], x[0], 0.1, 10.0, bits, 8, 128)
        assert torch.equal(words, old_words) and _bit_equal(mask, old_mask)
        out = ck._quant_decode(words, mask, x[0], 0.1, 10.0, bits=bits)
        assert _bit_equal(out, _old_quant_decode(words, mask, x[0], 0.1, 10.0, bits, 8, 128))
        assert _bit_equal(out, ck.quant_decode_plain(words, mask, x[0], 0.1, 10.0, bits=bits))
    frame, ref = _codec_pair(16, 256, "cpu")
    delta, mask, recon = ck._delta_encode_recon(frame, ref, threshold=0.01)
    want_delta, want_mask = ck.delta_encode(frame, ref, threshold=0.01)
    assert torch.equal(delta, want_delta) and _bit_equal(mask, want_mask)
    assert _bit_equal(recon, ck.delta_decode(delta, ref))
    state, copy = ck._delta_decode_pair(delta, ref)
    assert _bit_equal(state, recon) and _bit_equal(copy, recon)
    assert len({recon.data_ptr(), state.data_ptr(), copy.data_ptr(), ref.data_ptr()}) == 4
    frames, refs = _codec_pair(16, 256, "cpu", b=2)
    for f, r in ((frame, ref), (frames, refs)):
        d, m, widths = ck._delta_encode_widths(f, r, threshold=0.01)
        want_d, want_m = ck.delta_encode_plain(*((f, r) if f.dim() == 3 else (f[None], r[None])),
                                               threshold=0.01)
        want_w = ck.significant_bit_widths_plain(want_d)
        if f.dim() == 2:
            want_d, want_m, want_w = want_d[0], want_m[0], want_w[0]
        assert torch.equal(d, want_d) and _bit_equal(m, want_m) and torch.equal(widths, want_w)
    for bits in cref.PACKABLE_BITS:
        words, values = ck._quantize_pack_recon(x[1], 0.1, 10.0, bits=bits)
        assert torch.equal(words, ck.quantize_pack_plain(x[1], 0.1, 10.0, bits=bits))
        assert _bit_equal(values, ck.unpack_dequantize_plain(words, 0.1, 10.0, bits=bits))
    assert _counts() == before


def test_fused_codec_wrappers_validate_their_inputs():
    """The one-launch encode takes whole tiles only, as the reference's
    encode_frame; the decode a words plane that fits the reference and a
    mask that covers the tile grid."""
    x = _quant_planes(16, 256, 0.0, 1.0, 8, "cpu", b=2)
    with pytest.raises(ValueError, match="not divisible"):
        ck._quant_encode(x[1], x[0], 0.0, 1.0, block_w=96)
    with pytest.raises(ValueError, match="pack ratio"):
        ck._quant_encode(x[1, :, :254], x[0, :, :254], 0.0, 1.0, block_w=127)
    with pytest.raises(ValueError):
        ck._quant_encode(x[1], x[0, :8], 0.0, 1.0)
    words, mask = ck._quant_encode(x[1], x[0], 0.0, 1.0)
    with pytest.raises(ValueError, match="tile grid"):
        ck._quant_decode(words, mask[:1], x[0], 0.0, 1.0)
    with pytest.raises(ValueError, match="words"):
        ck._quant_decode(words[:, :10], mask, x[0], 0.0, 1.0)
    with pytest.raises(TypeError):
        ck._quant_decode(words.long(), mask, x[0], 0.0, 1.0)
    delta, _ = ck.delta_encode(x[1], x[0])
    with pytest.raises(ValueError):
        ck._delta_decode_pair(delta, x[0, :8])
    with pytest.raises(ValueError):
        ck._delta_encode_recon(x[1], x[0], block_w=0)
    with pytest.raises(ValueError):
        ck._delta_encode_widths(x[1], x[0, :8])
    with pytest.raises(ValueError):
        ck._delta_encode_widths(x, x[0])
    with pytest.raises(ValueError, match="pack ratio"):
        ck._quantize_pack_recon(x[1, :, :250], 0.0, 1.0, bits=8)
    with pytest.raises(ValueError):
        ck._quantize_pack_recon(x, 0.0, 1.0)  # (B, H, W) where (H, W) is due


def test_batched_wrappers_reject_bad_path_and_shapes():
    upd = _batched_update_inputs(2, 5, 27, "cpu", per_swarm_bounds=False)
    with pytest.raises(ValueError, match="unknown path"):
        pu.pso_update_batched(*upd, path="scan", **CONSTS)
    with pytest.raises(ValueError, match="r1"):
        pu.pso_update_batched(*upd[:4], upd[4][:, :3], *upd[5:], **CONSTS)
    frames, refs = _codec_pair(16, 256, "cpu", b=2)
    with pytest.raises(ValueError, match="unknown path"):
        ck.delta_encode_batched(frames, refs, path="scan")
    with pytest.raises(ValueError):
        ck.delta_encode_batched(frames, refs[:1])
    with pytest.raises(ValueError):
        ck.delta_encode(frames, refs)  # (B, H, W) where (H, W) is due
    with pytest.raises(ValueError):
        ck.delta_encode(frames[0], refs[0], block_h=0)


def test_build_targets_hopper_without_fast_math():
    assert {p.name for p in _build.sources()} >= {
        "render_score.cu", "pso_update.cu", "delta_codec.cu", "quant_codec.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    assert "-O3" in _build.COMPILE_FLAGS
    assert not any("fast_math" in f for f in _build.ARCH_FLAGS + _build.COMPILE_FLAGS)
    assert _build.library_path() == _build.library_path()  # keyed by content
    assert _build.library_path().parent == _build.BUILD_DIR


MASK_CASES = ["bbox", "nan_masked", "nan_unmasked", "dense", "nonbinary", "single_pixel"]


def _mask_case(case, depth, mask):
    """(depth, mask) of a K1 case from the bounding-box mask ``mask``: a
    NaN depth at a masked or at an unmasked pixel, an all-ones mask,
    weights 0.5 and 2.0 on some pixels, or one pixel kept."""
    depth, mask = depth.clone(), mask.clone()
    inside = int(torch.nonzero(mask)[0])
    if case == "nan_masked":
        depth[inside] = float("nan")
    elif case == "nan_unmasked":
        depth[int(torch.nonzero(mask == 0)[0])] = float("nan")
    elif case == "dense":
        mask = torch.ones_like(mask)
    elif case == "nonbinary":
        mask[::3] *= 0.5
        mask[1::17] *= 2.0
    elif case == "single_pixel":
        mask = torch.zeros_like(mask)
        mask[inside] = 1.0
    return depth, mask


def _bit_equal(a, b):
    """Same shape and float32 bits (NaN included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", MASK_CASES)
@pytest.mark.parametrize("n,scale,p_cut", [(64, 2, 0), (13, 1, 77)])
def test_render_score_kernel_matches_plain(cuda, n, scale, p_cut, case):
    """64 particles on a 64x64 camera, and 13 on 128x128 with P cut to a
    ragged length (not a multiple of the kernel's 256-pixel segment), for
    each mask case: a NaN depth, masked or not, makes every sum NaN as in
    the plain version; otherwise the sums match it.  A repeat is
    bit-identical (no float atomics); where no depth is NaN an all-zero
    mask scores exactly 0.  The full-width (64, 16384) checks are
    chip_smoke.py's."""
    spheres, rays, depth, mask = _score_inputs(n, cuda, crop_camera(Camera(), scale))
    p = rays.shape[0] - p_cut
    depth, mask = _mask_case(case, depth[:p], mask[:p])
    args = (spheres, rays[:p], depth, mask)
    before = rs.launches
    got = rs.render_score_sums(*args)
    again = rs.render_score_sums(*args)
    zero = rs.render_score_sums(*args[:3], torch.zeros_like(mask))
    assert rs.launches == before + 3
    want = rs.render_score_sums_plain(*args)
    assert _bit_equal(got, again)
    if case.startswith("nan"):
        assert bool(torch.isnan(want).all()) and bool(torch.isnan(got).all())
        assert bool(torch.isnan(zero).all())
    else:
        _assert_scores_close(got, want, mask)
        assert bool((zero == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 13])
def test_pso_update_kernel_matches_plain(cuda, n):
    args = _update_inputs(n, 27, cuda, seed=n)
    before = pu.launches
    kx, kv = pu.pso_update(*args, **CONSTS)
    assert pu.launches == before + 1
    px, pv = pu.pso_update_plain(*args, **CONSTS)
    torch.testing.assert_close(kx, px, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kv, pv, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("case", MASK_CASES)
def test_render_score_batched_kernel_matches_plain_and_k1(cuda, case):
    """K1b over 3 clients (64 particles on a 64x64 camera, P cut to a
    ragged length), with the mask case applied to client 2 alone: each
    row equals K1 on that client bit for bit and is within K1's tolerance
    of the plain version, except that a NaN depth in client 2 makes row 2,
    and only row 2, NaN in both."""
    cam = crop_camera(Camera(), 2)
    rows = [_score_inputs(64, cuda, cam) for _ in range(3)]
    p = rows[0][1].shape[0] - 77
    spheres, rays, depth, mask = (torch.stack(a) for a in zip(*rows))
    for i in range(3):  # three different clients
        spheres[i, :, :, 2] += 0.01 * i
        mask[i, : 200 * i] = 0.0
    depth, mask = depth[:, :p].clone(), mask[:, :p].clone()
    depth[2], mask[2] = _mask_case(case, depth[2], mask[2])
    args = (spheres, rays[:, :p], depth, mask)
    before = (rs.launches, rs.launches_batched)
    got = rs.render_score_sums_batched(*args)
    assert (rs.launches, rs.launches_batched) == (before[0], before[1] + 1)
    want = rs.render_score_sums_batched_plain(*args)
    for i in range(3):
        assert _bit_equal(got[i], rs.render_score_sums(*(a[i] for a in args)))
        if case.startswith("nan") and i == 2:
            assert bool(torch.isnan(want[i]).all()) and bool(torch.isnan(got[i]).all())
        else:
            assert bool(torch.isfinite(got[i]).all())
            _assert_scores_close(got[i], want[i], args[3][i])
    normalized = ops.render_score_batched(*args)
    for i in range(3):
        assert _bit_equal(normalized[i], ops.render_score(*(a[i] for a in args)))


@pytest.mark.gpu
@pytest.mark.parametrize("per_swarm_bounds", [False, True])
def test_pso_update_batched_kernel_matches_plain_and_k2(cuda, per_swarm_bounds):
    args = _batched_update_inputs(4, 64, 27, cuda, per_swarm_bounds)
    before = pu.launches_batched
    kx, kv = pu.pso_update_batched(*args, **CONSTS)
    assert pu.launches_batched == before + 1
    px, pv = pu.pso_update_batched_plain(*args, **CONSTS)
    torch.testing.assert_close(kx, px, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kv, pv, rtol=1e-6, atol=1e-6)
    vx, vv = pu.pso_update_batched(*args, path="vmap", **CONSTS)
    assert torch.equal(kx, vx) and torch.equal(kv, vv)  # K2 per swarm


@pytest.mark.gpu
@pytest.mark.parametrize("block", TILES)
@pytest.mark.parametrize("threshold", [0.0, 0.01])
@pytest.mark.parametrize("h,w", [(128, 128), (240, 320), (240, 322)])
def test_delta_codec_kernels_match_plain(cuda, h, w, threshold, block):
    """K3, K3b (B = 4) and K4 bit for bit against their plain versions on
    the CPU, with the NaN and signed-zero tiles; K3b's rows equal K3.  A
    width that is not a multiple of 4 takes the kernel's scalar path; the
    tiles of over 1,024 pixels its chunked loops."""
    frames, refs = _codec_pair(h, w, cuda, b=4, seed=h)
    tile = dict(threshold=threshold, block_h=block[0], block_w=block[1])
    before = dict(ck.launches)
    d, m = ck.delta_encode_batched(frames, refs, **tile)
    pd, pm = ck.delta_encode_plain(frames.cpu(), refs.cpu(), **tile)
    assert torch.equal(d.cpu(), pd) and torch.equal(m.cpu(), pm)
    assert m.dtype == torch.float32 and m.shape == (4, -(-h // block[0]), -(-w // block[1]))
    for i in range(4):
        di, mi = ck.delta_encode(frames[i], refs[i], **tile)
        assert torch.equal(di, d[i]) and torch.equal(mi, m[i])
        out = ck.delta_decode(di, refs[i])
        want = ck.delta_decode_plain(di.cpu(), refs[i].cpu())
        assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))
    assert m[0, 0, 0] == 0 and m[0, -1, -1] == 1
    if block == (8, 128):
        assert m[0, 1, 0] == 0
    delta_keys = ("delta_encode", "delta_encode_batched", "delta_decode")
    assert {k: ck.launches[k] for k in delta_keys} == {
        "delta_encode": before["delta_encode"] + 4,
        "delta_encode_batched": before["delta_encode_batched"] + 1,
        "delta_decode": before["delta_decode"] + 4}


@pytest.mark.gpu
def test_delta_stream_on_the_card_is_lossless_at_threshold_zero(cuda):
    rng = np.random.default_rng(3)
    base = rng.normal(0.5, 0.1, (32, 128)).astype(np.float32)
    enc = wire.DeltaStreamEncoder(keyframe_interval=4)
    dec = wire.DeltaStreamDecoder()
    for t in range(9):
        f = base.copy()
        f[(t * 3) % 32: (t * 3) % 32 + 4, :16] += 0.05
        frame = torch.from_numpy(f).to(cuda)
        out = dec.decode(enc.encode(frame))
        assert out.is_cuda and torch.equal(out.view(torch.int32), frame.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.1, 10.0)])
@pytest.mark.parametrize("h,w", [(128, 128), (240, 320)])
def test_quant_kernels_match_plain(cuda, h, w, lo, hi):
    """K6b (B = 4), K6 and K7 at every packable width, bit for bit
    against their plain versions on the CPU copy, on planes with half-step
    ties and a NaN/+-inf/-0.0 tile; K6b's rows equal K6; the plain
    version on the card equals it on the CPU."""
    for bits in cref.PACKABLE_BITS:
        x = _quant_planes(h, w, lo, hi, bits, cuda, seed=bits)
        before = dict(ck.launches)
        words = ck.quantize_pack_batched(x, lo, hi, bits=bits)
        want = ck.quantize_pack_plain(x.cpu(), lo, hi, bits=bits)
        assert words.shape == (4, h, w * bits // 32) and torch.equal(words.cpu(), want)
        assert torch.equal(ck.quantize_pack_plain(x, lo, hi, bits=bits).cpu(), want)
        for i in range(4):
            assert torch.equal(ck.quantize_pack(x[i], lo, hi, bits=bits), words[i])
            values = ck.unpack_dequantize(words[i], lo, hi, bits=bits)
            plain = ck.unpack_dequantize_plain(want[i], lo, hi, bits=bits)
            assert values.shape == (h, w)
            assert torch.equal(values.cpu().view(torch.int32), plain.view(torch.int32))
        assert ck.launches["quantize_pack_batched"] == before["quantize_pack_batched"] + 1
        assert ck.launches["quantize_pack"] == before["quantize_pack"] + 4
        assert ck.launches["unpack_dequantize"] == before["unpack_dequantize"] + 4


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(128, 128), (240, 320)])
def test_bit_width_kernels_match_plain(cuda, h, w):
    """K5b (B = 4) and K5 bit for bit against their plain version on the
    CPU copy, on K3's residuals with a sign-bit tile (width 32) and an
    all-zero tile (width 0); K5b's rows equal K5."""
    deltas = _residual_planes(h, w, cuda, seed=h)
    before = dict(ck.launches)
    widths = ck.significant_bit_widths_batched(deltas)
    want = ck.significant_bit_widths_plain(deltas.cpu())
    assert widths.shape == (4, -(-h // 8), -(-w // 128)) and torch.equal(widths.cpu(), want)
    for i in range(4):
        assert torch.equal(ck.significant_bit_widths(deltas[i]), widths[i])
    assert bool((widths[:, 0, -1] == 0).all()) and bool((widths[:, 1, -1] == 32).all())
    assert ck.launches["significant_bit_widths_batched"] == (
        before["significant_bit_widths_batched"] + 1)
    assert ck.launches["significant_bit_widths"] == before["significant_bit_widths"] + 4


@pytest.mark.gpu
def test_quantized_frames_on_the_card_match_the_cpu(cuda):
    """encode_frame/decode_frame through K6, K7 and K3 on the card equal
    the same composition of the plain versions on the CPU."""
    x = _quant_planes(128, 128, 0.0, 10.0, 8, cuda, b=2, seed=5)
    for bits in (16, 8):
        words, mask = wire.encode_frame(x[1], x[0], 0.0, 10.0, bits=bits)
        cw, cm = wire.encode_frame(x[1].cpu(), x[0].cpu(), 0.0, 10.0, bits=bits)
        assert torch.equal(words.cpu(), cw) and torch.equal(mask.cpu(), cm)
        out = wire.decode_frame(words, mask, x[0], 0.0, 10.0, bits=bits)
        want = wire.decode_frame(cw, cm, x[0].cpu(), 0.0, 10.0, bits=bits)
        assert torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))


BACKGROUNDS = [10.0, 0.55, float("inf"), float("nan")]
CLAMPS = [CLAMP_T, float("inf")]


@pytest.mark.gpu
@pytest.mark.parametrize("clamp_t", CLAMPS)
@pytest.mark.parametrize("background", BACKGROUNDS)
def test_render_score_kernels_honour_background_and_clamp(cuda, background, clamp_t):
    """K1 (64 particles on a 64x64 camera, P cut to a ragged length) and
    K1b (3 clients) against their plain versions at a given background
    and clamp: a finite pair keeps the kernel's skip of masked-out pixels;
    a NaN background, an infinite background or clamp scores every pixel,
    so the NaN sums of the plain version (NaN background, inf - inf,
    inf * 0) come out of the kernels too.  A flip between a hit (under 1 m
    here) and the background changes one term by at most
    min(clamp_t, |background| + 1).  Each K1b row equals K1 bit for bit."""
    cam = crop_camera(Camera(), 2)
    rows = [_score_inputs(64, cuda, cam) for _ in range(3)]
    p = rows[0][1].shape[0] - 77
    spheres, rays, depth, mask = (torch.stack(a) for a in zip(*rows))
    for i in range(3):
        spheres[i, :, :, 2] += 0.01 * i
        mask[i, : 200 * i] = 0.0
    args = (spheres, rays[:, :p].contiguous(), depth[:, :p].contiguous(),
            mask[:, :p].contiguous())
    kw = dict(background=background, clamp_t=clamp_t)
    flip = min(clamp_t, abs(background) + 1.0)
    before = (rs.launches, rs.launches_batched)
    got = rs.render_score_sums(*(a[0] for a in args), **kw)
    batched = rs.render_score_sums_batched(*args, **kw)
    assert (rs.launches, rs.launches_batched) == (before[0] + 1, before[1] + 1)
    want = rs.render_score_sums_batched_plain(*args, **kw)
    assert _bit_equal(batched[0], got)
    for i in range(3):
        assert _bit_equal(batched[i], rs.render_score_sums(*(a[i] for a in args), **kw))
        assert bool((torch.isnan(batched[i]) == torch.isnan(want[i])).all())
        _assert_scores_close(batched[i], want[i], args[3][i], flip, equal_nan=True)
    all_nan = background != background or (background == float("inf")
                                            and clamp_t == float("inf"))
    assert bool(torch.isnan(want).all()) == all_nan and bool(torch.isfinite(want).all()) != all_nan


@pytest.mark.gpu
@pytest.mark.parametrize("per_swarm_bounds", [False, True])
@pytest.mark.parametrize("n", [64, 13])
def test_pso_update_projected_kernels_match_plain(cuda, n, per_swarm_bounds):
    """The fused K2b (B = 4) and K2 (update + quaternion projection in one
    launch) against their plain versions at rtol = atol = 1e-6; each K2b
    row equals the fused K2 on that swarm bit for bit; outside the
    quaternion columns, and for the velocities, the fused launch equals
    the unprojected one bit for bit."""
    args = _batched_update_inputs(4, n, 27, cuda, per_swarm_bounds)
    args[0][..., 3:7] *= 2.0  # off the unit sphere, as the update leaves it
    before = (pu.launches, pu.launches_batched, pu.launches_projected)
    kx, kv = pu.pso_update_projected_batched(*args, **CONSTS)
    px, pv = pu.pso_update_projected_batched_plain(*args, **CONSTS)
    torch.testing.assert_close(kx, px, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(kv, pv, rtol=1e-6, atol=1e-6)
    lo, hi = (torch.broadcast_to(t, (4, 27)) for t in args[6:])
    for i in range(4):
        swarm = [a[i] for a in args[:6]] + [lo[i], hi[i]]
        sx, sv = pu.pso_update_projected(*swarm, **CONSTS)
        assert _bit_equal(kx[i], sx) and _bit_equal(kv[i], sv)
        qx, qv = pu.pso_update_projected_plain(*swarm, **CONSTS)
        torch.testing.assert_close(sx, qx, rtol=1e-6, atol=1e-6)
    assert (pu.launches, pu.launches_batched, pu.launches_projected) == (
        before[0] + 4, before[1] + 1, before[2] + 5)
    ux, uv = pu.pso_update_batched(*args, **CONSTS)
    keep = torch.ones(27, dtype=torch.bool, device=cuda)
    keep[3:7] = False
    assert _bit_equal(kv, uv) and _bit_equal(kx[..., keep], ux[..., keep])
    norms = torch.linalg.vector_norm(kx[..., 3:7], dim=-1)
    torch.testing.assert_close(norms, torch.ones_like(norms), rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("block", TILES)
@pytest.mark.parametrize("threshold", [0.0, 0.01])
@pytest.mark.parametrize("h,w", [(128, 128), (240, 320), (240, 322)])
def test_delta_mask_launch_matches_full_launch(cuda, h, w, threshold, block):
    """K3's and K3b's mask-only launch gives the full launch's mask bit
    for bit (and the plain version's), on aligned planes, on planes one
    float off 16-byte alignment (the scalar path), at a width that is not
    a multiple of 4 and on tiles of over 1,024 pixels; it is counted as a
    launch of K3 or K3b."""
    frames, refs = _codec_pair(h, w, cuda, b=4, seed=h + w)
    tile = dict(threshold=threshold, block_h=block[0], block_w=block[1])
    flat_f, flat_r = frames.reshape(-1), refs.reshape(-1)
    shifted = (flat_f[1:1 + h * w].view(h, w), flat_r[1:1 + h * w].view(h, w))
    for f, r in ((frames, refs), (frames[2], refs[2]), shifted):
        before = dict(ck.launches)
        mask = ck._delta_mask(f, r, **tile)
        key = "delta_encode_batched" if f.dim() == 3 else "delta_encode"
        _, full = (ck.delta_encode_batched if f.dim() == 3 else ck.delta_encode)(f, r, **tile)
        assert ck.launches[key] == before[key] + 2
        assert ck.launches["delta_encode_mask_only"] == before["delta_encode_mask_only"] + 1
        assert _bit_equal(mask, full)
        planes = (f.cpu(), r.cpu()) if f.dim() == 3 else (f.cpu()[None], r.cpu()[None])
        _, plain = ck.delta_encode_plain(*planes, **tile)
        assert _bit_equal(mask.cpu(), plain if f.dim() == 3 else plain[0])


# (h, w, block_h, block_w, bits) of the one-launch quantized encode and
# decode: 8x128 tiles at 128x128; 240x320, which 8x128 tiles do not
# divide, on whole 8x64 tiles (and 8x128 for the decode alone, below);
# 9x130 tiles, where at 8 and 4 bits a word straddles two tiles; at 1 bit,
# 8x128 tiles, where 8 lanes build one word, and 8x48 tiles, where a word
# straddles two tiles
QUANT_TILE_CASES = ([(128, 128, 8, 128, b) for b in (16, 8, 4, 2, 1)]
                    + [(240, 320, 8, 64, b) for b in (16, 8, 4, 2)]
                    + [(18, 260, 9, 130, 16), (18, 260, 9, 130, 8), (18, 520, 9, 130, 4),
                       (16, 192, 8, 48, 1)])


def _quant_pair(h, w, lo, hi, bits, device, block_h, seed):
    """(frame, ref): the ref from ``_quant_planes`` (ties, NaN, +-inf,
    -0.0 in row 1), the frame moved by half the range in columns 130-133
    of rows 0-3, in columns 126-129 of the second tile row and in the last
    pixel; a NaN against -inf and +inf against hi + 1 in the last tile row
    (the same codes, so no change)."""
    ref = _quant_planes(h, w, lo, hi, bits, device, b=1, seed=seed)[0]
    frame = ref.clone()
    half = (hi - lo) / 2
    frame[:4, 130:134] += half
    frame[block_h:block_h + 4, 126:130] += half
    frame[-1, -1] += half
    frame[-2, 1], ref[-2, 1] = float("nan"), float("-inf")
    frame[-2, 2], ref[-2, 2] = float("inf"), hi + 1.0
    # a NaN with a payload in both (code 0, so no change): the decode
    # copies the ref's bits where the tile is unchanged
    frame.view(torch.int32)[-3, 7] = ref.view(torch.int32)[-3, 7] = -4194305
    return frame, ref


def _off_alignment(t):
    """A copy of t whose data starts one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def _launch_delta(before):
    return {k: v - before[k] for k, v in ck.launches.items() if v != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,block_h,block_w,bits", QUANT_TILE_CASES)
def test_quant_encode_and_decode_launches_match_composition(cuda, h, w, block_h, block_w,
                                                            bits):
    """encode_frame and decode_frame are one launch each on the card and
    equal, bit for bit, the composition of standalone kernels they
    replace and the CPU's plain composition: on aligned planes, on planes
    one float off 16-byte alignment (the scalar paths), and for the
    decode with a mask one tile larger than the grid and with a NaN mask
    value."""
    lo, hi = 0.1, 10.0
    tile = dict(bits=bits, block_h=block_h, block_w=block_w)
    frame, ref = _quant_pair(h, w, lo, hi, bits, cuda, block_h, seed=bits + w)
    cw, cm = wire.encode_frame(frame.cpu(), ref.cpu(), lo, hi, **tile)
    assert 0 < float(cm.sum()) < cm.numel()
    for f, r in ((frame, ref), (_off_alignment(frame), _off_alignment(ref))):
        before = dict(ck.launches)
        words, mask = wire.encode_frame(f, r, lo, hi, **tile)
        out = wire.decode_frame(words, mask, r, lo, hi, **tile)
        assert _launch_delta(before) == {"quant_encode": 1, "quant_decode": 1}
        assert torch.equal(words.cpu(), cw) and _bit_equal(mask.cpu(), cm)
        old_words, old_mask = _old_quant_encode(f, r, lo, hi, bits, block_h, block_w)
        assert torch.equal(words, old_words) and _bit_equal(mask, old_mask)
        big = torch.nn.functional.pad(mask, (0, 1, 0, 1), value=1.0)
        odd = mask.clone()
        odd[0, 0] = float("nan")
        for m in (mask, big, odd):
            got = out if m is mask else wire.decode_frame(words, m, r, lo, hi, **tile)
            assert _bit_equal(got, _old_quant_decode(words, m, r, lo, hi, bits, block_h,
                                                     block_w))
            assert _bit_equal(got.cpu(), wire.decode_frame(cw, m.cpu(), ref.cpu(), lo, hi,
                                                           **tile))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [16, 8, 4, 2])
def test_quant_decode_launch_on_ragged_tiles_matches_composition(cuda, bits):
    """At 240x320 on 8x128 tiles (a ragged last column of tiles) the
    encode raises before any launch, as the reference's does, and the
    one-launch decode equals K7 and the select on the ceil-grid mask."""
    lo, hi = 0.1, 10.0
    frame, ref = _quant_pair(240, 320, lo, hi, bits, cuda, 8, seed=bits)
    before = dict(ck.launches)
    with pytest.raises(ValueError, match="not divisible"):
        wire.encode_frame(frame, ref, lo, hi, bits=bits)
    assert ck.launches == before
    words, mask = _old_quant_encode(frame, ref, lo, hi, bits, 8, 128)
    assert mask.shape == (30, 3) and 0 < float(mask.sum()) < mask.numel()
    for r in (ref, _off_alignment(ref)):
        out = wire.decode_frame(words, mask, r, lo, hi, bits=bits)
        assert _bit_equal(out, _old_quant_decode(words, mask, r, lo, hi, bits, 8, 128))
        assert _bit_equal(out.cpu(), wire.decode_frame(words.cpu(), mask.cpu(), ref.cpu(),
                                                       lo, hi, bits=bits))


RECON_CASES = [(128, 128, 8, 128), (240, 322, 8, 128), (240, 320, 32, 64), (240, 322, 9, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("threshold", [0.0, 0.01])
@pytest.mark.parametrize("h,w,block_h,block_w", RECON_CASES)
def test_delta_encode_recon_matches_k3_then_k4(cuda, h, w, block_h, block_w, threshold):
    """K3 with the reconstruction equals K3 then K4 and the CPU's plain
    versions bit for bit (the NaN and signed-zero tiles keep the old
    reference's bits), in one launch counted as K3's, on aligned planes,
    at a width not a multiple of 4 and one float off alignment (the
    scalar path), and on tiles of over 1,024 pixels."""
    frame, ref = _codec_pair(h, w, cuda, seed=h + w)
    tile = dict(threshold=threshold, block_h=block_h, block_w=block_w)
    for f, r in ((frame, ref), (_off_alignment(frame), _off_alignment(ref))):
        before = dict(ck.launches)
        delta, mask, recon = ck._delta_encode_recon(f, r, **tile)
        assert _launch_delta(before) == {"delta_encode": 1, "delta_encode_recon": 1}
        k3_delta, k3_mask = ck.delta_encode(f, r, **tile)
        assert torch.equal(delta, k3_delta) and _bit_equal(mask, k3_mask)
        assert _bit_equal(recon, ck.delta_decode(delta, r))
        pd, pm, pr = ck._delta_encode_recon(f.cpu(), r.cpu(), **tile)
        assert torch.equal(delta.cpu(), pd) and _bit_equal(mask.cpu(), pm)
        assert _bit_equal(recon.cpu(), pr)
        assert recon.data_ptr() != r.data_ptr() and mask[0, 0] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(128, 128), (240, 320), (240, 322)])
def test_delta_decode_pair_matches_k4(cuda, h, w):
    """The two-output K4 writes K4's result twice in one launch, bit for
    bit against K4 and the plain version on the CPU: on aligned planes,
    one float off alignment and at an odd word count."""
    frame, ref = _codec_pair(h, w, cuda, seed=h + w)
    delta, _ = ck.delta_encode(frame, ref, threshold=0.01)
    odd = (delta[:-1, :-1].contiguous(), ref[:-1, :-1].contiguous())
    for d, r in ((delta, ref), (_off_alignment(delta), _off_alignment(ref)), odd):
        before = dict(ck.launches)
        state, copy = ck._delta_decode_pair(d, r)
        assert _launch_delta(before) == {"delta_decode": 1, "delta_decode_pair": 1}
        want = ck.delta_decode_plain(d.cpu(), r.cpu())
        assert _bit_equal(state.cpu(), want) and _bit_equal(copy.cpu(), want)
        assert _bit_equal(ck.delta_decode(d, r), state)
        assert state.data_ptr() != copy.data_ptr()


@pytest.mark.gpu
@pytest.mark.parametrize("threshold", [0.0, 0.01])
def test_stream_machines_on_the_card_launch_once_a_delta(cuda, threshold):
    """On the card each delta frame is one launch of K3 that also writes
    the encoder's next reference and one two-output launch of K4 in the
    decoder; the decoded frames equal the CPU's stream bit for bit and
    stay copies."""
    rng = np.random.default_rng(4)
    base = rng.normal(0.5, 0.1, (32, 256)).astype(np.float32)
    frames = []
    for t in range(9):
        f = base.copy()
        f[(t * 3) % 32: (t * 3) % 32 + 4, :16] += 0.05
        f[20, 200 + t] += 0.001 * t
        frames.append(torch.from_numpy(f))
    card = (wire.DeltaStreamEncoder(keyframe_interval=5, threshold=threshold),
            wire.DeltaStreamDecoder())
    host = (wire.DeltaStreamEncoder(keyframe_interval=5, threshold=threshold),
            wire.DeltaStreamDecoder())
    for f in frames:
        before = dict(ck.launches)
        packet = card[0].encode(f.to(cuda))
        out = card[1].decode(packet)
        want = host[1].decode(host[0].encode(f))
        if packet.kind == "delta":
            assert _launch_delta(before) == {"delta_encode": 1, "delta_encode_recon": 1,
                                             "delta_decode": 1, "delta_decode_pair": 1}
        assert out.is_cuda and _bit_equal(out.cpu(), want)
        out.add_(1.0)  # the decoder's state is another tensor


# K5's launches: (h, w, block_h, block_w), on widths that are and are not
# multiples of 4, ragged tiles included
WIDTH_CASES = [(128, 128, 8, 128), (128, 128, 32, 64), (240, 322, 8, 128), (240, 320, 32, 64),
               (240, 322, 9, 130), (128, 128, 9, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,block_h,block_w", WIDTH_CASES)
def test_bit_width_kernel_paths_match_plain(cuda, h, w, block_h, block_w):
    """K5b (B = 4) and K5, one warp a tile, bit for bit against the plain
    version on the CPU copy, on aligned planes and one word off 16-byte
    alignment; a sign-bit tile reads 32 and an all-zero tile 0; K5b's
    rows equal K5."""
    deltas = _residual_planes(h, w, cuda, seed=h + w)
    deltas[:, :block_h, -block_w:] = 0  # tile (0, -1) all zero: width 0
    deltas[:, block_h, -1] = -1  # tile (1, -1) holds a sign-bit word: width 32
    tiles = (-(-h // block_h), -(-w // block_w))
    for d in (deltas, _off_alignment(deltas)):
        want = ck.significant_bit_widths_plain(d.cpu(), block_h=block_h, block_w=block_w)
        assert want.shape == (4, *tiles)
        assert bool((want[:, 0, -1] == 0).all()) and bool((want[:, 1, -1] == 32).all())
        before = dict(ck.launches)
        got = ck.significant_bit_widths_batched(d, block_h=block_h, block_w=block_w)
        assert _launch_delta(before) == {"significant_bit_widths_batched": 1}
        assert torch.equal(got.cpu(), want)
        for i in range(4):
            assert torch.equal(ck.significant_bit_widths(d[i], block_h=block_h,
                                                         block_w=block_w), got[i])


WIDTHS_LAUNCH_CASES = [(128, 128, 8, 128), (240, 322, 8, 128), (240, 320, 32, 64),
                       (240, 322, 9, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("threshold", [0.0, 0.01])
@pytest.mark.parametrize("h,w,block_h,block_w", WIDTHS_LAUNCH_CASES)
def test_delta_encode_widths_matches_k3_then_k5(cuda, h, w, block_h, block_w, threshold):
    """K3 and K3b (B = 4) with the widths equal K3 then K5, and K3b then
    K5b, and the CPU's plain composition bit for bit: delta, mask and
    widths, with the NaN and signed-zero tiles (width 0), on aligned
    planes, at a width not a multiple of 4 and one float off alignment
    (the scalar path), and on tiles of over 1,024 pixels; each a launch
    counted as K3's or K3b's, the batched one through the entropy stage's
    wire.entropy_residuals; K3b's rows equal K3's."""
    frames, refs = _codec_pair(h, w, cuda, b=4, seed=h + w)
    tile = dict(threshold=threshold, block_h=block_h, block_w=block_w)
    for f, r in ((frames, refs), (_off_alignment(frames), _off_alignment(refs))):
        before = dict(ck.launches)
        delta, mask, widths = wire.entropy_residuals(f, r, **tile)
        assert _launch_delta(before) == {"delta_encode_batched": 1, "delta_encode_widths": 1}
        k3_delta, k3_mask = ck.delta_encode_batched(f, r, **tile)
        k5 = ck.significant_bit_widths_batched(k3_delta, block_h=block_h, block_w=block_w)
        assert torch.equal(delta, k3_delta) and _bit_equal(mask, k3_mask)
        assert torch.equal(widths, k5) and widths[0, 0, 0] == 0
        pd, pm, pw = ck._delta_encode_widths(f.cpu(), r.cpu(), **tile)
        assert torch.equal(delta.cpu(), pd) and _bit_equal(mask.cpu(), pm)
        assert torch.equal(widths.cpu(), pw)
        for i in range(4):
            before = dict(ck.launches)
            di, mi, wi = ck._delta_encode_widths(f[i], r[i], **tile)
            assert _launch_delta(before) == {"delta_encode": 1, "delta_encode_widths": 1}
            assert torch.equal(di, delta[i]) and _bit_equal(mi, mask[i])
            assert torch.equal(wi, widths[i])


@pytest.mark.gpu
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.1, 10.0)])
@pytest.mark.parametrize("h,w", [(128, 128), (240, 320)])
def test_quantize_pack_recon_matches_k6_then_k7(cuda, h, w, lo, hi):
    """K6's keyframe launch at every packable width equals K6 then K7 and
    the CPU's plain composition bit for bit (words, and the
    reconstruction's bits), on planes with ties, NaN, +-inf and -0.0,
    aligned and one float off 16-byte alignment (the scalar path); it is
    one launch, counted as K6's, through wire.encode_keyframe."""
    for bits in cref.PACKABLE_BITS:
        x = _quant_planes(h, w, lo, hi, bits, cuda, b=1, seed=bits + h)[0]
        for plane in (x, _off_alignment(x)):
            before = dict(ck.launches)
            words, recon = wire.encode_keyframe(plane, lo, hi, bits=bits)
            assert _launch_delta(before) == {"quantize_pack": 1, "quantize_pack_recon": 1}
            k6 = ck.quantize_pack(plane, lo, hi, bits=bits)
            assert torch.equal(words, k6)
            assert _bit_equal(recon, ck.unpack_dequantize(k6, lo, hi, bits=bits))
            pw, pr = ck._quantize_pack_recon(plane.cpu(), lo, hi, bits=bits)
            assert torch.equal(words.cpu(), pw) and _bit_equal(recon.cpu(), pr)
            assert recon.shape == (h, w) and recon.data_ptr() != plane.data_ptr()


@pytest.mark.gpu
def test_offload_path_on_the_card_launches_k1_and_k2(cuda):
    """The offload path on the card: ``measure_wrapper`` fits a finite,
    positive call overhead and staging bandwidth from pinned round trips,
    and one deployment of the paper's grid (the laptop, native: it drops
    frames) through ``executed_run`` at a small size processes the frames
    ``analytic_run`` replays for the same plan and seed.  Its step, the
    frame captured into a CUDA graph, runs K1 31 and K2 30 times on the
    card a processed frame and once more in its warm-up, by the
    profiler's kernel records; the wrappers launch them in the warm-up
    and the capture (K2 with the projection fused)."""
    from repro_torch.core import pso, tracker, wrapper
    from repro_torch.data import rgbd
    from repro_torch.examples import edge_offload_serve as serve
    from repro_torch.sim import hardware, runtime

    fit = wrapper.measure_wrapper(device=cuda)
    for value in (fit.call_overhead, fit.serialization_bandwidth):
        assert np.isfinite(value) and value > 0
    cam = Camera(width=64, height=64, fx=60.0, fy=60.0, cx=31.5, cy=31.5)
    frames, truth = rgbd.render_sequence(
        rgbd.SequenceConfig(num_frames=12, camera=cam, fast_burst=(4, 8)), device=cuda)
    cfg = tracker.TrackerConfig(camera=cam, pso=pso.PSOConfig(num_particles=16,
                                                              num_generations=30))
    comp = hardware.paper_staged()
    name, env, policy, gran = serve.deployments()[2]
    assert name == "local/laptop/native"
    rs.launches = 0
    pu.launches = pu.launches_projected = 0
    res, runs = _build.kernel_runs(
        lambda: runtime.executed_run(cfg, env, policy, frames, truth, gran, timing_comp=comp,
                                     device=cuda), ("render_score_kernel", "pso_update_kernel"))
    n = len(res.sim.stats.processed)
    replay = runtime.analytic_run(comp, env, policy, gran, 12, seed=0)
    assert 0 < n < 12
    assert [e.index for e in res.sim.stats.processed] == [e.index for e in replay.stats.processed]
    assert runs == {"render_score_kernel": 31 * (n + 1), "pso_update_kernel": 30 * (n + 1)}
    assert (rs.launches, pu.launches, pu.launches_projected) == (62, 60, 60)
    assert np.isfinite(res.mean_pos_error)


def _fleet_view(res):
    """A fleet result's events, per-client frames, waits and codec
    points, and per-edge loads, comparable with ``==`` across the two
    engines of the port."""
    return (res.events, res.duration,
            [(c.edge, c.total_wait, c.rate_changes, list(c.stats.processed), c.codec)
             for c in res.clients],
            res.edges, res.links)


@pytest.mark.gpu
def test_fleet_under_the_cards_density_calibration(cuda):
    """The rate controller's motion -> density fit calibrated on the card
    (one mask-only K3b launch) arms the ``codec`` golden config's fleet
    (fleet_star 3 x 2, 6 clients, 40 frames, the sequence's motion): both
    engines agree event for event, and with the same fleet under the
    CPU's fit."""
    from repro_torch.cluster import PlanCache, run_fleet
    from repro_torch.codec import rate
    from repro_torch.sim import hardware

    before = dict(ck.launches)
    fit = rate.calibrate_density_map(device=cuda)
    assert ck.launches["delta_encode_batched"] - before["delta_encode_batched"] == 1
    assert ck.launches["delta_encode_mask_only"] - before["delta_encode_mask_only"] == 1
    cpu_fit = rate.calibrate_density_map(device="cpu")
    topo, comp = hardware.fleet_star(num_edges=3, edge_capacity=2), hardware.paper_staged()
    views = []
    for gain, floor in (fit, cpu_fit):
        codec = rate.CodecConfig(base=hardware.codec_point(), motion=rate.sequence_motion(),
                                 density_gain=gain, density_floor=floor)
        for engine in ("object", "vector"):
            views.append(_fleet_view(run_fleet(topo, comp, num_clients=6, num_frames=40,
                                               codec=codec, engine=engine,
                                               cache=PlanCache())))
    assert views[0][0] > 0 and all(c[4] is not None for c in views[0][2])
    assert all(v == views[0] for v in views[1:])
