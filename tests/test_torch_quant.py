"""The port's quantized wire format against the JAX reference: the
quantizer and its inverse (K6, K6b and K7 paths, and K6's keyframe launch
with K7's values), ``encode_frame`` and ``decode_frame``, the entropy
stage's per-tile widths (K5, K5b, and K3/K3b's launch with the widths)
and the host entropy coder.

Inputs are numpy arrays made from a seed and handed to both packages.
Every comparison is bit for bit (``np.array_equal`` on the int32 words,
codes and widths, and on the float32 values' bit patterns) and the
entropy coder byte for byte: the codec rounds once per operation, in
the same order, so there is nothing to allow for.

The port follows the reference's jnp oracle (``repro.codec.ref``): a
true float32 division rounded half to even, and the dequantization as a
rounded multiply then a rounded add.  The reference's Pallas kernels
(``repro.codec.kernels``, run in interpret mode) agree with the oracle on
the reference test's own inputs, (lo, hi) = (0, 1) without ties, and the
port is held against them there; at half-step ties and at lo != 0 they
differ from the oracle, and ``test_reference_kernels_differ_from_the_oracle``
pins that difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import kernels as jck
from repro.codec import ref as jcr
from repro_torch import codec as tcodec
from repro_torch.codec import kernels as tck
from repro_torch.codec import ref as tcr
from repro_torch.codec import wire as twire

RANGES = [(0.0, 1.0), (0.1, 10.0)]
KINDS = ["random", "ties", "specials"]
H, W = 16, 256  # whole (8, 128) tiles: the reference's oracle is shape-strict


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _plane(kind, lo, hi, bits, h=H, w=W, seed=0):
    """A float32 plane of one kind: ``random`` spans 10% beyond [lo, hi]
    on both sides; ``ties`` puts ``lo + (k + 1/2) * step`` in every other
    row; ``specials`` adds NaN, +-inf, -0.0, the range's ends and points
    just outside them to the random plane."""
    rng = np.random.default_rng(seed + bits)
    span = hi - lo
    x = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, (h, w)).astype(np.float32)
    if kind == "ties":
        step = np.float32(jcr.quant_step(lo, hi, bits))
        k = rng.integers(0, (1 << bits) - 1, (h // 2, w))
        x[::2] = np.float32(lo) + (k + 0.5).astype(np.float32) * step
    elif kind == "specials":
        x[0, :12] = [np.nan, np.inf, -np.inf, -0.0, 0.0, lo, hi, lo - 1.0, hi + 1.0,
                     np.nextafter(np.float32(hi), np.float32(np.inf)),
                     np.nextafter(np.float32(lo), np.float32(-np.inf)), np.nan]
    return x


def _tie_mask(x, lo, hi, bits) -> np.ndarray:
    """The pixels that sit exactly half a step between two codes."""
    step = np.float32(jcr.quant_step(lo, hi, bits))
    q = (np.clip(x, np.float32(lo), np.float32(hi)) - np.float32(lo)) / step
    return q - np.floor(q) == 0.5


def _exact_ties(x, lo, hi, bits) -> int:
    return int(np.sum(_tie_mask(x, lo, hi, bits)))


def _without_ties(x, lo, hi, bits) -> np.ndarray:
    """x with each exact tie moved up by one ulp until none is left."""
    x = x.copy()
    while (ties := _tie_mask(x, lo, hi, bits)).any():
        x[ties] = np.nextafter(x[ties], np.float32(np.inf))
    return x


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("bits", tcr.PACKABLE_BITS)
def test_quantizer_matches_reference_oracle(bits, lo, hi, kind):
    """ref.quantize_pack, the K6/K6b wrappers and their plain version
    equal the jnp oracle word for word; ref.unpack_dequantize and the K7
    wrapper equal its inverse bit for bit; the roundtrip is within half a
    step of the clipped plane, and NaN reads back as lo."""
    x = _plane(kind, lo, hi, bits, seed=7)
    if kind == "ties":
        assert _exact_ties(x, lo, hi, bits) > 0
    want = np.asarray(jcr.quantize_pack(jnp.asarray(x), lo, hi, bits=bits))
    t = torch.from_numpy(x)
    got = tcr.quantize_pack(t, lo, hi, bits=bits)
    assert got.dtype == torch.int32 and got.shape == (H, W * bits // 32)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tck.quantize_pack(t, lo, hi, bits=bits).numpy(), want)
    assert np.array_equal(tck.quantize_pack_plain(t, lo, hi, bits=bits).numpy(), want)
    batched = tck.quantize_pack_batched(torch.stack([t, t.flip(0)]), lo, hi, bits=bits)
    assert np.array_equal(batched[0].numpy(), want)

    back = np.asarray(jcr.unpack_dequantize(jnp.asarray(want), lo, hi, bits=bits))
    for port in (tcr.unpack_dequantize(got, lo, hi, bits=bits),
                 tck.unpack_dequantize(got, lo, hi, bits=bits)):
        assert port.dtype == torch.float32 and port.shape == (H, W)
        assert np.array_equal(_bits(port.numpy()), _bits(back))
    step = jcr.quant_step(lo, hi, bits)
    clipped = np.clip(np.nan_to_num(x, nan=lo), np.float32(lo), np.float32(hi))
    err = np.abs(back.astype(np.float64) - clipped)
    assert err.max() <= step / 2 + 2 * np.spacing(np.float32(hi))


def test_special_values_pack_as_the_reference_does():
    """NaN -> code 0, +inf -> the top code, -inf and -0.0 -> 0: the
    reference packs [NaN, +inf, -inf, -0.0] at bits 8 in (0, 1) to 0xff00."""
    x = np.array([[np.nan, np.inf, -np.inf, -0.0]], np.float32)
    want = np.asarray(jcr.quantize_pack(jnp.asarray(x), 0.0, 1.0, bits=8,
                                        block_h=1, block_w=4))
    got = tck.quantize_pack(torch.from_numpy(x), 0.0, 1.0, bits=8)
    assert int(want[0, 0]) == 0xFF00 and np.array_equal(got.numpy(), want)
    # at bits 16 the top code sets the sign bit of the int32 word
    top = tck.quantize_pack(torch.tensor([[0.0, 1.0]]), 0.0, 1.0, bits=16)
    assert int(top[0, 0]) == -65536


@pytest.mark.parametrize("bits", tcr.PACKABLE_BITS)
def test_quantizer_matches_reference_kernels_on_their_inputs(bits):
    """Against the Pallas kernels, on the reference test's own inputs:
    (0, 1), random, no ties (tests/test_codec.py), on an aligned and an
    unaligned plane; the batched grid and vmap paths too."""
    rng = np.random.default_rng(bits)
    for h, w in ((48, 256), (20, 192)):
        x = _without_ties(rng.normal(0.5, 0.1, (h, w)).astype(np.float32), 0.0, 1.0, bits)
        want = np.asarray(jck.quantize_pack(jnp.asarray(x), 0.0, 1.0, bits=bits))
        got = tck.quantize_pack(torch.from_numpy(x), 0.0, 1.0, bits=bits)
        assert got.shape == (h, w * bits // 32) and np.array_equal(got.numpy(), want)
        back = jck.unpack_dequantize(jnp.asarray(want), 0.0, 1.0, bits=bits)
        port = tck.unpack_dequantize(got, 0.0, 1.0, bits=bits)
        assert np.array_equal(_bits(port.numpy()), _bits(back))
    xs = _without_ties(rng.normal(0.5, 0.1, (3, 20, 192)).astype(np.float32), 0.0, 1.0, bits)
    want = np.asarray(jck.quantize_pack_batched(jnp.asarray(xs), 0.0, 1.0, bits=bits))
    for path in ("grid", "vmap"):
        got = tck.quantize_pack_batched(torch.from_numpy(xs), 0.0, 1.0, bits=bits, path=path)
        assert np.array_equal(got.numpy(), want)


def test_reference_kernels_differ_from_the_oracle():
    """The reference's two quantizers disagree with each other where the
    port follows the oracle: at exact half-step ties the Pallas path
    rounds as a multiply by 1/step, and at lo != 0 its dequantization is
    a fused multiply-add, 1 ulp off the oracle's two roundings."""
    lo, hi, bits = 0.1, 10.0, 8
    x = _plane("ties", lo, hi, bits, h=16, w=256, seed=3)
    oracle = np.asarray(jcr.quantize_pack(jnp.asarray(x), lo, hi, bits=bits))
    pallas = np.asarray(jck.quantize_pack(jnp.asarray(x), lo, hi, bits=bits))
    port = tck.quantize_pack(torch.from_numpy(x), lo, hi, bits=bits).numpy()
    assert np.array_equal(port, oracle)
    assert not np.array_equal(pallas, oracle)  # the ties move

    one_tie = np.zeros((8, 128), np.float32)
    one_tie[0, 0] = 0.59179825  # (x - 0) / step = 38783.5 at bits 16 in (0, 1)
    tie_oracle = jcr.quantize_pack(jnp.asarray(one_tie), 0.0, 1.0, bits=16)
    tie_pallas = jck.quantize_pack(jnp.asarray(one_tie), 0.0, 1.0, bits=16)
    tie_port = tck.quantize_pack(torch.from_numpy(one_tie), 0.0, 1.0, bits=16)
    assert int(tie_oracle[0, 0]) & 0xFFFF == 38784 == int(tie_port[0, 0]) & 0xFFFF
    assert int(tie_pallas[0, 0]) & 0xFFFF == 38783

    oracle_v = _bits(jcr.unpack_dequantize(jnp.asarray(port), lo, hi, bits=bits))
    pallas_v = _bits(jck.unpack_dequantize(jnp.asarray(port), lo, hi, bits=bits))
    port_v = _bits(tck.unpack_dequantize(torch.from_numpy(port), lo, hi, bits=bits).numpy())
    assert np.array_equal(port_v, oracle_v)
    ulps = np.abs(pallas_v.astype(np.int64) - oracle_v.astype(np.int64))
    assert ulps.max() == 1  # differ, by one ulp at most


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("bits", tcr.PACKABLE_BITS)
def test_encode_and_decode_frame_match_reference(bits, lo, hi, kind):
    """ref.encode_frame/decode_frame and wire's (the kernels' composition,
    on their plain versions here) equal the reference bit for bit, on a
    pair that differs in one tile block and in scattered pixels."""
    ref_plane = _plane(kind, lo, hi, bits, seed=11)
    frame = ref_plane.copy()
    frame[8:16, :128] += np.float32(0.05 * (hi - lo))
    frame[3, 200] += np.float32(0.4 * (hi - lo))
    jw, jm = jcr.encode_frame(jnp.asarray(frame), jnp.asarray(ref_plane), lo, hi, bits=bits)
    jo = jcr.decode_frame(jw, jm, jnp.asarray(ref_plane), lo, hi, bits=bits)
    f, r = torch.from_numpy(frame), torch.from_numpy(ref_plane)
    for pkg in (tcr, twire):
        tw, tm = pkg.encode_frame(f, r, lo, hi, bits=bits)
        assert np.array_equal(tw.numpy(), np.asarray(jw))
        assert tm.dtype == torch.float32 and np.array_equal(tm.numpy(), np.asarray(jm))
        to = pkg.decode_frame(tw, tm, r, lo, hi, bits=bits)
        assert np.array_equal(_bits(to.numpy()), _bits(jo))
    assert tcodec.encode_frame is twire.encode_frame


@pytest.mark.parametrize("h,w", [(8, 132), (12, 128)])
def test_encode_frame_rejects_planes_of_partial_tiles(h, w):
    """A plane that is not a whole number of (8, 128) tiles: the
    reference's encode_frame raises, and so do the port's, on the plain
    versions here (on the card, before any launch)."""
    rng = np.random.default_rng(h + w)
    frame, ref_plane = rng.uniform(0.0, 1.0, (2, h, w)).astype(np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        jcr.encode_frame(jnp.asarray(frame), jnp.asarray(ref_plane), 0.0, 1.0, bits=16)
    for pkg in (tcr, twire):
        with pytest.raises(ValueError, match="not divisible"):
            pkg.encode_frame(torch.from_numpy(frame), torch.from_numpy(ref_plane), 0.0, 1.0,
                             bits=16)


def _moved_pair(h, w, lo, hi, seed):
    """(frame, ref) over 10% beyond [lo, hi] with NaN and +-inf in row 1
    of both (they quantize alike).  The frame moves by 5% of the range
    in its last pixel, in columns 130-133 of rows 0-3 and in columns
    126-129 of rows 9-12: on 9x130 tiles the two sides of the words that
    straddle column 130, each with the tile across the edge unchanged."""
    rng = np.random.default_rng(seed)
    span = hi - lo
    ref_plane = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, (h, w)).astype(np.float32)
    ref_plane[1, 5:8] = [np.nan, np.inf, -np.inf]
    frame = ref_plane.copy()
    frame[:4, 130:134] += np.float32(0.05 * span)
    frame[9:13, 126:130] += np.float32(0.05 * span)
    frame[-1, -1] += np.float32(0.05 * span)
    return frame, ref_plane


# (h, w, bits, (block_h, block_w)): at 8 bits on 9x130 tiles the word of
# pixels 128-131 straddles two tiles, at 4 bits on 9x130 tiles the words
# of pixels 128-135 and 256-263; 4 and 2 bits on 8x128 tiles share a word
# among 2 and 4 lanes on the card; at 1 bit on 8x48 tiles the words of
# pixels 32-63 and 128-159 straddle two tiles
TILE_SHAPES = [(18, 260, 8, (9, 130)), (18, 520, 4, (9, 130)), (72, 130, 16, (9, 130)),
               (16, 256, 4, (8, 128)), (16, 256, 2, (8, 128)), (16, 192, 1, (8, 48))]


@pytest.mark.parametrize("h,w,bits,block", TILE_SHAPES)
def test_encode_and_decode_frame_match_reference_on_tile_shapes(h, w, bits, block):
    """encode_frame/decode_frame of the port's oracle and of wire equal
    the reference's bit for bit on whole tiles of other shapes, straddling
    words included; decode_frame also with a NaN mask value (the tile
    keeps the reference) and with a mask one tile larger than the grid
    (cropped)."""
    lo, hi = 0.1, 10.0
    bh, bw = block
    frame, ref_plane = _moved_pair(h, w, lo, hi, seed=h + w + bits)
    tile = dict(bits=bits, block_h=bh, block_w=bw)
    jw, jm = jcr.encode_frame(jnp.asarray(frame), jnp.asarray(ref_plane), lo, hi, **tile)
    assert 0 < float(jnp.sum(jm)) < jm.size
    big = np.pad(np.array(jm), ((0, 1), (0, 1)), constant_values=1.0)
    odd = np.array(jm)
    odd[0, 0] = np.nan
    f, r = torch.from_numpy(frame), torch.from_numpy(ref_plane)
    for pkg in (tcr, twire):
        tw, tm = pkg.encode_frame(f, r, lo, hi, **tile)
        assert np.array_equal(tw.numpy(), np.asarray(jw))
        assert tm.dtype == torch.float32 and np.array_equal(tm.numpy(), np.asarray(jm))
        for mask in (np.array(jm), big, odd):
            jo = jcr.decode_frame(jw, jnp.asarray(mask), jnp.asarray(ref_plane), lo, hi, **tile)
            to = pkg.decode_frame(tw, torch.from_numpy(mask), r, lo, hi, **tile)
            assert np.array_equal(_bits(to.numpy()), _bits(jo))


def test_composed_format_realizes_the_model_ratio():
    """tests/test_codec.py's identity for the port: exact wire bytes of a
    quantized delta frame are the header, change_density * bits/32 of the
    raw bytes, and the mask bits, within 8 B; an identical frame ships
    only mask + header and decodes to the reference."""
    rng = np.random.default_rng(0)
    ref_plane = rng.normal(0.5, 0.1, (48, 256)).astype(np.float32)
    frame = ref_plane.copy()
    frame[8:16, 0:128] += 0.05
    lo, hi, bits = 0.0, 1.0, 8
    f, r = torch.from_numpy(frame), torch.from_numpy(ref_plane)
    words, mask = twire.encode_frame(f, r, lo, hi, bits=bits)
    recon = twire.decode_frame(words, mask, r, lo, hi, bits=bits)
    step = tcr.quant_step(lo, hi, bits)
    assert float((recon - f.clamp(lo, hi)).abs().max()) <= step / 2 + 1e-7
    exact = tcr.encoded_nbytes_exact(mask, bits=bits, header_nbytes=64)
    modeled = 64 + frame.size * 4 * float(mask.mean()) * bits / 32
    assert exact == pytest.approx(modeled + mask.numel() / 8, abs=8)
    w2, m2 = twire.encode_frame(f, f, lo, hi, bits=bits)
    assert float(m2.sum()) == 0.0
    out = twire.decode_frame(w2, m2, r, lo, hi, bits=bits)
    assert np.array_equal(_bits(out.numpy()), _bits(ref_plane))


def _entropy_cases():
    rng = np.random.default_rng(11)
    frame = rng.normal(0.5, 0.1, (48, 256)).astype(np.float32)
    moved = frame.copy()
    moved[8:16, :128] += 0.05
    residual, _ = jcr.delta_encode(jnp.asarray(moved), jnp.asarray(frame))
    return [
        np.array(residual, np.int32),
        np.zeros(256, np.int32),
        np.full(513, -1, np.int32),  # all bits set, odd length
        rng.integers(-(2**31), 2**31, 1000).astype(np.int32),  # dense
        rng.integers(0, 4, 333).astype(np.int32),  # narrow widths
        np.array([], np.int32),
        np.array([7], np.int32),
    ]


@pytest.mark.parametrize("case", range(7))
def test_entropy_coder_matches_reference_byte_for_byte(case):
    """The adversarial cases of tests/test_codec.py and a real residual
    plane: the same bytes, the same decode, never over raw + 1."""
    words = _entropy_cases()[case]
    data = tcr.entropy_encode_words(words)
    assert data == jcr.entropy_encode_words(words)
    assert data == tcr.entropy_encode_words(torch.from_numpy(words))  # a tensor in
    assert len(data) <= words.size * 4 + 1
    back = tcr.entropy_decode_words(data, words.size)
    assert np.array_equal(back, jcr.entropy_decode_words(data, words.size))
    assert back.dtype == np.int32 and np.array_equal(back, words.ravel())
    assert tcr.entropy_encoded_nbytes(words) == jcr.entropy_encoded_nbytes(words) == len(data)
    for tile in (1, 7):
        assert tcr.entropy_encode_words(words, tile) == jcr.entropy_encode_words(words, tile)


def test_entropy_coder_rejects_garbage():
    with pytest.raises(ValueError):
        tcr.entropy_decode_words(b"", 4)
    with pytest.raises(ValueError):
        tcr.entropy_decode_words(bytes([9, 0, 0]), 2)
    with pytest.raises(ValueError):
        tcr.entropy_encode_words(np.zeros(8, np.int32), tile=0)
    assert tcr.ENTROPY_TILE == jcr.ENTROPY_TILE


def _residual(h, w, seed):
    rng = np.random.default_rng(seed)
    ref_plane = rng.normal(0.5, 0.1, (h, w)).astype(np.float32)
    frame = ref_plane.copy()
    frame[8:16, 0:128] += 0.05
    frame[-1, -1] += 1.0
    delta, _ = jcr.delta_encode(jnp.asarray(frame), jnp.asarray(ref_plane),
                                block_h=1, block_w=1)
    return np.array(delta, np.int32)


@pytest.mark.parametrize("block", [(8, 32), (8, 128)])
@pytest.mark.parametrize("h,w", [(48, 256), (20, 200)])
def test_significant_bit_widths_match_reference(h, w, block):
    """K5's wrapper and K5b's grid and vmap paths against the Pallas
    kernels, on a residual plane with extremes: a tile whose max word has
    the sign bit set (width 32) and an all-zero tile (width 0); an
    unaligned plane's pad tiles read 0."""
    bh, bw = block
    words = _residual(h, w, seed=h)
    words[:8, -bw:] = 0
    words[8, -1] = -1
    want = np.asarray(jck.significant_bit_widths(jnp.asarray(words), block_h=bh, block_w=bw))
    got = tck.significant_bit_widths(torch.from_numpy(words), block_h=bh, block_w=bw)
    assert got.dtype == torch.int32 and got.shape == (-(-h // bh), -(-w // bw))
    assert np.array_equal(got.numpy(), want)
    tiles = -(-w // bw)
    assert want[0, tiles - 1] == 0 and want[1, tiles - 1] == 32
    for i in range(want.shape[0]):  # each tile's max word, read as uint32
        for j in range(want.shape[1]):
            tile = words[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw]
            assert want[i, j] == int(tile.view(np.uint32).max()).bit_length()
    stack = np.stack([words, np.zeros_like(words), words[::-1].copy()])
    want_b = np.asarray(jck.significant_bit_widths_batched(jnp.asarray(stack),
                                                           block_h=bh, block_w=bw))
    for path in ("grid", "vmap"):
        got_b = tck.significant_bit_widths_batched(torch.from_numpy(stack), block_h=bh,
                                                   block_w=bw, path=path)
        assert np.array_equal(got_b.numpy(), want_b)


def test_quant_wrappers_validate_their_inputs():
    x = torch.zeros((16, 256))
    with pytest.raises(ValueError, match="pack ratio"):
        tck.quantize_pack(torch.zeros((16, 250)), 0.0, 1.0, bits=8)
    with pytest.raises(ValueError, match="pack ratio"):
        tck.quantize_pack_batched(torch.zeros((2, 16, 250)), 0.0, 1.0, bits=8)
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="bits"):
            tck.quantize_pack(x, 0.0, 1.0, bits=bad)
        with pytest.raises(ValueError, match="bits"):
            tck.unpack_dequantize(torch.zeros((16, 64), dtype=torch.int32), 0.0, 1.0, bits=bad)
        with pytest.raises(ValueError):
            tcr.quantize_pack(x, 0.0, 1.0, bits=bad)
    with pytest.raises(ValueError, match="unknown path"):
        tck.quantize_pack_batched(x[None], 0.0, 1.0, path="scan")
    with pytest.raises(ValueError, match="unknown path"):
        tck.significant_bit_widths_batched(torch.zeros((1, 8, 128), dtype=torch.int32),
                                           path="nope")
    with pytest.raises(ValueError):
        tck.quantize_pack(x[None], 0.0, 1.0)  # (B, H, W) where (H, W) is due
    with pytest.raises(TypeError):
        tck.unpack_dequantize(torch.zeros((16, 64), dtype=torch.int64), 0.0, 1.0)
    # K5 casts its input as the reference's astype(jnp.int32) does: a
    # float32 plane of 3.7 reads [[2]], an int64 plane of 5 [[3]]
    for plane in (np.full((8, 128), 3.7, np.float32), np.full((8, 128), 5, np.int64)):
        want = np.asarray(jck.significant_bit_widths(jnp.asarray(plane)))
        got = tck.significant_bit_widths(torch.from_numpy(plane))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert int(want[0, 0]) == (2 if plane.dtype == np.float32 else 3)
    with pytest.raises(ValueError, match="not divisible"):
        tcr.quantize_pack(torch.zeros((20, 200)), 0.0, 1.0)  # the oracle is shape-strict


# K5's input dtypes: the reference casts with astype(jnp.int32)
CAST_DTYPES = [np.int64, np.int16, np.uint8, np.float32]


@pytest.mark.parametrize("dtype", CAST_DTYPES)
def test_significant_bit_widths_cast_their_input_as_the_reference(dtype):
    """K5's wrapper and K5b's grid and vmap paths on planes that are not
    int32 equal the Pallas kernels, which cast with astype(jnp.int32):
    negative integers read width 32, a float truncates toward zero; the
    values stay inside int32 and finite."""
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    if dtype == np.float32:
        planes = rng.uniform(-3.0e4, 3.0e4, (2, 20, 200)).astype(dtype)
        planes[:, :8, :128] = rng.uniform(0.0, 9.9, (2, 8, 128))  # widths 0 to 4
    else:
        info = np.iinfo(dtype)
        lo, hi = max(info.min, -(2**31)), min(info.max, 2**31 - 1)
        planes = rng.integers(lo, hi, (2, 20, 200), endpoint=True).astype(dtype)
        planes[:, :8, :128] = rng.integers(0, min(hi, 100), (2, 8, 128))
    planes[1, 8:16, 128:] = 0
    want = np.asarray(jck.significant_bit_widths_batched(jnp.asarray(planes)))
    for path in ("grid", "vmap"):
        got = tck.significant_bit_widths_batched(torch.from_numpy(planes), path=path)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for i in range(2):
        solo = np.asarray(jck.significant_bit_widths(jnp.asarray(planes[i])))
        assert np.array_equal(solo, want[i])
        assert np.array_equal(tck.significant_bit_widths(torch.from_numpy(planes[i])).numpy(),
                              solo)
    assert want[1, 1, 1] == 0 and want[0, 0, 0] <= 7
    if np.issubdtype(dtype, np.signedinteger) or dtype == np.float32:
        assert want[0, 2, 1] == 32  # a negative word in a 4x72 edge tile


# float planes outside int32: (dtype, value) per tile of a (16, 384) plane
SATURATING = [np.nan, np.inf, -np.inf, 3.0e9, -3.0e9, 2.0**31, -(2.0**31), 1.0e20,
              2147483520.0, 1.9999999999]


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_significant_bit_widths_saturate_as_the_reference(dtype):
    """K5's and K5b's cast of a float plane equals the reference's
    astype(jnp.int32) where PyTorch's own float-to-int conversion does
    not: NaN reads as 0, values past the int32 range (infinities
    included) as its ends, and a float64 plane is taken as float32 first,
    as JAX takes it (1.9999999999 reads 2); one value a tile."""
    planes = np.zeros((2, 16, 640), dtype)
    with np.errstate(over="ignore"):  # float16 overflows the large values to +-inf
        for k, v in enumerate(SATURATING):
            planes[0, 8 * (k // 5):8 * (k // 5) + 8, 128 * (k % 5) + 3] = v
    planes[1] = -planes[0]
    want = np.asarray(jck.significant_bit_widths_batched(jnp.asarray(planes)))
    for path in ("grid", "vmap"):
        got = tck.significant_bit_widths_batched(torch.from_numpy(planes), path=path)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for i in range(2):
        got = tck.significant_bit_widths(torch.from_numpy(planes[i]))
        assert np.array_equal(got.numpy(), want[i])
    assert want[0, 0, 0] == 0 and want[0, 0, 1] == 31 and want[0, 0, 2] == 32
    if dtype == np.float64:
        assert want[0, 1, 4] == 2


def _widths_pair(bh, bw, seed, b=None):
    """(frame, ref) of (2 bh + 1, 2 bw + 2): 3x3 tiles, the last row and
    column of tiles ragged.  Noise of 2 mm everywhere; tile (0, 0)
    differs only by -0.0 against +0.0; tile (0, 1) moves by 5 cm but
    holds a NaN; tile (1, 0) has a pixel whose sign flips (an XOR word
    with the sign bit: width 32); tile (1, 1) moves by 5 cm."""
    rng = np.random.default_rng(seed)
    shape = (2 * bh + 1, 2 * bw + 2) if b is None else (b, 2 * bh + 1, 2 * bw + 2)
    ref = rng.normal(0.5, 0.1, shape).astype(np.float32)
    frame = ref + rng.normal(0.0, 0.002, shape).astype(np.float32)
    frame[..., :bh, :bw] = ref[..., :bh, :bw]
    ref[..., 0, 0], frame[..., 0, 0] = 0.0, -0.0
    frame[..., :bh, bw:2 * bw] += np.float32(0.05)
    frame[..., 1, bw + 1] = np.nan
    frame[..., bh, 0] = -ref[..., bh, 0]
    frame[..., bh:2 * bh, bw:2 * bw] += np.float32(0.05)
    return frame, ref


@pytest.mark.parametrize("threshold", [0.0, 0.01])
@pytest.mark.parametrize("block", [(8, 128), (32, 64), (9, 130)])
def test_delta_encode_widths_matches_reference(block, threshold):
    """K3's and K3b's launch with the widths, on its plain path, equals the
    Pallas delta_encode then significant_bit_widths (and the batched pair)
    bit for bit: delta, mask and widths, ragged edge tiles included, and
    so does the entropy stage's ``wire.entropy_residuals``.  The
    signed-zero and the NaN tile are unchanged, so their width is 0 where
    their XOR is not; the sign-flip tile reads 32."""
    bh, bw = block
    tile = dict(threshold=threshold, block_h=bh, block_w=bw)
    frame, ref_plane = _widths_pair(bh, bw, seed=bh + bw)
    jd, jm = jck.delta_encode(jnp.asarray(frame), jnp.asarray(ref_plane), **tile)
    jw = jck.significant_bit_widths(jd, block_h=bh, block_w=bw)
    d, m, w = tck._delta_encode_widths(torch.from_numpy(frame), torch.from_numpy(ref_plane),
                                       **tile)
    staged = twire.entropy_residuals(torch.from_numpy(frame), torch.from_numpy(ref_plane),
                                     **tile)
    assert all(torch.equal(a, b) for a, b in zip(staged, (d, m, w)))
    assert d.dtype == torch.int32 and w.dtype == torch.int32 and w.shape == (3, 3)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert np.array_equal(_bits(m.numpy()), _bits(jm))
    assert np.array_equal(w.numpy(), np.asarray(jw))
    assert w[0, 0] == 0 and w[0, 1] == 0 and w[1, 0] == 32 and m[1, 1] == 1
    xor = frame.view(np.int32) ^ ref_plane.view(np.int32)
    assert xor[:bh, :bw].any() and xor[:bh, bw:2 * bw].any()  # unchanged, not equal

    frames, refs = _widths_pair(bh, bw, seed=bh * bw, b=3)
    jd, jm = jck.delta_encode_batched(jnp.asarray(frames), jnp.asarray(refs), **tile)
    jw = jck.significant_bit_widths_batched(jd, block_h=bh, block_w=bw)
    d, m, w = twire.entropy_residuals(torch.from_numpy(frames), torch.from_numpy(refs), **tile)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert np.array_equal(_bits(m.numpy()), _bits(jm))
    assert np.array_equal(w.numpy(), np.asarray(jw))
    for i in range(3):
        di, mi, wi = tck._delta_encode_widths(torch.from_numpy(frames[i]),
                                              torch.from_numpy(refs[i]), **tile)
        assert torch.equal(di, d[i]) and torch.equal(mi, m[i]) and torch.equal(wi, w[i])


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("bits", tcr.PACKABLE_BITS)
def test_quantize_pack_recon_matches_reference_oracle(bits, lo, hi):
    """K6's keyframe launch, on its plain path, equals the jnp oracle's
    quantize_pack then unpack_dequantize: the words, and the
    reconstruction's bits, with ties, NaN, +-inf and -0.0 in the plane;
    the quantized uplink's ``wire.encode_keyframe`` gives the same."""
    for kind in ("ties", "specials"):
        x = _plane(kind, lo, hi, bits, seed=13)
        words = jcr.quantize_pack(jnp.asarray(x), lo, hi, bits=bits)
        back = jcr.unpack_dequantize(words, lo, hi, bits=bits)
        got_words, got_back = tck._quantize_pack_recon(torch.from_numpy(x), lo, hi, bits=bits)
        assert np.array_equal(got_words.numpy(), np.asarray(words))
        assert got_back.dtype == torch.float32 and got_back.shape == (H, W)
        assert np.array_equal(_bits(got_back.numpy()), _bits(back))
        key_words, key_back = twire.encode_keyframe(torch.from_numpy(x), lo, hi, bits=bits)
        assert torch.equal(key_words, got_words) and torch.equal(key_back, got_back)
