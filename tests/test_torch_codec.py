"""The port's temporal-delta codec (K3, K3b, K4 paths, the stream
machines and the wire accounting) against the JAX reference.

Inputs are numpy arrays made from a seed and handed to both packages;
the JAX side runs its Pallas kernels in interpret mode, as
``tests/test_codec.py`` does.  Every codec output is compared bit for
bit (``np.array_equal`` on the delta words, the float32 masks and the
decoded frames' bit patterns): the codec does integer XOR and one float
subtract per pixel, so there is no rounding to allow for.
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


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _pair(h, w, seed=0):
    """numpy (frame, ref): noise everywhere, a bigger move in one tile,
    a small one in another, a NaN in a moved tile, and a tile whose only
    difference is -0.0 against +0.0."""
    rng = np.random.default_rng(seed)
    ref = rng.normal(0.5, 0.1, (h, w)).astype(np.float32)
    frame = ref + rng.normal(0.0, 0.002, (h, w)).astype(np.float32)
    frame[:4, :16] += 0.2  # tile (0, 0) moves by more than any threshold
    frame[2, 3] = np.nan  # ... but holds a NaN, so it stays unchanged
    frame[8:16, :128] = ref[8:16, :128]  # tile (1, 0): only a signed zero
    ref[9, 3], frame[9, 3] = 0.0, -0.0
    frame[h - 1, w - 1] += 0.5  # the last (maybe ragged) tile moves
    return frame, ref


SHAPES = [(16, 256), (240, 320)]  # tile-aligned, and the paper's unaligned plane


@pytest.mark.parametrize("threshold", [0.0, 0.1])
@pytest.mark.parametrize("h,w", SHAPES)
def test_delta_encode_and_decode_match_reference(h, w, threshold):
    frame, ref = _pair(h, w, seed=h)
    jd, jm = jck.delta_encode(jnp.asarray(frame), jnp.asarray(ref), threshold=threshold)
    td, tm = tck.delta_encode(torch.from_numpy(frame), torch.from_numpy(ref),
                              threshold=threshold)
    assert td.dtype == torch.int32 and tm.dtype == torch.float32
    assert td.shape == (h, w) and tm.shape == (-(-h // 8), -(-w // 128))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert tm[0, 0] == 0 and tm[1, 0] == 0  # the NaN tile and the signed-zero tile
    assert tm[-1, -1] == 1
    jo = jck.delta_decode(jd, jnp.asarray(ref))
    to = tck.delta_decode(td, torch.from_numpy(ref))
    assert to.dtype == torch.float32 and to.shape == (h, w)
    assert np.array_equal(_bits(to.numpy()), _bits(jo))
    # changed tiles reconstruct bit for bit
    keep = np.repeat(np.repeat(tm.numpy() > 0, 8, 0), 128, 1)[:h, :w]
    assert np.array_equal(_bits(to.numpy())[keep], _bits(frame)[keep])
    if h % 8 == 0 and w % 128 == 0:  # the shape-strict oracle agrees too
        od, om = tcr.delta_encode(torch.from_numpy(frame), torch.from_numpy(ref),
                                  threshold=threshold)
        assert torch.equal(od, td) and torch.equal(om, tm)


@pytest.mark.parametrize("path", ["grid", "vmap"])
@pytest.mark.parametrize("h,w", SHAPES)
def test_delta_encode_batched_matches_reference(h, w, path):
    pairs = [_pair(h, w, seed=s) for s in range(3)]
    frames = np.stack([p[0] for p in pairs])
    refs = np.stack([p[1] for p in pairs])
    jd, jm = jck.delta_encode_batched(jnp.asarray(frames), jnp.asarray(refs),
                                      threshold=0.01)
    td, tm = tck.delta_encode_batched(torch.from_numpy(frames), torch.from_numpy(refs),
                                      threshold=0.01, path=path)
    assert td.shape == (3, h, w) and tm.shape == (3, -(-h // 8), -(-w // 128))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    for i in range(3):  # each client equals the unbatched wrapper
        d, m = tck.delta_encode(torch.from_numpy(frames[i]), torch.from_numpy(refs[i]),
                                threshold=0.01)
        assert torch.equal(td[i], d) and torch.equal(tm[i], m)


def test_codec_wrappers_reject_bad_path_and_shapes():
    frame, ref = (torch.from_numpy(a) for a in _pair(16, 256))
    with pytest.raises(ValueError, match="unknown path"):
        tck.delta_encode_batched(frame[None], ref[None], path="nope")
    with pytest.raises(ValueError):
        tck.delta_encode(frame, ref[:8])
    with pytest.raises(ValueError):
        tck.delta_encode_batched(frame[None], ref[None, :8])
    with pytest.raises(ValueError):
        tck.delta_decode(torch.zeros((16, 256), dtype=torch.int32), ref[:8])
    with pytest.raises(TypeError):
        tck.delta_decode(torch.zeros((16, 256), dtype=torch.int64), ref)
    # the shape-strict oracle refuses an unaligned plane, as the reference does
    with pytest.raises(ValueError, match="not divisible"):
        tcr.delta_encode(frame[:, :200], ref[:, :200])


@pytest.mark.parametrize("threshold", [0.0, 0.004, 0.1])
def test_change_density_and_wire_size_match_reference(threshold):
    rng = np.random.default_rng(5)
    frames = rng.normal(0.5, 0.002, (5, 20, 200)).astype(np.float32)  # unaligned
    frames[2, :8, :128] += 0.05
    ref_density = np.asarray(jcr.change_density(jnp.asarray(frames), threshold=threshold))
    port_density = tcodec.change_density(torch.from_numpy(frames), threshold=threshold)
    assert port_density.dtype == torch.float32
    assert np.array_equal(port_density.numpy(), ref_density)
    _, jm = jck.delta_encode(jnp.asarray(frames[1]), jnp.asarray(frames[0]),
                             threshold=threshold)
    _, tm = tck.delta_encode(torch.from_numpy(frames[1]), torch.from_numpy(frames[0]),
                             threshold=threshold)
    for kw in ({}, {"bits": 8, "header_nbytes": 12}, {"bits": 1}):
        assert tcr.encoded_nbytes_exact(tm, **kw) == jcr.encoded_nbytes_exact(jm, **kw)


def test_constants_and_helpers_match_reference():
    assert (tcr.DEFAULT_BLOCK_H, tcr.DEFAULT_BLOCK_W) == (jcr.DEFAULT_BLOCK_H,
                                                          jcr.DEFAULT_BLOCK_W)
    assert tcr.PACKABLE_BITS == jcr.PACKABLE_BITS
    for bits in jcr.PACKABLE_BITS:
        assert tcr._check_bits(bits) == jcr._check_bits(bits)
        assert tcr.quant_step(0.2, 1.5, bits) == jcr.quant_step(0.2, 1.5, bits)
    for bad in (0, 3, 32):
        with pytest.raises(ValueError):
            tcr._check_bits(bad)
    with pytest.raises(ValueError):
        tcr._check_blocks(20, 128, 8, 128)
    assert tcodec.DeltaStreamEncoder is twire.DeltaStreamEncoder
    assert not hasattr(tcr, "DeltaStreamEncoder")  # ref.py holds only plain versions


# ---------------------------------------------------------------------------
# stream machines, under the schedules of tests/test_codec.py
# ---------------------------------------------------------------------------


def _sequence(n=20, h=32, w=128, seed=2):
    """tests/test_codec.py's clip: a noisy base with a moving bright bar."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0.5, 0.1, (h, w)).astype(np.float32)
    frames = []
    for t in range(n):
        f = base.copy()
        f[(t * 3) % h: (t * 3) % h + 4, :16] += 0.05
        frames.append(f)
    return frames


def _run_stream(pkg, frames, enc_kwargs, lost=()):
    """Drive one package's encoder/decoder pair; the transport drops the
    packets whose seq is in ``lost`` and reports each loss."""
    enc = pkg.DeltaStreamEncoder(**enc_kwargs)
    dec = pkg.DeltaStreamDecoder()
    log = []
    for f in frames:
        pkt = enc.encode(torch.from_numpy(f) if pkg is tcodec else jnp.asarray(f))
        if pkt.seq in lost:
            enc.report_loss(pkt.seq)
            log.append((pkt.seq, pkt.kind, pkt.ref_seq, np.asarray(pkt.payload), None))
            continue
        out = dec.decode(pkt)
        log.append((pkt.seq, pkt.kind, pkt.ref_seq, np.asarray(pkt.payload),
                    None if out is None else np.asarray(out)))
    return enc, dec, log


@pytest.mark.parametrize("schedule", [
    ("resync", dict(keyframe_interval=16, resync_bound=3), (4,)),
    ("no_loss", dict(keyframe_interval=4, resync_bound=2), ()),
    ("two_losses_lossy", dict(keyframe_interval=6, resync_bound=2, threshold=0.01),
     (2, 9)),
    ("specials_lossy", dict(keyframe_interval=7, resync_bound=3, threshold=0.01), (5,)),
])
def test_stream_machines_match_reference(schedule):
    name, kwargs, lost = schedule
    frames = _sequence(n=12 if not lost else 20)
    if name == "specials_lossy":
        # NaN payloads and signed zeros in the references the encoder keeps:
        # a tile holding a NaN never changes, and one whose only move is
        # -0.0 against +0.0 does not either, so both carry the old bits on
        for t, f in enumerate(frames):
            f[2, 3] = np.float32(np.nan) if t % 2 else np.int32(-4194305).view(np.float32)
            f[9, 5] = -0.0 if t % 3 else 0.0
            f[20, 40 + t] += np.float32(0.001 * t)  # below the threshold: drifts
    j_enc, j_dec, j_log = _run_stream(jcr, frames, kwargs, lost)
    t_enc, t_dec, t_log = _run_stream(tcodec, frames, kwargs, lost)
    assert [e[:3] for e in t_log] == [e[:3] for e in j_log]  # seq, kind, ref_seq
    for (_, kind, _, t_pay, t_out), (_, _, _, j_pay, j_out) in zip(t_log, j_log):
        assert t_pay.dtype == j_pay.dtype
        assert np.array_equal(t_pay.view(np.int32), j_pay.view(np.int32))
        assert (t_out is None) == (j_out is None)
        if t_out is not None:
            assert np.array_equal(_bits(t_out), _bits(j_out))
    assert t_enc.forced_keyframes == j_enc.forced_keyframes
    assert (t_dec.nacks, t_dec.decoded) == (j_dec.nacks, j_dec.decoded)
    if not lost:
        assert [e[1] for e in t_log] == (["key"] + ["delta"] * 3) * 3
        assert t_enc.forced_keyframes == 0 and t_dec.nacks == 0


def test_stream_encoder_validates_config_and_shape():
    with pytest.raises(ValueError):
        tcodec.DeltaStreamEncoder(keyframe_interval=0)
    with pytest.raises(ValueError):
        tcodec.DeltaStreamEncoder(resync_bound=0)
    enc = tcodec.DeltaStreamEncoder()
    enc.encode(torch.zeros((20, 200)))  # a keyframe ships any shape
    with pytest.raises(ValueError, match="not divisible"):
        enc.encode(torch.zeros((20, 200)))  # a delta needs whole tiles


def test_stream_keyframes_are_copies():
    """The port's tensors are mutable: changing the caller's frame after
    encoding it changes neither the encoder's nor the decoder's state."""
    frame = torch.from_numpy(_sequence(n=1)[0].copy())
    enc, dec = tcodec.DeltaStreamEncoder(), tcodec.DeltaStreamDecoder()
    pkt = enc.encode(frame)
    out = dec.decode(pkt)
    before = out.clone()
    frame += 1.0
    assert torch.equal(pkt.payload, before) and torch.equal(out, before)


def test_stream_outputs_are_copies():
    """Changing a decoded frame or a sent keyframe's payload in place
    corrupts neither machine: at threshold 0 every later frame still
    decodes bit for bit."""
    frames = _sequence(n=10)
    enc = tcodec.DeltaStreamEncoder(keyframe_interval=4)
    dec = tcodec.DeltaStreamDecoder()
    for f in frames:
        pkt = enc.encode(torch.from_numpy(f))
        out = dec.decode(pkt)
        assert np.array_equal(_bits(out), _bits(f))
        out.clamp_(max=0.0)
        out += 1.0
        if pkt.kind == "key":
            pkt.payload.add_(1.0)
    assert dec.decoded == len(frames)


@pytest.mark.parametrize("threshold", [0.0, 0.01])
@pytest.mark.parametrize("h,w", [(128, 128), (240, 320)])
def test_mask_only_launch_matches_delta_encode_mask(h, w, threshold):
    """K3's and K3b's mask-only wrapper gives ``delta_encode``'s and
    ``delta_encode_batched``'s mask bit for bit, and the reference's,
    with the NaN tile and the signed-zero tile unchanged."""
    pairs = [_pair(h, w, seed=h + s) for s in range(2)]
    frames = np.stack([p[0] for p in pairs])
    refs = np.stack([p[1] for p in pairs])
    tf, tr = torch.from_numpy(frames), torch.from_numpy(refs)
    mask = tck._delta_mask(tf[0], tr[0], threshold=threshold)
    _, full = tck.delta_encode(tf[0], tr[0], threshold=threshold)
    _, jm = jck.delta_encode(jnp.asarray(frames[0]), jnp.asarray(refs[0]), threshold=threshold)
    assert mask.dtype == torch.float32 and mask.shape == full.shape
    assert np.array_equal(_bits(mask.numpy()), _bits(full.numpy()))
    assert np.array_equal(mask.numpy(), np.asarray(jm))
    assert mask[0, 0] == 0 and mask[1, 0] == 0 and mask[-1, -1] == 1
    masks = tck._delta_mask(tf, tr, threshold=threshold)
    _, full_b = tck.delta_encode_batched(tf, tr, threshold=threshold)
    assert np.array_equal(_bits(masks.numpy()), _bits(full_b.numpy()))
    assert torch.equal(masks[0], mask)
