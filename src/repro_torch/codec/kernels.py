"""The uplink codec's CUDA kernels and their wrappers.

Replace the Pallas TPU kernels of ``repro/codec/kernels.py``:

* K3 ``delta_encode``, K3b ``delta_encode_batched`` and K4
  ``delta_decode`` (``csrc/delta_codec.cu``): per (block_h, block_w)
  tile, a tile is changed when ``max |frame - ref| > threshold``; the
  delta is the XOR of the float32 bit patterns on changed tiles and 0
  elsewhere, and the mask is 1.0 on changed tiles.  The decode XORs the
  delta back into the reference's bits.  ``_delta_mask`` returns the
  mask alone, from a launch of K3 or K3b that does not write the delta;
  ``_delta_encode_recon`` adds the decode of the delta against the
  reference, from a launch of K3 that also writes it (the stream
  encoder's closed loop); ``_delta_encode_widths`` adds K5's widths of
  the delta, from a launch of K3 or K3b that also writes them (the
  entropy stage); ``_delta_decode_pair`` is K4 writing its result twice
  (the stream decoder's state and the copy it returns).
* K6 ``quantize_pack``, K6b ``quantize_pack_batched`` and K7
  ``unpack_dequantize`` (``csrc/quant_codec.cu``): ``bits``-wide codes,
  round half to even of a true float32 division, ``32 // bits`` codes
  packed per int32 word, and ``lo + code * step`` back.
  ``_quantize_pack_recon`` is K6 that also writes K7's values of its
  words (a keyframe and its reconstruction, in one launch).
* K5 ``significant_bit_widths`` and K5b ``significant_bit_widths_batched``
  (``csrc/quant_codec.cu``): per tile, the bit length of the tile's max
  word read as uint32, the entropy stage's side information.  They cast
  their input to int32 first, as the reference does.
* The quantized wire format's two launches (``csrc/quant_codec.cu``):
  ``_quant_encode``, K6's words and the change mask of the dequantized
  planes at threshold ``step/2`` in one launch (K6, K7, K6, K7 and K3's
  mask before), and ``_quant_decode``, K7 on the changed tiles and the
  reference's bits on the others in one launch (K7 and a mask select
  before).  Their plain versions, ``quant_encode_plain`` and
  ``quant_decode_plain``, are ``codec/ref.py``'s ``encode_frame`` and
  ``decode_frame``, those compositions of the oracles.

The ``.cu`` files say what bounds each kernel on an H100 (bytes, and at
one 128x128 plane the launch) and how NaN, infinities, signed zeros and
half-step ties come out as in the reference's oracle.  Each unbatched
kernel is its batched kernel's B = 1 launch, so each row of a batched
call equals the unbatched call on that row bit for bit.

The wrappers keep the reference's behaviour that callers can observe:
an unaligned plane acts as if zero-padded to whole tiles, outputs are
cropped back (the delta to (H, W), the words to (H, W*bits/32), the
values to (H, wpk*32/bits)), and the per-tile outputs (the float32 mask,
the int32 widths) cover the padded tile grid ``(ceil(H/bh),
ceil(W/bw))``, with a leading B in the batched wrappers; a pad tile
reads width 0.  ``quantize_pack`` raises when W is not a multiple of
``32 // bits``.  For a CUDA tensor a wrapper launches its kernel, or
raises; for a CPU tensor it runs the plain version beside it (the
``*_plain`` functions, built on the oracles of ``codec/ref.py``).
``launches`` counts each kernel's launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.codec import ref as _ref
from repro_torch.codec.ref import DEFAULT_BLOCK_H, DEFAULT_BLOCK_W
from repro_torch.codec.ref import decode_frame as quant_decode_plain
from repro_torch.codec.ref import delta_decode as delta_decode_plain
from repro_torch.codec.ref import encode_frame as quant_encode_plain
from repro_torch.kernels import _build

# Launches of each CUDA kernel since the counts were last set to 0;
# "delta_encode_mask_only" counts the launches of K3 or K3b, already
# counted under their own names, that wrote the mask alone,
# "delta_encode_recon" those of K3 that also wrote the reconstruction,
# "delta_encode_widths" those of K3 or K3b that also wrote the bit
# widths, "quantize_pack_recon" those of K6, already counted as K6, that
# also wrote K7's values, and "delta_decode_pair" those of K4, already
# counted as K4, that wrote two outputs.
launches = {
    "delta_encode": 0, "delta_encode_batched": 0, "delta_encode_mask_only": 0,
    "delta_encode_recon": 0, "delta_encode_widths": 0, "delta_decode": 0,
    "delta_decode_pair": 0, "significant_bit_widths": 0,
    "significant_bit_widths_batched": 0, "quantize_pack": 0, "quantize_pack_recon": 0,
    "quantize_pack_batched": 0, "unpack_dequantize": 0, "quant_encode": 0,
    "quant_decode": 0,
}


def _pad_plane(x: torch.Tensor, block_h: int, block_w: int) -> torch.Tensor:
    """Zero-pad the trailing two axes up to tile multiples."""
    pad_h = -x.shape[-2] % block_h
    pad_w = -x.shape[-1] % block_w
    if not pad_h and not pad_w:
        return x
    return torch.nn.functional.pad(x, (0, pad_w, 0, pad_h))


def delta_encode_plain(
    frames: torch.Tensor,  # (B, H, W)
    refs: torch.Tensor,  # (B, H, W)
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3b: ``codec.ref.delta_encode`` on each
    client's zero-padded plane, delta cropped to (H, W)."""
    h, w = frames.shape[-2:]
    f = _pad_plane(frames.to(torch.float32), block_h, block_w)
    r = _pad_plane(refs.to(torch.float32), block_h, block_w)
    tiles = (-(-h // block_h), -(-w // block_w))
    deltas = torch.empty(f.shape, dtype=torch.int32, device=f.device)
    masks = torch.empty((f.shape[0], *tiles), dtype=torch.float32, device=f.device)
    for i in range(f.shape[0]):
        deltas[i], masks[i] = _ref.delta_encode(
            f[i], r[i], threshold=threshold, block_h=block_h, block_w=block_w)
    return deltas[:, :h, :w], masks


def _check_pair(frames: torch.Tensor, refs: torch.Tensor, ndim: int) -> None:
    if frames.dim() != ndim or refs.shape != frames.shape:
        want = "(H, W)" if ndim == 2 else "(B, H, W)"
        raise ValueError(f"frame {tuple(frames.shape)} and ref {tuple(refs.shape)}: "
                         f"expected two planes of one shape {want}")


def _check_tile(block_h: int, block_w: int) -> None:
    if block_h < 1 or block_w < 1:
        raise ValueError(f"tile ({block_h}, {block_w}) must be at least (1, 1)")


def _encode_launch(frames, refs, threshold, block_h, block_w, write_delta=True,
                   write_recon=False, write_widths=False):
    """One launch of the encode kernel over (B, H, W) planes: (delta,
    mask, recon, widths, launched); without ``write_delta`` the mask-only
    launch, and delta is None; with ``write_recon`` the launch that also
    writes the reconstruction, else recon is None; with ``write_widths``
    the launch that also writes each tile's bit width, else widths is
    None."""
    device = frames.device
    b, h, w = frames.shape
    tiles = (-(-h // block_h), -(-w // block_w))
    if b * h * w >= 2**31:
        raise ValueError("the kernel indexes the planes with 32-bit ints")

    def plane(dtype, wanted):
        return torch.empty((b, h, w), dtype=dtype, device=device) if wanted else None

    delta = plane(torch.int32, write_delta)
    recon = plane(torch.float32, write_recon)
    mask = torch.empty((b, *tiles), dtype=torch.float32, device=device)
    widths = (torch.empty((b, *tiles), dtype=torch.int32, device=device) if write_widths
              else None)
    if b * h * w == 0:
        return delta, mask.zero_(), recon, None if widths is None else widths.zero_(), False
    f = _build.kernel_input("frame", frames, device)
    r = _build.kernel_input("ref", refs, device)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        err = _build.library().delta_encode_launch(
            f.data_ptr(), r.data_ptr(), ptr(delta), ptr(recon), mask.data_ptr(), ptr(widths),
            b, h, w, block_h, block_w, threshold, _build.stream_handle(device))
    _build.check(err, "delta_encode")
    launches["delta_encode_mask_only"] += not write_delta
    launches["delta_encode_recon"] += write_recon
    launches["delta_encode_widths"] += write_widths
    return delta, mask, recon, widths, True


def delta_encode(
    frame: torch.Tensor,  # (H, W) float
    ref: torch.Tensor,  # (H, W) float
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(delta_bits (H, W) i32, mask (ceil(H/bh), ceil(W/bw))
    f32)``; equals ``codec.ref.delta_encode`` on tile-aligned shapes."""
    _check_pair(frame, ref, 2)
    _check_tile(block_h, block_w)
    if not frame.is_cuda:
        delta, mask = delta_encode_plain(frame[None], ref[None], threshold=threshold,
                                         block_h=block_h, block_w=block_w)
        return delta[0], mask[0]
    delta, mask, _, _, launched = _encode_launch(frame[None], ref[None], threshold,
                                                 block_h, block_w)
    launches["delta_encode"] += launched
    return delta[0], mask[0]


def _delta_encode_recon(
    frame: torch.Tensor,  # (H, W) float
    ref: torch.Tensor,  # (H, W) float
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``delta_encode`` and ``delta_decode(delta, ref)``, bit for bit:
    ``(delta_bits, mask, recon (H, W) f32)``, where recon holds the
    frame's bits on changed tiles and the reference's elsewhere, in a new
    tensor.  One launch of K3 that writes all three: for the stream
    encoder, whose next reference is the receiver's reconstruction."""
    _check_pair(frame, ref, 2)
    _check_tile(block_h, block_w)
    if not frame.is_cuda:
        delta, mask = delta_encode_plain(frame[None], ref[None], threshold=threshold,
                                         block_h=block_h, block_w=block_w)
        return delta[0], mask[0], delta_decode_plain(delta[0], ref)
    delta, mask, recon, _, launched = _encode_launch(frame[None], ref[None], threshold,
                                                     block_h, block_w, write_recon=True)
    launches["delta_encode"] += launched
    return delta[0], mask[0], recon[0]


def _delta_encode_widths(
    frames: torch.Tensor,  # (H, W) or (B, H, W) float
    refs: torch.Tensor,  # like frames
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``delta_encode`` (a plane) or ``delta_encode_batched`` (B planes)
    and ``significant_bit_widths`` of the delta on the same tiles, bit for
    bit: ``(delta_bits, mask, widths (.., ceil(H/bh), ceil(W/bw)) i32)``.
    One launch of K3 or K3b that writes all three: for the entropy stage
    (``wire.entropy_residuals``), which prices each residual plane by its
    tiles' widths."""
    batched = frames.dim() == 3
    _check_pair(frames, refs, 3 if batched else 2)
    _check_tile(block_h, block_w)
    planes = (frames, refs) if batched else (frames[None], refs[None])
    if not frames.is_cuda:
        delta, mask = delta_encode_plain(*planes, threshold=threshold, block_h=block_h,
                                         block_w=block_w)
        widths = significant_bit_widths_plain(delta, block_h=block_h, block_w=block_w)
    else:
        delta, mask, _, widths, launched = _encode_launch(*planes, threshold, block_h,
                                                          block_w, write_widths=True)
        launches["delta_encode_batched" if batched else "delta_encode"] += launched
    return (delta, mask, widths) if batched else (delta[0], mask[0], widths[0])


def _delta_mask(
    frames: torch.Tensor,  # (H, W) or (B, H, W) float
    refs: torch.Tensor,  # like frames
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> torch.Tensor:
    """The change mask of ``delta_encode`` (a plane) or
    ``delta_encode_batched`` (B planes), bit for bit, from a launch of
    K3 or K3b that does not write the delta: for callers that read the
    mask alone (``wire.encode_frame``, ``wire.change_density``)."""
    batched = frames.dim() == 3
    _check_pair(frames, refs, 3 if batched else 2)
    _check_tile(block_h, block_w)
    planes = (frames, refs) if batched else (frames[None], refs[None])
    if not frames.is_cuda:
        _, mask = delta_encode_plain(*planes, threshold=threshold, block_h=block_h,
                                     block_w=block_w)
    else:
        _, mask, _, _, launched = _encode_launch(*planes, threshold, block_h, block_w,
                                                 write_delta=False)
        launches["delta_encode_batched" if batched else "delta_encode"] += launched
    return mask if batched else mask[0]


def delta_encode_batched(
    frames: torch.Tensor,  # (B, H, W) float
    refs: torch.Tensor,  # (B, H, W) float
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
    path: str = "grid",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B clients' frames delta-encoded together: ``(delta_bits (B, H, W)
    i32, mask (B, ceil(H/bh), ceil(W/bw)) f32)``.

    ``path="grid"`` is one launch over all B planes (K3b); ``path="vmap"``
    runs ``delta_encode`` on each client and stacks the results, the
    reference's comparison path.  Each client's slice equals
    ``delta_encode`` on that client alone.
    """
    if path not in ("grid", "vmap"):
        raise ValueError(f"unknown path {path!r}")
    _check_pair(frames, refs, 3)
    _check_tile(block_h, block_w)
    consts = dict(threshold=threshold, block_h=block_h, block_w=block_w)
    if path == "vmap":
        outs = [delta_encode(f, r, **consts) for f, r in zip(frames, refs)]
        return torch.stack([d for d, _ in outs]), torch.stack([m for _, m in outs])
    if not frames.is_cuda:
        return delta_encode_plain(frames, refs, **consts)
    delta, mask, _, _, launched = _encode_launch(frames, refs, threshold, block_h, block_w)
    launches["delta_encode_batched"] += launched
    return delta, mask


def _check_decode(delta_bits: torch.Tensor, ref: torch.Tensor) -> None:
    if delta_bits.dim() != 2 or ref.shape != delta_bits.shape:
        raise ValueError(f"delta {tuple(delta_bits.shape)} and ref {tuple(ref.shape)}: "
                         "expected two planes of one shape (H, W)")
    if delta_bits.dtype != torch.int32:
        raise TypeError(f"delta_bits has dtype {delta_bits.dtype}, expected int32")


def _decode_launch(delta_bits, ref, copies):
    """One launch of K4 writing its result into ``copies`` (1 or 2) new
    planes."""
    device = delta_bits.device
    n = delta_bits.numel()
    if n >= 2**31:
        raise ValueError("the kernel indexes the plane with 32-bit ints")
    outs = [torch.empty(delta_bits.shape, dtype=torch.float32, device=device)
            for _ in range(copies)]
    if n == 0:
        return outs
    d = delta_bits.contiguous()
    r = _build.kernel_input("ref", ref, device)
    with torch.cuda.device(device):
        err = _build.library().delta_decode_launch(
            d.data_ptr(), r.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if copies == 2 else None, n, _build.stream_handle(device))
    _build.check(err, "delta_decode")
    launches["delta_decode"] += 1
    launches["delta_decode_pair"] += copies == 2
    return outs


def delta_decode(
    delta_bits: torch.Tensor,  # (H, W) i32
    ref: torch.Tensor,  # (H, W) float
) -> torch.Tensor:
    """Reconstruct the frame, (H, W) float32: bit-exact on changed
    tiles, the reference (error <= the encode threshold) on unchanged
    ones.  The decode is one XOR per word, so it needs neither the tile
    shape nor the reference's padding."""
    _check_decode(delta_bits, ref)
    if not delta_bits.is_cuda:
        return delta_decode_plain(delta_bits, ref)
    return _decode_launch(delta_bits, ref, 1)[0]


def _delta_decode_pair(
    delta_bits: torch.Tensor,  # (H, W) i32
    ref: torch.Tensor,  # (H, W) float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``delta_decode`` written into two new planes by one launch of K4:
    for the stream decoder, which keeps one as its reference and hands
    out the other."""
    _check_decode(delta_bits, ref)
    if not delta_bits.is_cuda:
        out = delta_decode_plain(delta_bits, ref)
        return out, out.clone()
    state, copy = _decode_launch(delta_bits, ref, 2)
    return state, copy


# ---------------------------------------------------------------------------
# entropy stage: per-tile significant-bit widths (K5, K5b)
# ---------------------------------------------------------------------------

_BIT_THRESHOLDS = [1 << k for k in range(32)]


def significant_bit_widths_plain(
    deltas: torch.Tensor,  # (B, H, W) int
    *,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> torch.Tensor:
    """The plain version of K5b: per tile of each zero-padded plane, the
    bit length of the max word read as uint32, ``(B, ceil(H/bh),
    ceil(W/bw)) i32``.  It goes through int64 (``& 0xFFFFFFFF``), since
    torch's uint32 support is thin, and counts ``m >= 2**k`` over k in
    [0, 32) as the reference kernel does."""
    d = _pad_plane(_as_words(deltas), block_h, block_w).to(torch.int64) & 0xFFFFFFFF
    b, hp, wp = d.shape
    tiles = d.reshape(b, hp // block_h, block_h, wp // block_w, block_w)
    m = torch.amax(tiles, dim=(2, 4))
    thresholds = torch.tensor(_BIT_THRESHOLDS, dtype=torch.int64, device=d.device)
    return (m[..., None] >= thresholds).sum(-1).to(torch.int32)


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """``x`` as int32 words, as the reference's ``astype(jnp.int32)``
    gives them: an int32 plane as it is, other integers wrapped, a float
    plane taken as float32 (JAX's default precision), truncated toward
    zero and saturated as XLA converts: NaN to 0, values past the int32
    range (infinities included) to its ends."""
    if x.dtype == torch.int32:
        return x
    if not x.is_floating_point():
        return x.to(torch.int32)
    x = x.to(torch.float32).to(torch.float64).nan_to_num(0.0)
    return x.clamp(-(2**31), 2**31 - 1).to(torch.int32)


def _check_ndim(words: torch.Tensor, ndim: int, name: str) -> None:
    if words.dim() != ndim:
        want = "(H, W)" if ndim == 2 else "(B, H, W)"
        raise ValueError(f"{name} {tuple(words.shape)}: expected a plane of shape {want}")


def _check_words(words: torch.Tensor, ndim: int, name: str) -> None:
    _check_ndim(words, ndim, name)
    if words.dtype != torch.int32:
        raise TypeError(f"{name} has dtype {words.dtype}, expected int32")


def _widths_launch(deltas, block_h, block_w):
    """One launch of the width kernel over (B, H, W) int32 residual
    planes."""
    device = deltas.device
    b, h, w = deltas.shape
    tiles = (-(-h // block_h), -(-w // block_w))
    if b * h * w >= 2**31:
        raise ValueError("the kernel indexes the planes with 32-bit ints")
    out = torch.empty((b, *tiles), dtype=torch.int32, device=device)
    if b * h * w == 0:
        return out, False
    d = deltas.contiguous()
    with torch.cuda.device(device):
        err = _build.library().significant_bit_widths_launch(
            d.data_ptr(), out.data_ptr(), b, h, w, block_h, block_w,
            _build.stream_handle(device))
    _build.check(err, "significant_bit_widths")
    return out, True


def significant_bit_widths(
    delta_bits: torch.Tensor,  # (H, W) i32 XOR residual plane
    *,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> torch.Tensor:
    """Per-tile significant-bit widths of a residual plane, ``(ceil(H/bh),
    ceil(W/bw)) i32`` in [0, 32]: the entropy stage's device half.  A
    tile's coded size is ``ceil(tile_samples * width / 8) + 1`` bytes.
    A plane of another dtype is cast to int32 first, as the reference's
    ``astype(jnp.int32)`` does (:func:`_as_words`)."""
    _check_ndim(delta_bits, 2, "delta_bits")
    _check_tile(block_h, block_w)
    delta_bits = _as_words(delta_bits)
    if not delta_bits.is_cuda:
        return significant_bit_widths_plain(delta_bits[None], block_h=block_h,
                                            block_w=block_w)[0]
    out, launched = _widths_launch(delta_bits[None], block_h, block_w)
    launches["significant_bit_widths"] += launched
    return out[0]


def significant_bit_widths_batched(
    deltas: torch.Tensor,  # (B, H, W) i32
    *,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
    path: str = "grid",
) -> torch.Tensor:
    """B clients' residual planes width-scanned together, ``(B,
    ceil(H/bh), ceil(W/bw)) i32``: ``path="grid"`` is one launch (K5b),
    ``path="vmap"`` runs ``significant_bit_widths`` per client.  Each row
    equals the unbatched call on that client; the planes are cast to
    int32 first, as in the reference."""
    if path not in ("grid", "vmap"):
        raise ValueError(f"unknown path {path!r}")
    _check_ndim(deltas, 3, "deltas")
    _check_tile(block_h, block_w)
    deltas = _as_words(deltas)
    if path == "vmap":
        return torch.stack([significant_bit_widths(d, block_h=block_h, block_w=block_w)
                            for d in deltas])
    if not deltas.is_cuda:
        return significant_bit_widths_plain(deltas, block_h=block_h, block_w=block_w)
    out, launched = _widths_launch(deltas, block_h, block_w)
    launches["significant_bit_widths_batched"] += launched
    return out


# ---------------------------------------------------------------------------
# quantize + pack (K6, K6b) and unpack + dequantize (K7)
# ---------------------------------------------------------------------------


def quantize_pack_plain(
    depths: torch.Tensor,  # (..., W) float
    lo: float,
    hi: float,
    *,
    bits: int = 8,
) -> torch.Tensor:
    """The plain version of K6 and K6b: ``codec.ref``'s quantizer and
    packer over the last axis, ``(..., W * bits / 32) i32``."""
    return _ref.pack_codes(_ref.quantize_codes(depths, lo, hi, bits), bits)


def unpack_dequantize_plain(
    words: torch.Tensor,  # (..., wpk) i32
    lo: float,
    hi: float,
    *,
    bits: int = 8,
) -> torch.Tensor:
    """The plain version of K7: ``codec.ref.unpack_dequantize``."""
    return _ref.unpack_dequantize(words, lo, hi, bits=bits)


def _check_plane(depth: torch.Tensor, ndim: int, bits: int) -> int:
    ratio = _ref._check_bits(bits)
    if depth.dim() != ndim:
        want = "(H, W)" if ndim == 2 else "(B, H, W)"
        raise ValueError(f"depth {tuple(depth.shape)}: expected a plane of shape {want}")
    if depth.shape[-1] % ratio:
        raise ValueError(f"width {depth.shape[-1]} not divisible by pack ratio {ratio}")
    return ratio


def _quantize_launch(depths, lo, hi, bits, write_recon=False):
    """One launch of the quantizer over (..., W) planes: (words, recon,
    launched); with ``write_recon`` the launch that also writes K7's
    values of the words, else recon is None."""
    device = depths.device
    ratio = 32 // bits
    if depths.numel() >= 2**31:
        raise ValueError("the kernel indexes the planes with 32-bit ints")
    out = torch.empty((*depths.shape[:-1], depths.shape[-1] // ratio), dtype=torch.int32,
                      device=device)
    recon = (torch.empty(depths.shape, dtype=torch.float32, device=device) if write_recon
             else None)
    if out.numel() == 0:
        return out, recon, False
    x = _build.kernel_input("depth", depths, device)
    with torch.cuda.device(device):
        err = _build.library().quantize_pack_launch(
            x.data_ptr(), out.data_ptr(), None if recon is None else recon.data_ptr(),
            out.numel(), bits, lo, hi, _ref.quant_step(lo, hi, bits),
            _build.stream_handle(device))
    _build.check(err, "quantize_pack")
    launches["quantize_pack_recon"] += write_recon
    return out, recon, True


def quantize_pack(
    depth: torch.Tensor,  # (H, W) float
    lo: float,
    hi: float,
    *,
    bits: int = 8,
) -> torch.Tensor:
    """Quantize depth to ``bits``-wide codes and bit-pack the lane axis
    into int32 words: ``(H, W * bits / 32) i32``.  W must be a multiple
    of ``32 // bits``.  A word depends only on its own pixels, so the
    reference's tile shape, which only pads, changes nothing and is not
    taken."""
    _check_plane(depth, 2, bits)
    if not depth.is_cuda:
        return quantize_pack_plain(depth, lo, hi, bits=bits)
    out, _, launched = _quantize_launch(depth, lo, hi, bits)
    launches["quantize_pack"] += launched
    return out


def _quantize_pack_recon(
    depth: torch.Tensor,  # (H, W) float
    lo: float,
    hi: float,
    *,
    bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_pack`` and ``unpack_dequantize`` of its words, bit for
    bit: ``(words (H, W*bits/32) i32, recon (H, W) f32)``.  One launch of
    K6 that writes both: the quantized uplink's keyframe and the
    receiver's reconstruction of it, the closed loop's next reference
    (``wire.encode_keyframe``)."""
    _check_plane(depth, 2, bits)
    if not depth.is_cuda:
        words = quantize_pack_plain(depth, lo, hi, bits=bits)
        return words, unpack_dequantize_plain(words, lo, hi, bits=bits)
    words, recon, launched = _quantize_launch(depth, lo, hi, bits, write_recon=True)
    launches["quantize_pack"] += launched
    return words, recon


def quantize_pack_batched(
    depths: torch.Tensor,  # (B, H, W) float
    lo: float,
    hi: float,
    *,
    bits: int = 8,
    path: str = "grid",
) -> torch.Tensor:
    """B clients' planes quantized and packed together, ``(B, H, W * bits
    / 32) i32``: ``path="grid"`` is one launch (K6b), ``path="vmap"``
    runs ``quantize_pack`` per client.  Each row equals the unbatched
    call on that client."""
    if path not in ("grid", "vmap"):
        raise ValueError(f"unknown path {path!r}")
    _check_plane(depths, 3, bits)
    if path == "vmap":
        return torch.stack([quantize_pack(d, lo, hi, bits=bits) for d in depths])
    if not depths.is_cuda:
        return quantize_pack_plain(depths, lo, hi, bits=bits)
    out, _, launched = _quantize_launch(depths, lo, hi, bits)
    launches["quantize_pack_batched"] += launched
    return out


def unpack_dequantize(
    words: torch.Tensor,  # (H, W * bits / 32) i32
    lo: float,
    hi: float,
    *,
    bits: int = 8,
) -> torch.Tensor:
    """Inverse of :func:`quantize_pack`: ``(H, wpk * 32 / bits) f32`` with
    per-pixel error <= ``ref.quant_step(lo, hi, bits) / 2`` inside
    [lo, hi]."""
    ratio = _ref._check_bits(bits)
    _check_words(words, 2, "words")
    if not words.is_cuda:
        return unpack_dequantize_plain(words, lo, hi, bits=bits)
    device = words.device
    if words.numel() * ratio >= 2**31:
        raise ValueError("the kernel indexes the plane with 32-bit ints")
    out = torch.empty((words.shape[0], words.shape[1] * ratio), dtype=torch.float32,
                      device=device)
    if words.numel() == 0:
        return out
    w = words.contiguous()
    with torch.cuda.device(device):
        err = _build.library().unpack_dequantize_launch(
            w.data_ptr(), out.data_ptr(), w.numel(), bits, lo,
            _ref.quant_step(lo, hi, bits), _build.stream_handle(device))
    _build.check(err, "unpack_dequantize")
    launches["unpack_dequantize"] += 1
    return out


# ---------------------------------------------------------------------------
# the quantized wire format's two launches: encode and decode-and-select
# ---------------------------------------------------------------------------


def _quant_encode(
    frame: torch.Tensor,  # (H, W) float, whole tiles
    ref: torch.Tensor,  # (H, W) float
    lo: float,
    hi: float,
    *,
    bits: int = 8,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(words (H, W*bits/32) i32, mask (H/bh, W/bw) f32)`` of
    ``quant_encode_plain``, bit for bit, in one launch: the frame's
    packed codes, and per tile whether the dequantized frame moved more
    than ``step/2`` from the dequantized reference.  Raises, as the
    reference's ``encode_frame`` does, unless the plane is whole tiles."""
    _check_pair(frame, ref, 2)
    _check_tile(block_h, block_w)
    ratio = _check_plane(frame, 2, bits)
    h, w = frame.shape
    _ref._check_blocks(h, w, block_h, block_w)
    if not frame.is_cuda:
        return quant_encode_plain(frame, ref, lo, hi, bits=bits, block_h=block_h,
                                  block_w=block_w)
    device = frame.device
    if h * w >= 2**31:
        raise ValueError("the kernel indexes the plane with 32-bit ints")
    words = torch.empty((h, w // ratio), dtype=torch.int32, device=device)
    mask = torch.empty((h // block_h, w // block_w), dtype=torch.float32, device=device)
    if h * w == 0:
        return words, mask.zero_()
    f = _build.kernel_input("frame", frame, device)
    r = _build.kernel_input("ref", ref, device)
    step = _ref.quant_step(lo, hi, bits)
    with torch.cuda.device(device):
        err = _build.library().quant_encode_launch(
            f.data_ptr(), r.data_ptr(), words.data_ptr(), mask.data_ptr(), h, w, block_h,
            block_w, bits, lo, hi, step, step / 2, _build.stream_handle(device))
    _build.check(err, "quant_encode")
    launches["quant_encode"] += 1
    return words, mask


def _quant_decode(
    words: torch.Tensor,  # (H, W*bits/32) i32
    mask: torch.Tensor,  # covers the (ceil(H/bh), ceil(W/bw)) tile grid
    ref: torch.Tensor,  # (H, W) float
    lo: float,
    hi: float,
    *,
    bits: int = 8,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> torch.Tensor:
    """``quant_decode_plain``, bit for bit, in one launch: (H, W) f32,
    the dequantized words on tiles whose mask value is > 0 and the
    reference's values elsewhere (a NaN mask keeps the reference).  A
    mask larger than the tile grid is cropped, as in the reference."""
    ratio = _ref._check_bits(bits)
    _check_words(words, 2, "words")
    _check_tile(block_h, block_w)
    if ref.dim() != 2:
        raise ValueError(f"ref {tuple(ref.shape)}: expected a plane of shape (H, W)")
    h, w = ref.shape
    if words.shape != (h, w // ratio) or w % ratio:
        raise ValueError(f"words {tuple(words.shape)} and ref {tuple(ref.shape)}: expected "
                         f"(H, W * {bits} / 32) words for an (H, W) plane")
    tiles = (-(-h // block_h), -(-w // block_w))
    if mask.dim() != 2 or mask.shape[0] < tiles[0] or mask.shape[1] < tiles[1]:
        raise ValueError(f"mask {tuple(mask.shape)} does not cover the {tiles} tile grid")
    if not words.is_cuda:
        return quant_decode_plain(words, mask, ref, lo, hi, bits=bits, block_h=block_h,
                                  block_w=block_w)
    device = words.device
    if h * w >= 2**31:
        raise ValueError("the kernel indexes the plane with 32-bit ints")
    out = torch.empty((h, w), dtype=torch.float32, device=device)
    if h * w == 0:
        return out
    if mask.device != device:
        raise ValueError(f"mask is on {mask.device}, expected {device}")
    m = mask.to(torch.float32)
    r = _build.kernel_input("ref", ref, device)
    ws = words.contiguous()
    with torch.cuda.device(device):
        err = _build.library().quant_decode_launch(
            ws.data_ptr(), m.data_ptr(), r.data_ptr(), out.data_ptr(), h, w, block_h,
            block_w, m.stride(0), m.stride(1), bits, lo, _ref.quant_step(lo, hi, bits),
            _build.stream_handle(device))
    _build.check(err, "quant_decode")
    launches["quant_decode"] += 1
    return out
