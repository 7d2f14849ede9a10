"""Plain PyTorch versions and oracles of the uplink's payload codec.

The wire format the CUDA kernels (``codec.kernels``) accelerate, ported
from the JAX package's ``codec/ref.py``:

* **Temporal delta with per-tile change masks.**  The frame plane is
  split into (block_h, block_w) tiles; a tile is *changed* when any of
  its pixels moved more than ``threshold`` (in value space) against the
  reference frame.  Changed tiles ship their residual, unchanged tiles
  ship nothing.  The residual is the XOR of the float32 *bit patterns*
  (``.view(torch.int32)``, never float arithmetic): integer XOR is
  exactly invertible, so a changed tile reconstructs bit for bit, and at
  ``threshold == 0`` the roundtrip is lossless to the bit.
* **Uniform depth quantization + bit-packing.**  Depth values in
  [lo, hi] quantize to ``bits``-wide codes, round half to even of a true
  float32 division by the step (the error is at most half a step, see
  :func:`quant_step`), and ``32 // bits`` adjacent codes pack into one
  int32 word along the lane axis, least significant first.
* **The composed quantized-delta format** (:func:`encode_frame`,
  :func:`decode_frame`) that ``codec.model.CodecModel`` prices.
* **The entropy stage's host half**: per-tile significant-bit-width
  coding of residual words (numpy, as in the reference).
* The exact wire-size accounting.

Everything here is shape-strict (dimensions must divide the block), as
in the reference, and runs on the tensors' own device with plain torch
operations.  The kernel wrappers (``codec.kernels``) pad and crop; the
stream machines and :func:`~repro_torch.codec.wire.change_density`,
which run on the kernels, are in ``codec.wire``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

DEFAULT_BLOCK_H = 8
DEFAULT_BLOCK_W = 128

# one i32 word packs 32 // bits codes; bits == 32 is the raw f32 path
# and never enters the quantizer (codes would overflow int32)
PACKABLE_BITS = (1, 2, 4, 8, 16)


def _check_blocks(h: int, w: int, block_h: int, block_w: int) -> None:
    if h % block_h or w % block_w:
        raise ValueError(
            f"frame ({h}, {w}) not divisible by tile ({block_h}, {block_w})"
        )


def _check_bits(bits: int) -> int:
    if bits not in PACKABLE_BITS:
        raise ValueError(
            f"quantizer bits must be one of {PACKABLE_BITS}, got {bits}"
        )
    return 32 // bits


def quant_step(lo: float, hi: float, bits: int) -> float:
    """The advertised quantization step; roundtrip error is <= step/2
    for inputs inside [lo, hi] (round-to-nearest code assignment)."""
    levels = (1 << bits) - 1
    return (hi - lo) / levels if levels else hi - lo


# ---------------------------------------------------------------------------
# temporal delta
# ---------------------------------------------------------------------------


def delta_encode(
    frame: torch.Tensor,  # (H, W) f32
    ref: torch.Tensor,  # (H, W) f32: the receiver's reconstruction
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(delta_bits (H, W) i32, mask (H/bh, W/bw) f32)``.

    ``delta_bits`` is the XOR of the frame's and reference's bit
    patterns on changed tiles and zero elsewhere; ``mask`` is 1.0 on
    changed tiles.  A tile holding a NaN difference is unchanged (the
    max propagates NaN, and NaN > threshold is false).
    """
    h, w = frame.shape
    _check_blocks(h, w, block_h, block_w)
    f = frame.to(torch.float32)
    r = ref.to(torch.float32)
    tiles = (h // block_h, block_h, w // block_w, block_w)
    vdiff = torch.abs(f - r).reshape(tiles)
    thr = torch.tensor(threshold, dtype=torch.float32, device=f.device)
    mask = (torch.amax(vdiff, dim=(1, 3)) > thr).to(torch.float32)
    xor = torch.bitwise_xor(f.view(torch.int32), r.view(torch.int32))
    keep = mask.to(torch.int32).repeat_interleave(block_h, 0).repeat_interleave(block_w, 1)
    return xor * keep, mask


def delta_decode(
    delta_bits: torch.Tensor,  # (H, W) i32
    ref: torch.Tensor,  # (H, W) f32
) -> torch.Tensor:
    """Inverse of :func:`delta_encode`: changed tiles reconstruct bit for
    bit (XOR is exactly invertible), unchanged tiles fall back to the
    reference (error <= the encoder's threshold per pixel)."""
    bits = torch.bitwise_xor(ref.to(torch.float32).view(torch.int32), delta_bits)
    return bits.view(torch.float32)


# ---------------------------------------------------------------------------
# uniform quantization + bit-packing
# ---------------------------------------------------------------------------


def quantize_codes(
    depth: torch.Tensor,  # (..., W) float
    lo: float,
    hi: float,
    bits: int,
) -> torch.Tensor:
    """The quantizer's codes, int32 in [0, 2^bits - 1]: ``clip(x, lo,
    hi)``, then ``round((x - lo) / step)`` half to even with a true
    float32 division, then the clip to the code range.  A NaN pixel gets
    code 0 (as the reference's saturating cast gives it); +-inf go to
    the ends of the range."""
    step = quant_step(lo, hi, bits)
    x = torch.clamp(depth.to(torch.float32), lo, hi)
    x = torch.nan_to_num(x, nan=lo)
    # the step as a tensor on x's device: PyTorch's CUDA division by a
    # CPU scalar (a Python float) multiplies by its reciprocal, which
    # moves half-step ties
    step_t = torch.tensor(step, dtype=torch.float32, device=x.device)
    codes = torch.round((x - lo) / step_t).to(torch.int32)
    return torch.clamp(codes, 0, (1 << bits) - 1)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack ``32 // bits`` adjacent codes of the last axis into one int32
    word, least significant first, with bitwise OR (a sum would promote
    to int64; at bits 16 the top code sets the sign bit)."""
    ratio = 32 // bits
    grouped = codes.to(torch.int32).reshape(*codes.shape[:-1], codes.shape[-1] // ratio, ratio)
    words = torch.zeros(grouped.shape[:-1], dtype=torch.int32, device=codes.device)
    for k in range(ratio):
        words |= grouped[..., k] << (k * bits)
    return words


def quantize_pack(
    depth: torch.Tensor,  # (H, W) f32
    lo: float,
    hi: float,
    *,
    bits: int = 8,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> torch.Tensor:
    """Quantize to ``bits``-wide codes and pack the lane axis:
    returns ``(H, W * bits / 32) i32`` words."""
    _check_bits(bits)
    h, w = depth.shape
    _check_blocks(h, w, block_h, block_w)
    return pack_codes(quantize_codes(depth, lo, hi, bits), bits)


def unpack_dequantize(
    words: torch.Tensor,  # (H, W * bits / 32) i32
    lo: float,
    hi: float,
    *,
    bits: int = 8,
) -> torch.Tensor:
    """Inverse of :func:`quantize_pack`: ``(H, W) f32`` reconstruction
    with per-pixel error <= :func:`quant_step`/2 inside [lo, hi].  The
    value is ``lo + code * step`` as two rounded float32 operations (no
    fused multiply-add), as the reference computes it."""
    ratio = _check_bits(bits)
    step = quant_step(lo, hi, bits)
    lanes = torch.stack([(words >> (k * bits)) & ((1 << bits) - 1) for k in range(ratio)],
                        dim=-1)
    codes = lanes.reshape(*words.shape[:-1], words.shape[-1] * ratio)
    return lo + codes.to(torch.float32) * step


# ---------------------------------------------------------------------------
# the composed quantized-delta wire format
# ---------------------------------------------------------------------------


def encode_frame(
    frame: torch.Tensor,  # (H, W) f32
    ref: torch.Tensor,  # (H, W) f32: receiver's *reconstructed* reference
    lo: float,
    hi: float,
    *,
    bits: int = 8,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The composed delta+quantize wire format the analytic
    ``CodecModel`` prices: both planes quantize to ``bits``-wide codes,
    and a tile ships its packed codes iff any code changed, so a delta
    frame costs exactly ``change_density * bits/32`` of the raw f32
    bytes.

    Returns ``(words, mask)``: the full packed-code plane (the receiver
    reads only masked tiles) and the per-tile change mask, from the
    value-space delta of the dequantized planes at threshold ``step/2``.
    """
    words = quantize_pack(frame, lo, hi, bits=bits, block_h=block_h, block_w=block_w)
    recon = unpack_dequantize(words, lo, hi, bits=bits)
    ref_words = quantize_pack(ref, lo, hi, bits=bits, block_h=block_h, block_w=block_w)
    ref_recon = unpack_dequantize(ref_words, lo, hi, bits=bits)
    step = quant_step(lo, hi, bits)
    _, mask = delta_encode(recon, ref_recon, threshold=step / 2,
                           block_h=block_h, block_w=block_w)
    return words, mask


def select_tiles(
    recon: torch.Tensor,  # (H, W) f32: the decoded plane
    mask: torch.Tensor,  # (tiles_h, tiles_w) change mask
    ref: torch.Tensor,  # (H, W): the receiver's reference
    block_h: int,
    block_w: int,
) -> torch.Tensor:
    """Changed tiles from ``recon``, unchanged ones from ``ref``."""
    keep = mask.repeat_interleave(block_h, 0).repeat_interleave(block_w, 1)
    keep = keep[: ref.shape[0], : ref.shape[1]]
    return torch.where(keep > 0.0, recon, ref.to(torch.float32))


def decode_frame(
    words: torch.Tensor,  # packed codes of the masked tiles (full plane here)
    mask: torch.Tensor,  # (tiles_h, tiles_w) change mask
    ref: torch.Tensor,  # (H, W) f32: receiver's reconstructed reference
    lo: float,
    hi: float,
    *,
    bits: int = 8,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> torch.Tensor:
    """Inverse of :func:`encode_frame`: changed tiles dequantize their
    shipped codes (error <= step/2), unchanged tiles keep the reference,
    whose codes are identical."""
    recon = unpack_dequantize(words, lo, hi, bits=bits)
    return select_tiles(recon, mask, ref, block_h, block_w)


# ---------------------------------------------------------------------------
# entropy stage: per-tile significant-bit-width coding of residual words
# ---------------------------------------------------------------------------
#
# Each tile of `tile` words records the significant bit width of its max
# value (one byte), then packs every word's low `width` bits back to
# back.  An all-zero tile costs exactly one byte.  A leading flag byte
# selects raw fallback when width coding cannot win, so
# ``encoded <= raw + 1`` holds on every input.  This is host code
# (numpy), copied from the reference; a tensor comes in by
# ``.cpu().numpy()``.

ENTROPY_TILE = 64  # words per width-coded tile
_ENTROPY_RAW = 0  # flag byte: raw little-endian words follow
_ENTROPY_CODED = 1  # flag byte: width-coded tiles follow


def _as_uint32(words) -> np.ndarray:
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    return np.ascontiguousarray(
        np.asarray(words, dtype=np.int32)
    ).view(np.uint32).ravel()


def entropy_encode_words(words, tile: int = ENTROPY_TILE) -> bytes:
    """Entropy-code a plane of residual words (any shape, int32).

    Returns ``flag byte + payload``: width-coded tiles when that wins,
    raw little-endian words otherwise.  Lossless by construction and
    never more than one byte (the flag) over the raw size.
    """
    if tile < 1:
        raise ValueError("tile must be >= 1")
    flat = _as_uint32(words)
    raw = flat.astype("<u4").tobytes()
    parts = [bytes([_ENTROPY_CODED])]
    coded_len = 1
    for s in range(0, len(flat), tile):
        chunk = flat[s : s + tile]
        width = int(chunk.max()).bit_length() if len(chunk) else 0
        parts.append(bytes([width]))
        coded_len += 1
        if width:
            acc = 0
            shift = 0
            for v in chunk.tolist():
                acc |= v << shift
                shift += width
            nb = (shift + 7) // 8
            parts.append(acc.to_bytes(nb, "little"))
            coded_len += nb
        if coded_len > len(raw):  # width coding already lost: bail early
            break
    if coded_len <= len(raw):
        return b"".join(parts)
    return bytes([_ENTROPY_RAW]) + raw


def entropy_decode_words(
    data: bytes, n: int, tile: int = ENTROPY_TILE
) -> np.ndarray:
    """Inverse of :func:`entropy_encode_words`: the ``n`` original
    residual words, bit-exact, as a flat int32 array."""
    if not data:
        raise ValueError("empty entropy stream")
    flag = data[0]
    body = data[1:]
    if flag == _ENTROPY_RAW:
        return np.frombuffer(body, dtype="<u4", count=n).view(np.int32).copy()
    if flag != _ENTROPY_CODED:
        raise ValueError(f"unknown entropy stream flag {flag}")
    out = np.zeros(n, dtype=np.uint32)
    pos = 0
    for s in range(0, n, tile):
        count = min(tile, n - s)
        width = body[pos]
        pos += 1
        if not width:
            continue
        nb = (count * width + 7) // 8
        acc = int.from_bytes(body[pos : pos + nb], "little")
        pos += nb
        lane_mask = (1 << width) - 1
        vals = [(acc >> (k * width)) & lane_mask for k in range(count)]
        out[s : s + count] = np.asarray(vals, dtype=np.uint32)
    return out.view(np.int32)


def entropy_encoded_nbytes(words, tile: int = ENTROPY_TILE) -> int:
    """Exact wire size of one entropy-coded residual plane (flag byte
    included), what ``CodecModel.entropy_ratio`` is calibrated from."""
    return len(entropy_encode_words(words, tile))


# ---------------------------------------------------------------------------
# exact wire-format accounting
# ---------------------------------------------------------------------------


def encoded_nbytes_exact(
    mask: torch.Tensor,  # (tiles_h, tiles_w) change mask from delta_encode
    *,
    bits: int = 32,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
    header_nbytes: int = 0,
) -> int:
    """Exact encoded size of one delta frame: the changed tiles' payload
    at ``bits`` per sample, one bit per tile of change mask, plus the
    fixed header."""
    changed = int(torch.sum(mask > 0.0))
    tile_bits = block_h * block_w * bits
    mask_bits = int(mask.numel())
    return header_nbytes + math.ceil((changed * tile_bits + mask_bits) / 8)
