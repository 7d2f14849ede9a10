"""Temporal delta codec: the CUDA kernels K3, K3b and K4 and their wrappers.

Replace the Pallas TPU kernels ``repro/codec/kernels.py:delta_encode``,
``delta_encode_batched`` and ``delta_decode``.  Per (block_h, block_w)
tile, a tile is changed when ``max |frame - ref| > threshold``; the delta
is the XOR of the float32 bit patterns on changed tiles and 0 elsewhere,
and the mask is 1.0 on changed tiles.  The decode XORs the delta back
into the reference's bits.

The kernels are ``csrc/delta_codec.cu``, which says what bounds them on
an H100 (bytes, and at one 128x128 plane the launch) and how NaN and
signed zeros are kept as the reference has them.  K3 is K3b's B = 1
launch, so each client of K3b equals K3 on that client bit for bit.

The wrappers keep the reference's behaviour that callers can observe:
an unaligned plane acts as if zero-padded to whole tiles, the delta is
cropped back to (H, W), and the float32 mask covers the padded tile
grid, ``(ceil(H/bh), ceil(W/bw))`` with a leading B in the batched
wrapper.  For a CUDA tensor a wrapper launches its kernel, or raises;
for a CPU tensor it runs the plain version (``delta_encode_plain``,
``delta_decode_plain``: the shape-strict oracles of ``codec/ref.py``
on the padded plane).  ``launches`` counts each kernel's launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.codec import ref as _ref
from repro_torch.codec.ref import DEFAULT_BLOCK_H, DEFAULT_BLOCK_W
from repro_torch.codec.ref import delta_decode as delta_decode_plain
from repro_torch.kernels import _build

# Launches of each CUDA kernel since the counts were last set to 0.
launches = {"delta_encode": 0, "delta_encode_batched": 0, "delta_decode": 0}


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


def _encode_launch(frames, refs, threshold, block_h, block_w):
    """One launch of the encode kernel over (B, H, W) planes."""
    device = frames.device
    b, h, w = frames.shape
    tiles = (-(-h // block_h), -(-w // block_w))
    if b * h * w >= 2**31 or b * tiles[0] * tiles[1] >= 2**31:
        raise ValueError("the kernel indexes the planes with 32-bit ints")
    delta = torch.empty((b, h, w), dtype=torch.int32, device=device)
    mask = torch.empty((b, *tiles), dtype=torch.float32, device=device)
    if b * h * w == 0:
        return delta, mask.zero_(), False
    f = _build.kernel_input("frame", frames, device)
    r = _build.kernel_input("ref", refs, device)
    with torch.cuda.device(device):
        err = _build.library().delta_encode_launch(
            f.data_ptr(), r.data_ptr(), delta.data_ptr(), mask.data_ptr(),
            b, h, w, block_h, block_w, threshold, _build.stream_handle(device))
    _build.check(err, "delta_encode")
    return delta, mask, True


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
    delta, mask, launched = _encode_launch(frame[None], ref[None], threshold,
                                           block_h, block_w)
    launches["delta_encode"] += launched
    return delta[0], mask[0]


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
    delta, mask, launched = _encode_launch(frames, refs, threshold, block_h, block_w)
    launches["delta_encode_batched"] += launched
    return delta, mask


def delta_decode(
    delta_bits: torch.Tensor,  # (H, W) i32
    ref: torch.Tensor,  # (H, W) float
) -> torch.Tensor:
    """Reconstruct the frame, (H, W) float32: bit-exact on changed
    tiles, the reference (error <= the encode threshold) on unchanged
    ones.  The decode is one XOR per word, so it needs neither the tile
    shape nor the reference's padding."""
    if delta_bits.dim() != 2 or ref.shape != delta_bits.shape:
        raise ValueError(f"delta {tuple(delta_bits.shape)} and ref {tuple(ref.shape)}: "
                         "expected two planes of one shape (H, W)")
    if delta_bits.dtype != torch.int32:
        raise TypeError(f"delta_bits has dtype {delta_bits.dtype}, expected int32")
    if not delta_bits.is_cuda:
        return delta_decode_plain(delta_bits, ref)
    device = delta_bits.device
    n = delta_bits.numel()
    if n >= 2**31:
        raise ValueError("the kernel indexes the plane with 32-bit ints")
    out = torch.empty(delta_bits.shape, dtype=torch.float32, device=device)
    if n == 0:
        return out
    d = delta_bits.contiguous()
    r = _build.kernel_input("ref", ref, device)
    with torch.cuda.device(device):
        err = _build.library().delta_decode_launch(
            d.data_ptr(), r.data_ptr(), out.data_ptr(), n, _build.stream_handle(device))
    _build.check(err, "delta_decode")
    launches["delta_decode"] += 1
    return out
