"""Plain PyTorch versions of the payload codec's temporal-delta half.

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
* **Sequenced streams** of keyframes and deltas with loss-driven resync
  (:class:`DeltaStreamEncoder`, :class:`DeltaStreamDecoder`), and the
  exact wire-size and change-density accounting.

``delta_encode`` and ``delta_decode`` here are shape-strict (dimensions
must divide the block), as in the reference; padding lives in the kernel
wrappers.  The stream machines and :func:`change_density` go through
those wrappers, which launch the kernels for CUDA tensors and come back
to these functions for CPU tensors.  The quantizer and the entropy coder
are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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
# sequenced delta streams: keyframe loss and resync
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamPacket:
    """One wire packet of a sequenced delta stream.

    ``kind`` is "key" (self-contained) or "delta" (XOR residual against
    the reconstruction of packet ``ref_seq``); a decoder holding any
    other reference must refuse the packet rather than decode garbage.
    """

    seq: int
    kind: str
    ref_seq: int
    payload: object


def _kernels():
    # codec.kernels imports this module for its plain versions
    from repro_torch.codec import kernels

    return kernels


class DeltaStreamEncoder:
    """Packetizes frames as keyframes + XOR deltas with loss-driven
    resync: after :meth:`report_loss`, a keyframe is forced within
    ``resync_bound`` packets, so a receiver that lost its reference is
    never stranded longer than the bound.

    Frames stay on their device: a CUDA frame is encoded by the kernels
    K3 and K4.  The encoder keeps its own copy of each reference and a
    keyframe packet carries another, so neither the caller's frame nor
    the packet aliases the encoder's state.
    """

    def __init__(
        self,
        *,
        keyframe_interval: int = 8,
        resync_bound: int = 4,
        threshold: float = 0.0,
        block_h: int = DEFAULT_BLOCK_H,
        block_w: int = DEFAULT_BLOCK_W,
    ):
        if keyframe_interval < 1:
            raise ValueError("keyframe_interval must be >= 1")
        if resync_bound < 1:
            raise ValueError("resync_bound must be >= 1")
        self.keyframe_interval = keyframe_interval
        self.resync_bound = resync_bound
        self.threshold = threshold
        self.block_h = block_h
        self.block_w = block_w
        self._seq = 0
        self._ref: Optional[torch.Tensor] = None
        self._since_key = 0
        # deltas still allowed before a loss report forces a keyframe
        self._deltas_left: Optional[int] = None
        self.forced_keyframes = 0

    def report_loss(self, lost_seq: int) -> None:
        """The transport noticed packet ``lost_seq`` never arrived: the
        receiver's reference chain is broken from there on, so at most
        ``resync_bound - 1`` more deltas may ship before a keyframe."""
        budget = self.resync_bound - 1
        if self._deltas_left is None or budget < self._deltas_left:
            self._deltas_left = budget

    def encode(self, frame: torch.Tensor) -> StreamPacket:
        seq = self._seq
        self._seq += 1
        force = self._deltas_left is not None and self._deltas_left <= 0
        scheduled = (
            self._ref is None or self._since_key >= self.keyframe_interval - 1
        )
        if force or scheduled:
            if force and not scheduled:
                self.forced_keyframes += 1
            self._since_key = 0
            self._deltas_left = None
            self._ref = torch.as_tensor(frame).to(torch.float32, copy=True)
            return StreamPacket(seq, "key", seq, self._ref.clone())
        h, w = frame.shape
        _check_blocks(h, w, self.block_h, self.block_w)
        kernels = _kernels()
        delta_bits, _ = kernels.delta_encode(
            frame,
            self._ref,
            threshold=self.threshold,
            block_h=self.block_h,
            block_w=self.block_w,
        )
        # the encoder tracks the RECEIVER's reconstruction (unchanged
        # tiles keep the old reference), not the source frame: the
        # closed-loop discipline that stops drift from accumulating
        self._ref = kernels.delta_decode(delta_bits, self._ref)
        self._since_key += 1
        if self._deltas_left is not None:
            self._deltas_left -= 1
        return StreamPacket(seq, "delta", seq - 1, delta_bits)


class DeltaStreamDecoder:
    """Receiver of a :class:`DeltaStreamEncoder` stream.

    ``decode`` returns the reconstructed frame, or None (a NACK) when a
    delta references a reconstruction this decoder does not hold: a
    stale or missing reference must never be decoded against.  It
    decodes on the payload's device (K4 for CUDA tensors).  It keeps its
    own copy of each reference and returns another, so changing a
    decoded frame in place cannot corrupt the base of the next delta.
    """

    def __init__(self) -> None:
        self._ref: Optional[torch.Tensor] = None
        self._ref_seq = -1
        self.decoded = 0
        self.nacks = 0

    def decode(self, packet: StreamPacket) -> Optional[torch.Tensor]:
        if packet.kind == "key":
            self._ref = torch.as_tensor(packet.payload).to(torch.float32, copy=True)
            self._ref_seq = packet.seq
            self.decoded += 1
            return self._ref.clone()
        if self._ref is None or packet.ref_seq != self._ref_seq:
            self.nacks += 1
            return None
        self._ref = _kernels().delta_decode(packet.payload, self._ref)
        self._ref_seq = packet.seq
        self.decoded += 1
        return self._ref.clone()


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


def change_density(
    frames: torch.Tensor,  # (T, H, W) consecutive depth frames
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> torch.Tensor:
    """Per-transition fraction of changed tiles, shape (T-1,): the
    measured signal behind the codec model's change density.  The T-1
    transitions are encoded together (K3b for CUDA frames); the plane is
    padded to whole tiles, as in the reference."""
    if frames.shape[0] < 2:
        raise ValueError("change_density needs at least two frames")
    _, mask = _kernels().delta_encode_batched(
        frames[1:], frames[:-1], threshold=threshold, block_h=block_h,
        block_w=block_w,
    )
    return mask.mean(dim=(1, 2))
