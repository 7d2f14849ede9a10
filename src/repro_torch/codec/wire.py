"""The uplink codec's paths that run on the kernels.

``codec.ref`` holds the plain versions and the oracles, ``codec.kernels``
the CUDA kernels' wrappers; this module composes the wrappers into what
the uplink runs:

* the quantized-delta wire format, :func:`encode_frame` and
  :func:`decode_frame`: one launch each on CUDA tensors (the encode's
  words and mask; the decode's dequantization and mask select); on CPU
  tensors the reference's composition of the plain versions (K6, K7,
  K6, K7 and K3's mask at threshold ``step/2``; K7 and the select);
  :func:`encode_keyframe`, a quantized keyframe and the receiver's
  reconstruction of it (one launch of K6 that also writes K7's values);
* :func:`entropy_residuals`, the entropy stage's device half: each
  residual plane and its tiles' significant-bit widths (one launch of
  K3 or K3b that also writes K5's widths), which
  ``codec.ref.entropy_encode_words`` then codes on the host;
* the sequenced stream machines of keyframes and XOR deltas with
  loss-driven resync (:class:`DeltaStreamEncoder`,
  :class:`DeltaStreamDecoder`; on the card one launch a delta frame
  each: K3 writing the delta and the new reference, K4 writing the
  decoder's state and the copy it returns);
* :func:`change_density`, the measured signal behind the codec model
  (K3b's mask-only launch on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.codec import kernels
from repro_torch.codec import ref as _ref
from repro_torch.codec.ref import DEFAULT_BLOCK_H, DEFAULT_BLOCK_W

# ---------------------------------------------------------------------------
# the composed quantized-delta wire format
# ---------------------------------------------------------------------------


def encode_frame(
    frame: torch.Tensor,  # (H, W) float
    ref: torch.Tensor,  # (H, W) float: receiver's *reconstructed* reference
    lo: float,
    hi: float,
    *,
    bits: int = 8,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``codec.ref.encode_frame`` through the kernels: returns ``(words
    (H, W*bits/32) i32, mask (H/bh, W/bw) f32)``.  Both planes quantize
    to ``bits``-wide codes, and the mask is the value-space delta of the
    dequantized planes at threshold ``step/2``, so a tile is changed
    exactly when one of its codes is.  Raises ``ValueError``, as the
    reference does, unless the plane is whole (block_h, block_w) tiles."""
    return kernels._quant_encode(frame, ref, lo, hi, bits=bits, block_h=block_h,
                                 block_w=block_w)


def decode_frame(
    words: torch.Tensor,  # packed codes of the masked tiles (full plane here)
    mask: torch.Tensor,  # (tiles_h, tiles_w) change mask
    ref: torch.Tensor,  # (H, W): receiver's reconstructed reference
    lo: float,
    hi: float,
    *,
    bits: int = 8,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> torch.Tensor:
    """``codec.ref.decode_frame`` through the kernels: changed tiles
    dequantize their shipped codes (error <= step/2), unchanged tiles
    keep the reference.  The mask covers the tile grid; a larger one is
    cropped, as in the reference."""
    return kernels._quant_decode(words, mask, ref, lo, hi, bits=bits, block_h=block_h,
                                 block_w=block_w)


def encode_keyframe(
    frame: torch.Tensor,  # (H, W) float
    lo: float,
    hi: float,
    *,
    bits: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A quantized keyframe: ``(words (H, W*bits/32) i32, recon (H, W)
    f32)``, ``codec.ref.quantize_pack`` of the frame and
    ``codec.ref.unpack_dequantize`` of its words, bit for bit.  ``recon``
    is what the receiver decodes, so it is the reference the next
    :func:`encode_frame` of a closed loop is encoded against.  W must be
    a multiple of ``32 // bits``."""
    return kernels._quantize_pack_recon(frame, lo, hi, bits=bits)


# ---------------------------------------------------------------------------
# the entropy stage's device half
# ---------------------------------------------------------------------------


def entropy_residuals(
    frames: torch.Tensor,  # (H, W) or (B, H, W) float
    refs: torch.Tensor,  # like frames
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The XOR residual planes of ``frames`` against ``refs`` and their
    per-tile significant-bit widths: ``(delta_bits, mask, widths)``, the
    reference's ``delta_encode`` (``delta_encode_batched`` for B planes)
    and ``significant_bit_widths`` of its delta, bit for bit.  A tile's
    coded size is ``ceil(tile_samples * width / 8) + 1`` bytes; the host
    coder (``codec.ref.entropy_encode_words``) takes the delta from
    here."""
    return kernels._delta_encode_widths(frames, refs, threshold=threshold,
                                        block_h=block_h, block_w=block_w)


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


class DeltaStreamEncoder:
    """Packetizes frames as keyframes + XOR deltas with loss-driven
    resync: after :meth:`report_loss`, a keyframe is forced within
    ``resync_bound`` packets, so a receiver that lost its reference is
    never stranded longer than the bound.

    Frames stay on their device: a CUDA frame is encoded by one launch
    of K3 that also writes the next reference.  The encoder keeps its
    own copy of each reference and a keyframe packet carries another, so
    neither the caller's frame nor the packet aliases the encoder's
    state.
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
        _ref._check_blocks(h, w, self.block_h, self.block_w)
        # the encoder tracks the RECEIVER's reconstruction (unchanged
        # tiles keep the old reference), not the source frame: the
        # closed-loop discipline that stops drift from accumulating
        delta_bits, _, self._ref = kernels._delta_encode_recon(
            frame,
            self._ref,
            threshold=self.threshold,
            block_h=self.block_h,
            block_w=self.block_w,
        )
        self._since_key += 1
        if self._deltas_left is not None:
            self._deltas_left -= 1
        return StreamPacket(seq, "delta", seq - 1, delta_bits)


class DeltaStreamDecoder:
    """Receiver of a :class:`DeltaStreamEncoder` stream.

    ``decode`` returns the reconstructed frame, or None (a NACK) when a
    delta references a reconstruction this decoder does not hold: a
    stale or missing reference must never be decoded against.  It
    decodes on the payload's device (for CUDA tensors one launch of K4,
    which writes both copies below).  It keeps its own copy of each
    reference and returns another, so changing a decoded frame in place
    cannot corrupt the base of the next delta.
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
        self._ref, out = kernels._delta_decode_pair(packet.payload, self._ref)
        self._ref_seq = packet.seq
        self.decoded += 1
        return out


def change_density(
    frames: torch.Tensor,  # (T, H, W) consecutive depth frames
    *,
    threshold: float = 0.0,
    block_h: int = DEFAULT_BLOCK_H,
    block_w: int = DEFAULT_BLOCK_W,
) -> torch.Tensor:
    """Per-transition fraction of changed tiles, shape (T-1,): the
    measured signal behind the codec model's change density.  The T-1
    transitions are encoded together (K3b's mask-only launch for CUDA
    frames); the plane is padded to whole tiles, as in the reference."""
    if frames.shape[0] < 2:
        raise ValueError("change_density needs at least two frames")
    mask = kernels._delta_mask(frames[1:], frames[:-1], threshold=threshold,
                               block_h=block_h, block_w=block_w)
    return mask.mean(dim=(1, 2))
