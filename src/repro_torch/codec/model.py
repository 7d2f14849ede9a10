"""Analytic codec cost model — what the planner and fleet price with.

The kernels (``codec.kernels``) implement the wire format; this module
is its *cost-model twin*, the same split as
``costengine.BatchServiceModel`` vs the batched tracker kernels: a
frozen, hashable record the cost engine can price transfer legs with
and the plan cache can fingerprint.

A :class:`CodecModel` describes one operating point of the delta +
quantize pipeline:

* ``quant_bits`` — bits per depth sample on the wire (32 = raw f32,
  no quantizer);
* ``keyframe_interval`` — frames between keyframes; the frames in
  between ship only changed tiles (temporal delta);
* ``change_density`` — the *measured* fraction of tiles that change
  per delta frame (``codec.ref.change_density`` over a real sequence,
  or the rate controller's motion-driven estimate).

From these the model estimates compressed bytes
(:meth:`wire_nbytes`, amortized over one keyframe period) and prices
encode/decode compute per tier (:meth:`encode_time` /
:meth:`decode_time`) from per-byte costs calibrated against the
roofline tables (:meth:`from_roofline`) — encode runs where the
payload originates, decode where it lands, which is how
``core.costengine`` charges them.

:data:`IDENTITY` is the off-switch: its amortized ratio is 1.0, so it
never *applies* — every byte count and every charge is bit-for-bit the
raw path (golden-tested against ``codec=None`` in tests/test_codec.py).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.topology import Tier

BITS_RAW = 32


def tier_codec_rate(tier: Tier) -> float:
    """The FLOP rate codec work runs at on a tier — its accelerator
    when it has one (the kernels are device launches), scalar CPU
    otherwise.  Shared with the roofline calibration in
    ``sim.hardware.codec_point`` so model and calibration cannot
    diverge."""
    return tier.accel_flops if tier.has_accelerator else tier.scalar_flops

# Arithmetic cost of the kernels, counted per RAW payload byte from the
# kernel bodies (all elementwise vector work over f32 planes, 4 bytes per
# sample): delta encode does a subtract, abs, tile max-reduce, bitcast
# XOR and mask multiply (~5 ops/sample) plus the quantizer's clip,
# scale, round and shift/accumulate packing (~6 ops/sample) — ~11 ops
# per sample, ~3 per byte; decode inverts only the cheap half (XOR add
# back, unpack shift/mask, dequant multiply-add — ~6 ops/sample).
ENCODE_OPS_PER_BYTE = 3.0
DECODE_OPS_PER_BYTE = 1.5


@dataclasses.dataclass(frozen=True)
class CodecModel:
    """One codec operating point, priced analytically.

    Flat floats/ints only (like ``Tier``'s batching fields) so the plan
    cache can hash the whole record into its keys: two clients at the
    same operating point share one cached plan, and a rate-controller
    switch is a cache miss by construction.

    ``encode_flops_per_byte`` / ``decode_flops_per_byte`` convert raw
    payload bytes into tier-rate work; :meth:`from_roofline` calibrates
    them with a memory-bandwidth floor (the codec is elementwise, so on
    an accelerator it is bandwidth-bound: equivalent flops/byte can
    never fall below the tier's flops-to-bytes balance).
    ``min_payload_nbytes`` gates tiny payloads (pose vectors, result
    items): headers would dominate and nothing is saved.
    """

    name: str
    quant_bits: int = BITS_RAW
    keyframe_interval: int = 1
    change_density: float = 1.0
    header_nbytes: int = 0
    min_payload_nbytes: int = 4096
    encode_flops_per_byte: float = 0.0
    decode_flops_per_byte: float = 0.0
    # entropy stage over the delta residuals (codec.ref's zero-run /
    # significant-bit-width coding of the XOR residual words): shrinks
    # delta frames by `entropy_ratio` (measured on a real sequence) at
    # `entropy_flops_per_byte` extra CPU per raw byte on each side.
    # Off by default — the exact historical model.
    entropy_coding: bool = False
    entropy_ratio: float = 1.0
    entropy_flops_per_byte: float = 0.0

    def __post_init__(self) -> None:
        if not 1 <= self.quant_bits <= BITS_RAW:
            raise ValueError(f"quant_bits must be in [1, 32], got {self.quant_bits}")
        if self.keyframe_interval < 1:
            raise ValueError("keyframe_interval must be >= 1")
        if not 0.0 <= self.change_density <= 1.0:
            raise ValueError("change_density must be in [0, 1]")
        if self.header_nbytes < 0 or self.min_payload_nbytes < 0:
            raise ValueError("byte bounds must be >= 0")
        if self.encode_flops_per_byte < 0 or self.decode_flops_per_byte < 0:
            raise ValueError("flops-per-byte must be >= 0")
        if not 0.0 < self.entropy_ratio <= 1.0:
            raise ValueError("entropy_ratio must be in (0, 1]")
        if self.entropy_flops_per_byte < 0:
            raise ValueError("entropy_flops_per_byte must be >= 0")

    # -- compression ratios -------------------------------------------------

    @property
    def keyframe_ratio(self) -> float:
        """Wire bytes per raw byte of a keyframe (quantizer only)."""
        return self.quant_bits / BITS_RAW

    @property
    def delta_ratio(self) -> float:
        """Wire bytes per raw byte of a delta frame: only changed tiles
        ship, each at the quantized width — the composed quantized-delta
        format of ``codec.ref.encode_frame`` (codes delta'd in code
        space, NOT the 32-bit XOR residuals of the lossless f32 path),
        whose exact byte count matches this ratio (tested).  With the
        entropy stage armed, delta payloads shrink further by
        ``entropy_ratio`` (keyframes ship dense code words, which the
        width coder cannot touch — only residuals are sparse)."""
        if self.entropy_coding:
            return self.change_density * self.keyframe_ratio * self.entropy_ratio
        return self.change_density * self.keyframe_ratio

    @property
    def ratio(self) -> float:
        """Amortized wire ratio over one keyframe period: 1 keyframe +
        (K-1) delta frames."""
        k = self.keyframe_interval
        return (self.keyframe_ratio + (k - 1) * self.delta_ratio) / k

    # -- byte accounting ----------------------------------------------------

    def applies(self, nbytes: int) -> bool:
        """Whether this payload is transformed at all — False for tiny
        payloads and for any operating point that does not compress
        (the identity codec, by construction)."""
        return nbytes >= self.min_payload_nbytes and self.ratio < 1.0

    def wire_nbytes(self, nbytes: int) -> int:
        """Estimated bytes on the wire for a raw payload of ``nbytes``
        (amortized over a keyframe period); never exceeds the raw size
        and respects the raw + header bound by construction."""
        if not self.applies(nbytes):
            return nbytes
        return min(nbytes, self.header_nbytes + math.ceil(nbytes * self.ratio))

    def state_applies(self, nbytes: int) -> bool:
        """Whether a *stateful one-shot* transfer (live-migration pose +
        swarm payload) is transformed: the destination holds no
        reference frame, so only the quantizer can apply — never the
        delta ratio."""
        return nbytes >= self.min_payload_nbytes and self.keyframe_ratio < 1.0

    def state_wire_nbytes(self, nbytes: int) -> int:
        """Wire bytes for a one-shot state transfer: keyframe pricing
        (quantizer only), same raw-size clamp as :meth:`wire_nbytes`."""
        if not self.state_applies(nbytes):
            return nbytes
        return min(
            nbytes,
            self.header_nbytes + math.ceil(nbytes * self.keyframe_ratio),
        )

    # -- compute pricing ----------------------------------------------------

    def _tier_rate(self, tier: Tier) -> float:
        return tier_codec_rate(tier)

    def encode_time(self, nbytes: int, tier: Tier) -> float:
        """Seconds to encode ``nbytes`` of raw payload on ``tier`` —
        charged at the payload's source.  The entropy stage, when
        armed, adds its per-byte cost here (the coder runs over the
        residual plane after the quantizer)."""
        if not self.applies(nbytes):
            return 0.0
        fpb = self.encode_flops_per_byte
        if self.entropy_coding:
            fpb = fpb + self.entropy_flops_per_byte
        return fpb * nbytes / self._tier_rate(tier)

    def decode_time(self, nbytes: int, tier: Tier) -> float:
        """Seconds to decode back to the raw payload on ``tier`` —
        charged at the destination (on a contended edge this lands in
        ``compute_by_tier`` and therefore occupies a service slot)."""
        if not self.applies(nbytes):
            return 0.0
        fpb = self.decode_flops_per_byte
        if self.entropy_coding:
            fpb = fpb + self.entropy_flops_per_byte
        return fpb * nbytes / self._tier_rate(tier)

    def state_encode_time(self, nbytes: int, tier: Tier) -> float:
        """Encode cost of a one-shot state transfer (quantizer only)."""
        if not self.state_applies(nbytes):
            return 0.0
        return self.encode_flops_per_byte * nbytes / self._tier_rate(tier)

    def state_decode_time(self, nbytes: int, tier: Tier) -> float:
        """Decode cost of a one-shot state transfer (quantizer only)."""
        if not self.state_applies(nbytes):
            return 0.0
        return self.decode_flops_per_byte * nbytes / self._tier_rate(tier)

    # -- calibration --------------------------------------------------------

    @classmethod
    def from_roofline(
        cls,
        name: str,
        *,
        quant_bits: int,
        keyframe_interval: int,
        change_density: float,
        encode_flops: float,
        encode_mem_bandwidth: float,
        decode_flops: float,
        decode_mem_bandwidth: float,
        header_nbytes: int = 64,
        min_payload_nbytes: int = 4096,
    ) -> "CodecModel":
        """Calibrate per-byte compute from the roofline tables.

        ``encode_flops`` / ``decode_flops`` are the effective FLOP/s of
        the tier each side runs on (encode at the payload source,
        decode at the destination), ``*_mem_bandwidth`` their memory
        bandwidths.  The codec is elementwise, so each side's cost is
        the roofline max of its arithmetic (``*_OPS_PER_BYTE``) and its
        streaming floor — the flops-per-byte equivalent of moving every
        payload byte through memory at least once (``rate / mem_bw``).
        """
        enc_floor = encode_flops / encode_mem_bandwidth
        dec_floor = decode_flops / decode_mem_bandwidth
        return cls(
            name=name,
            quant_bits=quant_bits,
            keyframe_interval=keyframe_interval,
            change_density=change_density,
            header_nbytes=header_nbytes,
            min_payload_nbytes=min_payload_nbytes,
            encode_flops_per_byte=max(ENCODE_OPS_PER_BYTE, enc_floor),
            decode_flops_per_byte=max(DECODE_OPS_PER_BYTE, dec_floor),
        )


# The golden off-switch: ratio == 1.0, so `applies` is always False and
# every cost-engine path is bit-for-bit the raw path.
IDENTITY = CodecModel(name="identity")
