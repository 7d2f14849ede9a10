"""Payload codec of the uplink: the client's depth stream crosses the
network as quantized, bit-packed keyframes plus per-tile deltas, which
the edge encodes and decodes on the card.

* ``codec.ref``     — the plain versions and oracles: the shape-strict
  delta codec, the quantizer and packer, the composed
  ``encode_frame``/``decode_frame``, the entropy stage's host coder
  (numpy) and the exact wire accounting;
* ``codec.kernels`` — the CUDA kernels and their wrappers: K3
  (``delta_encode``), K3b (``delta_encode_batched``), K4
  (``delta_decode``), K5/K5b (``significant_bit_widths[_batched]``),
  K6/K6b (``quantize_pack[_batched]``) and K7 (``unpack_dequantize``);
* ``codec.wire``    — what runs on the kernels: ``encode_frame``,
  ``decode_frame`` and ``encode_keyframe``, the entropy stage's
  ``entropy_residuals``, the stream machines
  (:class:`DeltaStreamEncoder`, :class:`DeltaStreamDecoder`) and
  ``change_density``;
* ``codec.model``   — the analytic :class:`CodecModel` that prices an
  operating point (:data:`IDENTITY` is the bit-for-bit off-switch);
* ``codec.rate``    — the per-client :class:`RateController` that picks
  the quantizer's bits and the keyframe interval from link pressure and
  scene motion, and ``calibrate_density_map``, its motion -> density
  fit.
"""

from repro_torch.codec.model import (  # noqa: F401
    BITS_RAW,
    CodecModel,
    IDENTITY,
)
from repro_torch.codec.rate import (  # noqa: F401
    CodecConfig,
    RateController,
    calibrate_density_map,
    identity_config,
    motion_profile,
    sequence_motion,
)
from repro_torch.codec.ref import (  # noqa: F401
    DEFAULT_BLOCK_H,
    DEFAULT_BLOCK_W,
    PACKABLE_BITS,
    encoded_nbytes_exact,
    entropy_decode_words,
    entropy_encode_words,
    entropy_encoded_nbytes,
    quant_step,
)
from repro_torch.codec.wire import (  # noqa: F401
    DeltaStreamDecoder,
    DeltaStreamEncoder,
    StreamPacket,
    change_density,
    decode_frame,
    encode_frame,
    encode_keyframe,
    entropy_residuals,
)
