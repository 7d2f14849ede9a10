"""Payload codec of the uplink: the temporal-delta half.

The client's depth stream crosses the network as keyframes plus XOR
deltas with per-tile change masks; the edge encodes and decodes them on
the card.

* ``codec.ref``     — the plain versions, the stream machines
  (:class:`DeltaStreamEncoder`, :class:`DeltaStreamDecoder`) and the
  exact wire accounting;
* ``codec.kernels`` — the CUDA kernels K3 (``delta_encode``), K3b
  (``delta_encode_batched``) and K4 (``delta_decode``) and their
  wrappers.

The quantizer, the entropy coder, the codec model and the rate
controller of the JAX package's ``codec`` are not ported yet.
"""

from repro_torch.codec.ref import (  # noqa: F401
    DEFAULT_BLOCK_H,
    DEFAULT_BLOCK_W,
    DeltaStreamDecoder,
    DeltaStreamEncoder,
    StreamPacket,
    change_density,
    encoded_nbytes_exact,
)
