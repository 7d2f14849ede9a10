"""Sharding rules for params, inputs, activations and caches, as
DTensor placements."""

from repro_torch.sharding import specs  # noqa: F401
