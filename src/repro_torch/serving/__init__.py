"""Serving runtime: batched engine, continuous batching, tiered edge
placement."""

from repro_torch.serving import continuous, edge, engine  # noqa: F401
