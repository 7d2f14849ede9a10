"""Optimizers (functional, over nested dicts of tensors)."""

from repro_torch.optim import adamw  # noqa: F401
