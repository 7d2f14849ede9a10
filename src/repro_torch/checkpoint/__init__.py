"""npz checkpointing in the reference's on-disk format."""

from repro_torch.checkpoint import io  # noqa: F401
