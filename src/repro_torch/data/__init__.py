"""Data pipelines: synthetic RGBD sequences + LM token streams."""

from repro_torch.data import rgbd, tokens  # noqa: F401
