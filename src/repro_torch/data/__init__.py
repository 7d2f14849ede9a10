"""Data pipelines: synthetic RGBD sequences (``rgbd``)."""
