"""Measurements of the port's kernels on a CUDA card, run as scripts
(``python3 -m repro_torch.bench.<name>``); nothing here is imported by
the package."""
