"""Roofline analysis of the dry run: the per-device op census
(``op_cost``), the roofline terms (``analysis``) and the tables
(``report``)."""

from repro_torch.roofline import analysis  # noqa: F401
