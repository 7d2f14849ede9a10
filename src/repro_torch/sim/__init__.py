"""Deployment simulation: the 30 Hz real-time clock (``clock``), the
paper's modelled hardware tiers (``hardware``) and the edge runtime
(``runtime``).  Nothing is imported eagerly: import the module you need."""
