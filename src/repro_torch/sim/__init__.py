"""Deployment simulation: the 30 Hz real-time clock (``clock``)."""
