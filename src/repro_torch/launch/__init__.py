"""Launchers: the serving driver (``serve``)."""
