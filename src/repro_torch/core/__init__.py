"""The tracker's core modules (``handmodel``, ``camera``, ``objective``,
``pso``, ``stages``, ``tracker``).  Nothing is imported eagerly: import
the module you need."""
