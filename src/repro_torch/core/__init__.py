"""The tracker's core modules (``handmodel``, ``camera``, ``objective``,
``pso``, ``stages``, ``tracker``) and the offload layer (``topology``,
``costengine``, ``planners``, ``offload``, ``workloads``, ``wrapper``).
Nothing is imported eagerly: import the module you need."""
