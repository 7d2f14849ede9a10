"""PyTorch/CUDA port of the per-frame generative hand tracker and its
edge deployment.

A second package beside the JAX reference ``repro``: the same modules
under the same names, written in PyTorch, with the reference's TPU
kernels on the ported paths rewritten as CUDA C++ kernels for Hopper
(``csrc/``): the tracker's population render + score and PSO update,
their batched forms for the edge server, and the uplink's codec.
The package imports ``torch`` and numpy only; the tests hold it against
``repro``.

* ``core``     — the tracker: camera, hand model, objective, PSO, stages
  and ``tracker``; and the offload decision: ``topology``,
  ``costengine`` (every transfer, wrapper and compute cost),
  ``planners``, ``offload`` (the RAPID policies over a topology),
  ``workloads`` (the multi-model registry) and ``wrapper`` (the
  container tax, modelled and measured on the card).
* ``kernels``  — the render/score and PSO kernels' wrappers, their plain
  versions, the oracles and the ``nvcc`` build.
* ``codec``    — the uplink's codec: the delta, quantizer and bit-width
  kernels' wrappers, the plain versions, the stream machines, the
  entropy coder, the codec cost model and the rate controller.
* ``data``     — synthetic RGBD sequences.
* ``net``      — calibrated link models and simulated transport.
* ``sim``      — the 30 Hz frame-drop clock, the paper's modelled
  hardware tiers and fleet topologies (``hardware``), and the edge
  runtime (``runtime``: the analytic simulator and ``executed_run``,
  which runs the tracker on the card under a plan).
* ``cluster``  — the fleet: many thin clients against shared edge
  servers, on an object and a vectorized discrete-event engine, with
  dispatch, plan caching, migration, the rate-controlled codec,
  telemetry and the SLO doctor (host code, as in the reference).
* ``examples`` — the reference's example programs, run as modules:
  ``quickstart``, ``edge_offload_serve`` and ``fleet_sim``.
"""
