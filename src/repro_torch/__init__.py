"""PyTorch/CUDA port of the per-frame generative hand tracker, its edge
deployment, and the LLM-decode analogue of the paper's technique.

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
* ``configs``  — the LLM analogue's ten architecture configs, the
  registry and the input shapes (``TensorSpec``: shape and torch dtype).
* ``models``   — its model substrate: layers, attention (GQA/MQA,
  windows, MLA, the chunked online softmax), SSM, MoE, the multimodal
  stubs and ``transformer`` (init, forward, prefill, caches, decode),
  over the reference's stacked parameter dicts; no kernel of its own.
* ``serving``  — the static ``Engine``, the ``ContinuousEngine`` and
  ``edge`` (one decode step placed across tiers by the offload planner).
* ``launch``   — ``serve`` and ``train``, the serving and training
  drivers (the card by default); ``mesh``, the production and host
  ``DeviceMesh``es; ``dryrun``, one step of every (arch, shape, mesh)
  combo on meta tensors in a fake process group of 256 or 512 ranks.
* ``sharding`` — the reference's sharding rules as DTensor placements.
* ``roofline`` — the per-device op census (``op_cost``, a
  ``TorchDispatchMode``), the roofline terms and the dry run's tables.
* ``optim``, ``checkpoint`` — AdamW and the npz checkpoint format.
* ``examples`` — the reference's example programs, run as modules:
  ``quickstart``, ``edge_offload_serve``, ``fleet_sim`` and
  ``llm_edge_decode``.
"""
