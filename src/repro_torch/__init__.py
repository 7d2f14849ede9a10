"""PyTorch/CUDA port of the per-frame generative hand tracker.

A second package beside the JAX reference ``repro``: the same modules
under the same names, written in PyTorch, with the reference's TPU
kernels on the ported paths rewritten as CUDA C++ kernels for Hopper
(``csrc/``): the tracker's population render + score and PSO update,
their batched forms for the edge server, and the uplink's delta codec.
The package imports ``torch`` and numpy only; the tests hold it against
``repro``.

* ``core``    — camera, hand model, objective, PSO, stages, tracker.
* ``kernels`` — the render/score and PSO kernels' wrappers, their plain
  versions, the oracles and the ``nvcc`` build.
* ``codec``   — the uplink's temporal-delta codec: the delta kernels'
  wrappers, the plain versions and the stream machines.
* ``data``    — synthetic RGBD sequences.
* ``sim``     — the 30 Hz frame-drop clock.
* ``bench``   — measurement scripts for the card (K1's occupancy).
"""
