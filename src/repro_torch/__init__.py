"""PyTorch/CUDA port of the per-frame generative hand tracker.

A second package beside the JAX reference ``repro``: the same modules
under the same names, written in PyTorch, with the reference's TPU
kernels on the ported paths rewritten as CUDA C++ kernels for Hopper
(``csrc/``): the tracker's population render + score and PSO update,
their batched forms for the edge server, and the uplink's codec.
The package imports ``torch`` and numpy only; the tests hold it against
``repro``.

* ``core``    — camera, hand model, objective, PSO, stages, tracker,
  topology.
* ``kernels`` — the render/score and PSO kernels' wrappers, their plain
  versions, the oracles and the ``nvcc`` build.
* ``codec``   — the uplink's codec: the delta, quantizer and bit-width
  kernels' wrappers, the plain versions, the stream machines, the
  entropy coder, the codec cost model and the rate controller.
* ``data``    — synthetic RGBD sequences.
* ``sim``     — the 30 Hz frame-drop clock.
"""
