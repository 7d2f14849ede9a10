"""PyTorch/CUDA port of the per-frame generative hand tracker.

A second package beside the JAX reference ``repro``: the same modules
under the same names, written in PyTorch, with the reference's two TPU
kernels on the tracker's path (population render + score, PSO update)
rewritten as CUDA C++ kernels for Hopper (``csrc/``).  The package
imports ``torch`` and numpy only; the tests hold it against ``repro``.

* ``core``    — camera, hand model, objective, PSO, stages, tracker.
* ``kernels`` — the CUDA kernels' wrappers, their plain versions, the
  oracles and the ``nvcc`` build.
* ``data``    — synthetic RGBD sequences.
* ``sim``     — the 30 Hz frame-drop clock.
"""
