"""The tracker's two kernels, written in CUDA C++ for Hopper (``csrc/``).

* ``render_score`` — fused population render + E_D scoring (K1);
  ``ops.render_score`` is the padding/normalizing wrapper, ``ref`` the
  plain oracle.
* ``pso_update`` — fused swarm velocity/position update (K2);
  ``pso_ref`` is the plain oracle.
* ``_build`` — compiles ``csrc/*.cu`` with nvcc and binds it via ctypes.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors.  Importing these modules needs no GPU and no
compiler: the build happens at the first launch.
"""
