"""The tracker's kernels and their batched forms for the edge server,
written in CUDA C++ for Hopper (``csrc/``).

* ``render_score`` — fused population render + E_D scoring (K1), and B
  clients' populations in one launch (K1b); ``ops.render_score`` and
  ``ops.render_score_batched`` are the padding/normalizing wrappers,
  ``ref`` holds the plain oracles.
* ``pso_update`` — fused swarm velocity/position update (K2), and B
  swarms in one launch (K2b); ``pso_ref`` holds the plain oracles.
* ``hand_spheres`` — forward kinematics (FK): a population's spheres in
  one launch, the tracker's evaluation's input to K1; its plain version
  is ``core.handmodel.pack_spheres``.
* ``_build`` — compiles every ``csrc/*.cu`` (these kernels and the
  codec's, ``repro_torch.codec.kernels``) with nvcc and binds the
  library via ctypes.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors.  Importing these modules needs no GPU and no
compiler: the build happens at the first launch.
"""
