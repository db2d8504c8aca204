"""fvens_tpu: a JAX unstructured finite-volume solver for the 2D
compressible Euler and Navier-Stokes equations, run on a GPU.

A ground-up JAX/XLA re-design with the capabilities of the FVENS
reference solver (cell-centred FV, hybrid tri/quad meshes, explicit and
implicit pseudo-time continuation). The unstructured mesh is compiled once
on the host into static, padded structure-of-arrays index maps; all numerics
run as jitted, shape-static JAX kernels on device:

  - face flux loops   -> gather + vmapped pointwise kernels over face batches
  - atomic scatters   -> per-cell incidence gathers (deterministic sums)
  - hand-written flux/BC Jacobians -> jax.jacfwd of the flux kernels
  - PETSc Krylov + ILU -> native FGMRES with block-structured preconditioners
  - MPI domain decomposition -> jax.sharding/shard_map halo exchange

Reference layer map: see SURVEY.md (FVENS, /root/reference).
"""

import jax as _jax

# The solver targets PETSc-grade convergence (1e-6..1e-10 relative residual);
# float64 must be available. Individual kernels/benchmarks may still request
# float32 explicitly. (Reference: FVENS uses freal=double, aconstants.hpp:60.)
_jax.config.update("jax_enable_x64", True)

NDIM = 2
NVARS = 4

__version__ = "0.1.0"
