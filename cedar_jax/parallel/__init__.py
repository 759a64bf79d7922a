"""Distributed (multi-device) execution over a JAX device mesh.

The JAX replacement for the reference's distributed runtime
(include/cedar/mpi/*, include/cedar/{2,3}d/mpi/*; SURVEY §2.3):

* `grid_topo` + MPI_Dims_create          -> :mod:`cedar_jax.parallel.topo`
* MSG/Tausch halo exchange               -> XLA SPMD collective-permutes
  inserted for the shifted-window reads inside one jitted cycle
* coarse-grid redistribution/agglomeration (redist_solver.h)
                                         -> per-level sharding policy
  (:mod:`cedar_jax.parallel.policy`): fine levels block-partitioned over
  the mesh, coarse levels constrained onto shrinking mesh subsets and
  finally replicated (the "redundant" mode of the reference: a replicated
  small solve costs less than a scatter)
* distributed solvers                    -> :mod:`cedar_jax.parallel.dist`
"""

from cedar_jax.parallel.topo import make_mesh
from cedar_jax.parallel.policy import level_specs
from cedar_jax.parallel.dist import DistSolver2, DistSolver3

__all__ = ["make_mesh", "level_specs", "DistSolver2", "DistSolver3"]
