"""Per-level sharding policy — the mesh analogue of the reference's
coarse-grid redistribution (include/cedar/2d/mpi/redist_solver.h,
include/cedar/perf/predict.h `choose_redist`).

The reference re-partitions coarse levels onto geometrically shrinking
process subsets (manual path / "coarsen" halving / A*-searched), optionally
*redundantly* (every block solves a replica).  On a fixed device mesh the
partitioning degrees of freedom are the mesh axes: a level is
block-partitioned over a mesh axis or replicated along it.  The "coarsen"
strategy drops mesh axes one by one as local extents shrink below
``min_local``; the coarsest levels run fully replicated — the redundant
mode (a replicated small solve is cheaper than scatter/gather traffic
between devices).

Cited behavior: redistribution decision thresholds
(src/multilevel_settings.cc:102-125), redundant solve mode
(2d/mpi/redist_solver.h:330-347).
"""

from __future__ import annotations

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def level_specs(
    shapes,
    mesh: Mesh,
    min_local: int = 8,
    strategy: str = "coarsen",
    path=None,
    machine_params=None,
):
    """PartitionSpec per level for grid functions of the given shapes.

    strategy "coarsen": shard spatial axis d over mesh axis d while the
    local extent stays >= min_local; drop axes (replicate) below that —
    coarser levels use progressively fewer mesh axes until fully
    replicated.  strategy "manual": ``path`` lists per-level mesh-axis
    usage as the per-axis process counts (reference
    test/2d/mpi/test-cgredist-1.json), mapped to use/drop of each axis.
    strategy "astar": A*-searched schedule from the analytic machine model
    (reference: perf_factory::astar_vcycle + ss/astar.h).
    """
    axes = mesh.axis_names
    ndim = len(shapes[0])

    def feasible(lvl, d):
        """XLA requires committed shardings to divide evenly; coarse
        levels with odd extents therefore replicate along the axis — this
        IS the reference's redundant redistribution mode."""
        nd = mesh.shape[axes[d]]
        shape = shapes[lvl]
        return nd > 1 and shape[d] % nd == 0 and shape[d] // nd >= min_local

    if strategy == "astar":
        # optimal monotone agglomeration schedule from the analytic machine
        # model (cedar_jax.perf; reference: perf_factory::astar_vcycle)
        from cedar_jax.perf import MachineParams, search_schedule

        machine = machine_params or MachineParams()
        allowed = [
            sum(1 << d for d in range(ndim) if feasible(lvl, d))
            for lvl in range(len(shapes))
        ]
        mesh_dims = [mesh.shape[ax] for ax in axes[:ndim]]
        stencil_fine = 5 if ndim == 2 else 7
        stencil_coarse = 9 if ndim == 2 else 27
        masks, _ = search_schedule(
            shapes, mesh_dims, allowed, machine,
            stencil_fine=stencil_fine, stencil_coarse=stencil_coarse,
        )
        return [
            P(*[axes[d] if mask >> d & 1 else None for d in range(ndim)])
            for mask in masks
        ]

    specs = []
    for lvl, shape in enumerate(shapes):
        names = []
        for d in range(ndim):
            use = feasible(lvl, d)
            if strategy == "manual" and path is not None:
                ent = path[min(lvl, len(path) - 1)]
                nd = mesh.shape[axes[d]]
                use = use and (d < len(ent) and ent[d] >= nd)
            names.append(axes[d] if use else None)
        specs.append(P(*names))
    return specs


def func_sharding(mesh: Mesh, spec: P) -> NamedSharding:
    """Sharding of a grid function."""
    return NamedSharding(mesh, spec)


def batched_sharding(mesh: Mesh, spec: P, nlead: int = 1) -> NamedSharding:
    """Sharding of an array with ``nlead`` leading non-spatial axes
    (stencil direction / CI plane / batch axes stay unsharded)."""
    return NamedSharding(mesh, P(*([None] * nlead + list(spec))))
