"""Distributed BoxMG solvers over a JAX device mesh.

The JAX counterpart of the reference's `mpi::solver`
(include/cedar/2d/mpi/solver.h, 3d/mpi/solver.h).  Differences by design
(SURVEY §2.3):

* the grid is one logically-global array block-partitioned by a
  `NamedSharding` instead of per-rank local arrays + ghost rings;
* halo exchange is not a subsystem: the SPMD partitioner lowers every
  shifted-window read inside the jitted cycle to halo collective-permutes
  between devices, overlapped with compute (replaces MSG/Tausch and the
  per-color exchange calls in BMG2_SymStd_relax_GS.f90:124-126);
* multicolor sweeps agree across any sharding because color masks are
  anchored to global indices (the reference anchors to iGs/jGs parity);
* coarse-grid agglomeration = per-level sharding constraints from
  :mod:`cedar_jax.parallel.policy`, applied both to the stored hierarchy
  and inside the cycle (after restrict / interp_add);
* `setup_nog` (global level-count agreement via MPI_Allreduce) is
  unnecessary: level counts are computed from global extents on the host,
  identically everywhere.

Setup itself runs sharded: the fine stencil is committed to the mesh before
the jitted setup pieces run, so interpolation/Galerkin products execute
distributed.
"""

from __future__ import annotations

import jax
from jax.sharding import PartitionSpec as P

from cedar_jax.config import Config
from cedar_jax.core.types import StencilKind
from cedar_jax.parallel.policy import (
    batched_sharding,
    func_sharding,
    level_specs,
)
from cedar_jax.parallel.topo import make_mesh
from cedar_jax.solver.solver2 import Solver2
from cedar_jax.solver.solver3 import Solver3


def _place_level(lev, mesh, spec, min_local: int = 8):
    """Commit a level's arrays to the mesh under the level's spec.

    Axes whose extent does not divide the mesh dimension are replicated for
    that array (committed shardings must divide evenly; e.g. CI planes have
    one extra high entry per axis)."""
    ndim = len(spec)

    def put(name, a):
        if a is None:
            return None
        if name == "ainv":
            return jax.device_put(a, func_sharding(mesh, P()))
        nlead = a.ndim - ndim
        names = [
            ax
            if ax is not None and a.shape[nlead + d] % mesh.shape[ax] == 0
            else None
            for d, ax in enumerate(spec)
        ]
        return jax.device_put(
            a, batched_sharding(mesh, P(*names), nlead)
        )

    # `inner` (nested coarse-solver hierarchy, cg-solver "cedar"/"redist")
    # is an independent pytree and lives replicated on the agglomerated
    # coarse level; `planes` (batched 2D plane hierarchies) distribute via
    # _place_planes — the analogue of the reference's sliced plane
    # communicators (include/cedar/3d/mpi/relax_planes.h:219-298)
    skip = ("planes", "inner")
    out = {
        name: (put(name, val) if name not in skip else val)
        for name, val in lev._asdict().items()
    }
    if out.get("planes") is not None:
        out["planes"] = {
            orient: _place_planes(hier, mesh, spec, orient, min_local)
            for orient, hier in out["planes"].items()
        }
    return type(lev)(**out)


def _place_planes(hier, mesh, spec, orient, min_local: int = 8):
    """Distribute a batched plane hierarchy over the mesh.

    The reference slices the 3D communicator by out-of-plane coordinate so
    each plane solve runs distributed on the in-plane process grid
    (include/cedar/3d/mpi/relax_planes.h:219-298).  Here the vmapped
    hierarchy gets the same decomposition as sharding specs: the
    plane-batch axis over the out-of-plane mesh axis (zebra color slicing
    halves the batch, so it must divide 2x the mesh dim), and each embedded
    2D level's in-plane dims over the in-plane mesh axes while the local
    extent stays >= min_local (the redistribution threshold — embedded
    coarse levels agglomerate just like outer ones).  Non-divisible or
    replicated outer axes fall back per-array, as everywhere else."""
    from jax.sharding import NamedSharding

    from cedar_jax.ops.planes3 import PLANE_SPECS

    pax = PLANE_SPECS[orient][0]
    inplane = [d for d in range(3) if d != pax]
    bname = spec[pax]

    def put2(a, n1, n2):
        if a is None:
            return None
        names = [None] * a.ndim
        if (
            bname is not None
            and a.shape[0] % (2 * mesh.shape[bname]) == 0
        ):
            names[0] = bname
        if a.ndim >= 3 and a.shape[-2:] == (n1, n2):
            for k, d in enumerate(inplane):
                ax = spec[d]
                dim = a.shape[a.ndim - 2 + k]
                if (
                    ax is not None
                    and dim % mesh.shape[ax] == 0
                    and dim // mesh.shape[ax] >= min_local
                ):
                    names[a.ndim - 2 + k] = ax
        return jax.device_put(a, NamedSharding(mesh, P(*names)))

    out = []
    for lev2 in hier:
        n1, n2 = lev2.so.shape[-2:]
        out.append(jax.tree.map(lambda a: put2(a, n1, n2), lev2))
    return tuple(out)


def _resolve_backend_for_mesh(conf: Config, mesh) -> None:
    """Resolve kernels.backend "auto" to XLA for a distributed solver.

    The fused Pallas sweep is a single-device kernel; sharded levels run
    the XLA sweeps, whose shifted reads the SPMD partitioner lowers to
    halo exchanges.  An explicit "pallas" is still checked against the
    mesh's platform."""
    if conf.get("kernels.backend", "auto") == "auto":
        conf.set("kernels.backend", "xla")
    else:
        from cedar_jax.settings import resolve_backend

        resolve_backend(conf.get("kernels.backend"),
                        next(iter(mesh.devices.flat)).platform)


class _DistMixin:
    """Sharding plumbing shared by the 2D/3D distributed solvers."""

    # -- uneven-extent distribution via inert padding ---------------------
    # XLA committed shardings must divide evenly, so the reference's
    # parity-aware uneven block partition (include/cedar/mpi/
    # block_partition.h:8-34, 2d/mpi/solver.h:176-196) maps to padding
    # each non-divisible axis with DECOUPLED rows (zero couplings, unit
    # diagonal, zero rhs).  The stored-zero boundary convention means the
    # pad never interacts with the real block: relaxation keeps it at
    # zero, interpolation weights into it vanish through the collapse
    # guard, Galerkin coarse entries of real points are untouched — the
    # padded solve's trajectory on the real region is exactly the
    # unpadded one's (the level count is pinned to the TRUE extents so
    # hierarchies agree level-by-level).

    def _pad_operator(self, so, conf: Config, mesh):
        """Pad non-divisible fine axes to a multiple of ``2^L * mesh_dim``
        where L is the deepest level whose local extent still clears the
        redistribution threshold — even-extent halving then keeps every
        level down to L divisible, so the whole feasible hierarchy
        shards.  The pad fraction is bounded by ``1/min_local`` (the pad
        is < one coarsest-shardable-level block).  The reference instead
        partitions any extent unevenly per level
        (include/cedar/mpi/block_partition.h:8-34); even XLA shardings +
        bounded inert padding is the equivalent here.  Returns the
        padded operator; records the true extents for solve()/vcycle()
        to slice results back."""
        import jax.numpy as jnp

        ndim = self._ndim
        dims = so.shape[1:]
        self._true_dims = tuple(dims)
        axes = mesh.axis_names
        per = list(conf.get("grid.periodic", [])) + [False] * ndim
        min_local = conf.get("redist.min-local", 8)
        pads = []
        for d in range(ndim):
            nd = mesh.shape[axes[d]]
            n = dims[d]
            # periodic axes cannot take an inert pad (it would sit between
            # the wrap neighbors); they keep the replication fallback —
            # an odd-extent periodic axis replicates, which the perf
            # model prices as the redundant redistribution mode
            if nd > 1 and n % nd and not per[d]:
                L = 1
                while n >= 2 ** (L + 1) * nd * max(min_local, 1):
                    L += 1
                m = 2 ** L * nd
                pads.append(-(-n // m) * m - n)
            else:
                pads.append(0)
        if not any(pads):
            return so
        # pin the hierarchy depth to the true extents (identical to the
        # serial solver's) unless explicitly configured
        from cedar_jax.settings import MLSettings

        st = MLSettings.from_config(conf)
        if st.num_levels <= 0:
            if ndim == 2:
                from cedar_jax.solver.solver2 import compute_num_levels
            else:
                from cedar_jax.solver.solver3 import compute_num_levels
            conf.set("solver.num-levels",
                     compute_num_levels(*dims, st.min_coarse))
        sop = jnp.pad(so, ((0, 0),) + tuple((0, p) for p in pads))
        for d, p in enumerate(pads):
            if p:
                idx = (0,) + tuple(
                    slice(dims[i], None) if i == d else slice(None)
                    for i in range(ndim)
                )
                sop = sop.at[idx].set(1.0)    # index 0 = diagonal plane
        return sop

    def _pad_func(self, a):
        import jax.numpy as jnp

        dims = getattr(self, "_true_dims", None)
        if dims is None or tuple(a.shape) == tuple(self.shapes[0]):
            return a
        return jnp.pad(a, tuple(
            (0, p - n) for n, p in zip(dims, self.shapes[0])
        ))

    def _unpad_func(self, a):
        dims = getattr(self, "_true_dims", None)
        if dims is None or tuple(a.shape) == tuple(dims):
            return a
        return a[tuple(slice(0, n) for n in dims)]

    def _dist_init(self, conf: Config, mesh):
        ndim = self._ndim
        self.mesh = mesh if mesh is not None else make_mesh(ndim)
        if len(self.mesh.axis_names) != ndim:
            raise ValueError(
                f"need a {ndim}-axis mesh, got {self.mesh.axis_names}"
            )
        strategy = conf.get("redist.search.strategy", "coarsen")
        path = conf.get("redist.search.path", None)
        min_local = conf.get("redist.min-local", 8)
        self._min_local = min_local
        machine = None
        if strategy == "astar":
            from cedar_jax.perf import MachineParams

            machine = MachineParams.from_config(conf)
        self.specs = level_specs(
            self.shapes, self.mesh, min_local=min_local,
            strategy=strategy, path=path, machine_params=machine,
        )

    def _shard_fine(self, so, conf, mesh):
        """Commit the fine operator before setup so setup runs sharded."""
        ndim = self._ndim
        mesh = mesh if mesh is not None else make_mesh(ndim)
        names = [
            ax if so.shape[1 + d] % mesh.shape[ax] == 0 else None
            for d, ax in enumerate(mesh.axis_names)
        ]
        return (
            jax.device_put(so, batched_sharding(mesh, P(*names), 1)),
            mesh,
        )

    def _apply_policy(self):
        min_local = getattr(self, "_min_local", 8)
        self.levels = tuple(
            _place_level(lev, self.mesh, self.specs[i], min_local)
            for i, lev in enumerate(self.levels)
        )
        self._dist_line_workspaces()
        self.constraints = [
            func_sharding(self.mesh, spec) for spec in self.specs
        ]
        # re-jit with the constrained cycle
        self._solve_jit = jax.jit(self._solve_impl)
        self._cycle_jit = jax.jit(self._cycle_impl)

    def _dist_line_workspaces(self):
        """Swap eligible levels' line workspaces for distributed SPIKE
        (interface-reduction) factors — the reference's one-gather-per-
        color distributed zebra scheme (LineSolve_A/B/C,
        src/2d/ftn/mpi/BMG2_SymStd_relax_lines_x.f90:156-277).  Levels
        whose line axis is unsharded, unevenly split, or periodic keep
        the LDLᵀ workspace (line-axis-local PCR via shard_map); so does
        everything when solver.ml-relax.enabled selects the log-depth
        algorithm (the reference's "n-level" ml_relax variant)."""
        if self._ndim != 2 or self.settings.ml_relax_enabled:
            return
        from cedar_jax.ops import lines2

        out = []
        for i, lev in enumerate(self.levels):
            spec = tuple(self.specs[i])
            repl = {}
            for axis, field in (("x", "sor_x"), ("y", "sor_y")):
                if getattr(lev, field) is None:
                    continue
                shape = lev.so.shape[1:]
                if not lines2.dist_spike_eligible(
                    shape, spec, self.mesh, self.periodic, axis
                ):
                    continue
                la, ba = (spec if axis == "x" else (spec[1], spec[0]))
                repl[field] = lines2.setup_lines_spike_dist(
                    lev.so, self.kinds[i], axis, self.mesh, la, ba
                )
            out.append(lev._replace(**repl) if repl else lev)
        self.levels = tuple(out)

    def _put_fine_func(self, a):
        return jax.device_put(
            a, func_sharding(self.mesh, self.specs[0])
        )

    def solve(self, b, x0=None):
        import jax.numpy as jnp

        b = self._put_fine_func(self._pad_func(b))
        if x0 is None:
            x0 = jnp.zeros_like(b)
        else:
            x0 = self._put_fine_func(self._pad_func(x0))
        return self._unpad_func(super().solve(b, x0))

    def vcycle(self, x, b):
        return self._unpad_func(super().vcycle(
            self._put_fine_func(self._pad_func(x)),
            self._put_fine_func(self._pad_func(b)),
        ))


class DistSolver2(_DistMixin, Solver2):
    """2D BoxMG block-partitioned over a 2-axis device mesh."""

    _ndim = 2

    def __init__(self, so, kind=StencilKind.five_pt, conf=None, mesh=None):
        if not isinstance(conf, Config):
            conf = Config(conf)
        mesh = mesh if mesh is not None else make_mesh(self._ndim)
        so = self._pad_operator(so, conf, mesh)
        so, mesh = self._shard_fine(so, conf, mesh)
        _resolve_backend_for_mesh(conf, mesh)
        super().__init__(so, kind, conf)
        self._dist_init(conf, mesh)
        self._apply_policy()


class DistSolver3(_DistMixin, Solver3):
    """3D BoxMG block-partitioned over a 3-axis device mesh."""

    _ndim = 3

    def __init__(self, so, kind=StencilKind.seven_pt, conf=None, mesh=None):
        if not isinstance(conf, Config):
            conf = Config(conf)
        mesh = mesh if mesh is not None else make_mesh(self._ndim)
        so = self._pad_operator(so, conf, mesh)
        so, mesh = self._shard_fine(so, conf, mesh)
        _resolve_backend_for_mesh(conf, mesh)
        super().__init__(so, kind, conf)
        self._dist_init(conf, mesh)
        self._apply_policy()
