"""3D multilevel BoxMG solver.

Rebuilds the reference's `cdr3::solver<fsten>` + `multilevel` driver
(include/cedar/3d/solver.h:17-130, include/cedar/multilevel.h:26-318) the
same way as the 2D solver (:mod:`cedar_jax.solver.solver2`): jitted setup
over a static level pytree, `lax.while_loop` solve with the reference's
per-iteration relative-l2 logging.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp

from cedar_jax.config import Config
from cedar_jax.core.types import StencilKind
from cedar_jax.ops import cg
from cedar_jax.ops.galerkin3 import coarsen_op
from cedar_jax.ops.interp3 import setup_interp
from cedar_jax.ops.relax3 import setup_recip
from cedar_jax.ops.stencil3 import residual
from cedar_jax import schema
from cedar_jax.settings import (
    CGType, MLSettings, RelaxType, device_platform, resolve_backend,
)
from cedar_jax.solver.cycle3 import run_cycle
from cedar_jax.solver.level import Level
from cedar_jax.utils import log
from cedar_jax.utils.timing import TimeLog


def compute_num_levels(nx: int, ny: int, nz: int, min_coarse: int) -> int:
    """Halve until below min_coarse (reference: 3d/solver.h:68-84)."""
    ng = 0
    while True:
        ng += 1
        nc = [(n - 1) // (1 << ng) + 1 for n in (nx, ny, nz)]
        if min(nc) < min_coarse:
            return ng


def level_shapes(nx: int, ny: int, nz: int, nlevels: int):
    shapes = [(nx, ny, nz)]
    for _ in range(nlevels - 1):
        nx = (nx - 1) // 2 + 1
        ny = (ny - 1) // 2 + 1
        nz = (nz - 1) // 2 + 1
        shapes.append((nx, ny, nz))
    return shapes


# Module-level jitted setup pieces: one compile per (shape, kind) across the
# whole process — levels, solvers and tests share the cache, and each small
# graph compiles far faster than one inlined whole-hierarchy graph.
_setup_interp_j = jax.jit(setup_interp, static_argnames=("kind", "periodic"))
_coarsen_j = jax.jit(coarsen_op, static_argnames=("kind", "periodic"))
_recip_j = jax.jit(setup_recip)
_cg_j = jax.jit(
    cg.setup_cg_lu, static_argnames=("kind", "periodic", "indefinite")
)


def setup_hierarchy(
    so_fine: jnp.ndarray,
    fine_kind: StencilKind,
    nlevels: int,
    settings: MLSettings,
    periodic=(False, False, False),
    indefinite: bool = False,
):
    """Build the full level hierarchy (reference: multilevel.h:243-265)."""
    sos = [so_fine]
    kinds = [fine_kind]
    cis = [None]
    so, kind = so_fine, fine_kind
    for _ in range(nlevels - 1):
        ci = _setup_interp_j(so, kind=kind, periodic=periodic)
        so = _coarsen_j(ci, so, kind=kind, periodic=periodic)
        kind = StencilKind.twenty_seven_pt
        sos.append(so)
        kinds.append(kind)
        cis.append(ci)

    point = settings.relaxation == RelaxType.point

    levels = []
    for lvl in range(nlevels):
        if lvl < nlevels - 1:
            recip = _recip_j(sos[lvl]) if point else None
            levels.append(Level(so=sos[lvl], recip=recip, ci=cis[lvl]))
        else:
            if settings.coarse_solver != CGType.lu and nlevels > 1:
                # cg-solver "cedar"/"redist": inner multigrid on the
                # coarsest grid (reference: 3d/mpi/solver.h:174-200)
                ist = settings.cg_settings
                nc_ = sos[lvl].shape[1:]
                nl_in = compute_num_levels(*nc_, ist.min_coarse)
                if ist.num_levels > 0:
                    nl_in = min(nl_in, ist.num_levels)
                inner = setup_hierarchy(
                    sos[lvl], StencilKind.twenty_seven_pt, nl_in, ist,
                    periodic, indefinite,
                )
                levels.append(Level(so=sos[lvl], ci=cis[lvl], inner=inner))
            else:
                ainv = _cg_j(
                    sos[lvl], kind=kinds[lvl], periodic=periodic,
                    indefinite=indefinite,
                )
                levels.append(Level(so=sos[lvl], ci=cis[lvl], ainv=ainv))
    return tuple(levels)


def _l2(r):
    return jnp.sqrt(jnp.sum(r * r))


class Solver3:
    """3D BoxMG solver over interior-only JAX arrays.

    Parameters
    ----------
    so : (ndir, nx, ny, nz) stencil operator (SevenPt: [P,PW,PS,B];
        TwentySevenPt: all 14 planes)
    kind : StencilKind of the fine operator
    conf : Config | dict | None — Cedar-compatible configuration
    """

    def __init__(
        self,
        so: jnp.ndarray,
        kind: StencilKind = StencilKind.seven_pt,
        conf: Config | dict | None = None,
    ):
        if not isinstance(conf, Config):
            conf = Config(conf)
        schema.validate(conf)
        self.conf = conf
        self.settings = MLSettings.from_config(conf)
        log.set_enabled(conf.get("log", ["status", "error"]))
        self.kind = kind
        # 3D runs the XLA path everywhere; an explicit "pallas" still
        # resolves (and fails off the GPU) like the 2D solver's
        resolve_backend(conf.get("kernels.backend", "auto"),
                        device_platform(so))
        per = conf.get("grid.periodic", [False, False, False])
        while len(per) < 3:
            per = list(per) + [False]
        self.periodic = tuple(bool(p) for p in per[:3])
        self.indefinite = not conf.get("solver.definite", True)

        nx, ny, nz = so.shape[1], so.shape[2], so.shape[3]
        nlevels = compute_num_levels(nx, ny, nz, self.settings.min_coarse)
        if self.settings.num_levels > 0:
            if self.settings.num_levels > nlevels:
                raise ValueError("too many levels specified")
            nlevels = self.settings.num_levels
        self.nlevels = nlevels
        self.shapes = level_shapes(nx, ny, nz, nlevels)
        self.kinds = [kind] + [StencilKind.twenty_seven_pt] * (nlevels - 1)
        log.debug(f"Using a {nlevels} level hierarchy")

        self.timelog = TimeLog()
        self.timelog.begin("setup")
        self.levels = setup_hierarchy(
            so,
            fine_kind=kind,
            nlevels=nlevels,
            settings=self.settings,
            periodic=self.periodic,
            indefinite=self.indefinite,
        )
        if self.settings.relaxation in (
            RelaxType.plane_xy, RelaxType.plane_xz,
            RelaxType.plane_yz, RelaxType.plane_xyz,
        ):
            from cedar_jax.ops.planes3 import setup_planes

            self.levels = setup_planes(
                self.levels, self.kinds, self.settings, self.conf
            )

        self.timelog.end("setup", force=self.levels)
        self.constraints = None  # distributed solvers set per-level shardings
        self._solve_jit = jax.jit(self._solve_impl)
        self._cycle_jit = jax.jit(self._cycle_impl)

    # -- jitted bodies -------------------------------------------------------
    def _cycle_impl(self, levels, x, b):
        return run_cycle(
            levels, self.kinds, x, b, self.settings, self.periodic,
            self.constraints,
        )

    def _solve_impl(self, levels, b, x0):
        settings = self.settings
        fine = levels[0]
        r0 = residual(fine.so, x0, b, self.kinds[0], self.periodic)
        # floor protects the b = 0 (already-converged) edge case: the rel
        # history divides by res0 (tiny = smallest normal of the dtype)
        res0 = jnp.maximum(_l2(r0), jnp.finfo(b.dtype).tiny)
        maxiter = settings.maxiter
        hist0 = jnp.full((maxiter,), jnp.nan, b.dtype)

        def cond(carry):
            i, x, rel, hist = carry
            return (i < maxiter) & (rel >= settings.tol)

        def body(carry):
            i, x, rel, hist = carry
            x = run_cycle(
                levels, self.kinds, x, b, settings, self.periodic,
                self.constraints,
            )
            r = residual(fine.so, x, b, self.kinds[0], self.periodic)
            rel = _l2(r) / res0
            hist = hist.at[i].set(rel)
            return i + 1, x, rel, hist

        rel0 = jnp.asarray(jnp.inf, b.dtype)
        iters, x, rel, hist = jax.lax.while_loop(
            cond, body, (0, x0, rel0, hist0)
        )
        return x, hist, iters, res0

    # -- public API ----------------------------------------------------------
    def vcycle(self, x, b):
        return self._cycle_jit(self.levels, x, b)

    def solve(self, b, x0=None):
        if x0 is None:
            x0 = jnp.zeros_like(b)
        self.timelog.begin("solve")
        x, hist, iters, res0 = self._solve_jit(self.levels, b, x0)
        iters = int(iters)
        self.timelog.end("solve", force=x)
        hist_host = [float(h) for h in hist[:iters]]
        log.info(f"Initial residual l2 norm: {float(res0):g}")
        for i, rel in enumerate(hist_host):
            log.status(f"Iteration {i} relative l2 norm: {rel:g}")
        self.history = hist_host
        self.res0 = float(res0)
        return x

    def save_timings(self, fname: str = "timings.json"):
        """Write the hierarchical timer report (reference: timings.json)."""
        self.timelog.save(fname)
        if log.enabled("timer"):
            import json as _json

            log.timer(_json.dumps(self.timelog.todict(), indent=2))

    @property
    def coarse_shape(self):
        return self.shapes[-1]
