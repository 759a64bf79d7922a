"""2D multilevel BoxMG solver.

Rebuilds the reference's `cdr2::solver<fsten>` + `multilevel` driver
(include/cedar/2d/solver.h:21-122, include/cedar/multilevel.h:26-318) as two
jitted pure functions over a static level pytree:

* **setup** — per level: operator-induced interpolation, Galerkin coarse
  operator, relaxation workspace; coarsest: dense inverse
  (multilevel.h:243-265).  One jit, runs entirely on device.
* **solve** — residual-norm-controlled cycle iteration
  (multilevel.h:278-298) as a `lax.while_loop`; the returned history
  reproduces the reference's per-iteration "relative l2 norm" lines.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from cedar_jax.config import Config
from cedar_jax.core.types import StencilKind
from cedar_jax.ops import cg
from cedar_jax.ops.galerkin2 import coarsen_op
from cedar_jax.ops.interp2 import setup_interp
from cedar_jax.ops.lines2 import setup_lines, setup_lines_spike
from cedar_jax.ops.relax2 import setup_recip
from cedar_jax.ops.stencil2 import residual
from cedar_jax import schema
from cedar_jax.settings import (
    CGType, MLSettings, RelaxType, device_platform, resolve_backend,
)
from cedar_jax.solver.cycle2 import run_cycle
from cedar_jax.solver.level import Level
from cedar_jax.utils import log
from cedar_jax.utils.timing import TimeLog


def compute_num_levels(nx: int, ny: int, min_coarse: int) -> int:
    """Halve until below min_coarse (reference: 2d/solver.h:57-73)."""
    ng = 0
    while True:
        ng += 1
        nxc = (nx - 1) // (1 << ng) + 1
        nyc = (ny - 1) // (1 << ng) + 1
        if min(nxc, nyc) < min_coarse:
            return ng


def level_shapes(nx: int, ny: int, nlevels: int) -> list[tuple[int, int]]:
    """Per-level interior shapes, nxc = (nx-1)/2 + 1 (2d/solver.h:75-116)."""
    shapes = [(nx, ny)]
    for _ in range(nlevels - 1):
        nx = (nx - 1) // 2 + 1
        ny = (ny - 1) // 2 + 1
        shapes.append((nx, ny))
    return shapes


def _needs(settings: MLSettings):
    rt = settings.relaxation
    point = rt == RelaxType.point
    lx = rt in (RelaxType.line_x, RelaxType.line_xy)
    ly = rt in (RelaxType.line_y, RelaxType.line_xy)
    return point, lx, ly


# Module-level jitted setup pieces: one compile per (shape, kind) across the
# whole process (see solver3 for rationale).
_setup_interp_j = jax.jit(setup_interp, static_argnames=("kind", "periodic"))
_coarsen_j = jax.jit(coarsen_op, static_argnames=("kind", "periodic"))
_recip_j = jax.jit(setup_recip)
_lines_j = jax.jit(setup_lines, static_argnames=("kind", "axis"))
_lines_spike_j = jax.jit(
    setup_lines_spike, static_argnames=("kind", "axis")
)
_cg_j = jax.jit(
    cg.setup_cg_lu, static_argnames=("kind", "periodic", "indefinite")
)


def _is_multidev(a) -> bool:
    try:
        return len(a.sharding.device_set) > 1
    except Exception:       # tracers (vmapped plane setup) have no
        return False        # committed sharding -> treat as single-device


def setup_level_workspace(so, kind, settings, periodic):
    point, lx, ly = _needs(settings)
    recip = _recip_j(so) if point else None

    def sor(axis, n_line, per_line):
        # long serial lines: cached interface-reduction (SPIKE) factors —
        # one operand pass per solve instead of PCR's log2(n) passes.
        # Distributed levels keep the LDLᵀ array (the line solves run
        # PCR inside shard_map there; see lines2._local_solve).
        # solver.ml-relax.enabled forces the log-depth (PCR) algorithm —
        # the reference's "n-level" line relax (ml_relax.h) analogue.
        if (
            n_line >= 16
            and not per_line
            and not _is_multidev(so)
            and not settings.ml_relax_enabled
        ):
            # threshold 16: sequential Thomas at line length 63 is 126
            # scan steps vs SPIKE's ~17, and the vmapped plane hierarchies
            # hit 63/31-long lines on every embedded level
            return _lines_spike_j(so, kind=kind, axis=axis)
        return _lines_j(so, kind=kind, axis=axis)

    sor_x = sor("x", so.shape[1], periodic[0]) if lx else None
    sor_y = sor("y", so.shape[2], periodic[1]) if ly else None
    return recip, sor_x, sor_y


def setup_hierarchy(
    so_fine: jnp.ndarray,
    fine_kind: StencilKind,
    nlevels: int,
    settings: MLSettings,
    periodic=(False, False),
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
        kind = StencilKind.nine_pt
        sos.append(so)
        kinds.append(kind)
        cis.append(ci)

    levels = []
    for lvl in range(nlevels):
        if lvl < nlevels - 1:
            recip, sor_x, sor_y = setup_level_workspace(
                sos[lvl], kinds[lvl], settings, periodic
            )
            levels.append(
                Level(so=sos[lvl], recip=recip, sor_x=sor_x, sor_y=sor_y,
                      ci=cis[lvl])
            )
        else:
            if settings.coarse_solver != CGType.lu and nlevels > 1:
                # cg-solver "cedar"/"redist": an inner multigrid solver on
                # the coarsest grid, configured by cg-config (reference:
                # setup_cg_solve, 2d/mpi/solver.h:97-139)
                ist = settings.cg_settings
                nx_c, ny_c = sos[lvl].shape[1], sos[lvl].shape[2]
                nl_in = compute_num_levels(nx_c, ny_c, ist.min_coarse)
                if ist.num_levels > 0:
                    nl_in = min(nl_in, ist.num_levels)
                inner = setup_hierarchy(
                    sos[lvl], StencilKind.nine_pt, nl_in, ist,
                    periodic, indefinite,
                )
                levels.append(Level(so=sos[lvl], ci=cis[lvl], inner=inner))
            else:
                # coarsest level: direct solve (no relaxation workspace,
                # reference: multilevel.h:258-263 loops to num_levels-1 only)
                ainv = _cg_j(
                    sos[lvl], kind=kinds[lvl], periodic=periodic,
                    indefinite=indefinite,
                )
                levels.append(Level(so=sos[lvl], ci=cis[lvl], ainv=ainv))
    return tuple(levels)


def _l2(r):
    return jnp.sqrt(jnp.sum(r * r))


class Solver2:
    """2D BoxMG solver over interior-only JAX arrays.

    Parameters
    ----------
    so : (ndir, nx, ny) stencil operator (FivePt: [O,W,S]; NinePt adds SW,NW)
    kind : StencilKind of the fine operator
    conf : Config | dict | None — Cedar-compatible configuration
    """

    def __init__(
        self,
        so: jnp.ndarray,
        kind: StencilKind = StencilKind.five_pt,
        conf: Config | dict | None = None,
    ):
        if not isinstance(conf, Config):
            conf = Config(conf)
        schema.validate(conf)
        self.conf = conf
        self.settings = MLSettings.from_config(conf)
        log.set_enabled(conf.get("log", ["status", "error"]))
        self.kind = kind
        self.settings.kernel_backend = resolve_backend(
            conf.get("kernels.backend", "auto"), device_platform(so)
        )
        per = conf.get("grid.periodic", [False, False])
        self.periodic = (bool(per[0]), bool(per[1]))
        self.indefinite = not conf.get("solver.definite", True)

        nx, ny = so.shape[1], so.shape[2]
        nlevels = compute_num_levels(nx, ny, self.settings.min_coarse)
        if self.settings.num_levels > 0:
            if self.settings.num_levels > nlevels:
                raise ValueError("too many levels specified")
            nlevels = self.settings.num_levels
        self.nlevels = nlevels
        self.shapes = level_shapes(nx, ny, nlevels)
        self.kinds = [kind] + [StencilKind.nine_pt] * (nlevels - 1)
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
        rel0 = jnp.asarray(jnp.inf, b.dtype)

        from cedar_jax.solver import cycle2

        # fuse the convergence residual into the last post-sweep when the
        # Pallas sweep can emit it (one pass over the grid fewer per
        # iteration; same condition set as run_cycle's dispatch)
        fuse_conv = cycle2.fuse_final_ok(
            levels, self.kinds, b.shape, b.dtype, settings, self.periodic,
            self.constraints,
        )

        def cond(carry):
            i, x, rel, hist = carry
            return (i < maxiter) & (rel >= settings.tol)

        def body(carry):
            i, x, rel, hist = carry
            if fuse_conv:
                x, r = cycle2.ncycle(
                    levels, self.kinds, 0, x, b, settings, self.periodic,
                    1, self.constraints, fuse_final_residual=True,
                )
            else:
                x = run_cycle(
                    levels, self.kinds, x, b, settings, self.periodic,
                    self.constraints,
                )
                r = residual(fine.so, x, b, self.kinds[0], self.periodic)
            rel = _l2(r) / res0
            hist = hist.at[i].set(rel)
            return i + 1, x, rel, hist

        iters, x, rel, hist = jax.lax.while_loop(
            cond, body, (0, x0, rel0, hist0)
        )
        return x, hist, iters, res0

    # -- public API ------------------------------------------------------------
    def vcycle(self, x, b):
        """One cycle (reference: multilevel::vcycle)."""
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
