"""2D V- and F-cycles over a static level hierarchy.

Rebuilds the reference's recursive cycle drivers
(include/cedar/cycle/vcycle.h:44-115, include/cedar/cycle/fcycle.h:49-84) as
pure functions: the recursion over levels unrolls at trace time (level count
and shapes are static, matching the reference's precomputed ``nog``), so one
`jit` contains the entire cycle — smoothing, residual, transfer operators and
the coarse direct solve — with no host round-trips.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cedar_jax.core.types import StencilKind
from cedar_jax.ops import cg
from cedar_jax.ops.interp2 import interp_add, restrict
from cedar_jax.ops.relax2 import point_relax
from cedar_jax.ops.lines2 import line_relax_x, line_relax_y
from cedar_jax.ops.stencil2 import residual
from cedar_jax.settings import MLSettings, RelaxType
from cedar_jax.utils.timing import scope


def _use_pallas(settings, kind, shape, dtype, periodic, shard=None):
    """Whether this level's point sweep takes the fused Pallas kernel
    (serial levels only: sharded levels run the XLA sweep, whose shifted
    reads the SPMD partitioner turns into halo exchanges)."""
    if settings.kernel_backend != "pallas" or shard is not None:
        return False
    from cedar_jax.ops import pallas2

    return pallas2.supported(shape, dtype, kind, periodic)


def _pallas_relax(lev, kind, x, b, settings, updown, fuse_residual=False,
                  periodic=(False, False)):
    """Fused Pallas sweep (optionally emitting the residual)."""
    from cedar_jax.ops import pallas2

    return pallas2.point_relax(
        lev.so, x, b, kind, updown, fuse_residual, periodic=periodic,
        interpret=settings.kernel_interpret,
    )


def _smooth(lev, kind, x, b, settings: MLSettings, updown: str, periodic,
            shard=None):
    """Dispatch one smoothing application (reference: multilevel.h:134-223).

    Pre-smoothing (DOWN) applies line-x then line-y for "line-xy";
    post-smoothing (UP) reverses to line-y then line-x (symmetric cycle).
    Under sharding, the line solves run line-axis-local via shard_map
    (one gather per color — the analogue of the reference's interface
    reduction; see ops.lines2._local_solve).
    """
    rt = settings.relaxation
    if rt == RelaxType.point:
        if _use_pallas(settings, kind, x.shape, x.dtype, periodic, shard):
            return _pallas_relax(lev, kind, x, b, settings, updown,
                                 periodic=periodic)
        return point_relax(lev.so, x, b, lev.recip, kind, updown, periodic)

    def lx(x):
        return line_relax_x(lev.so, x, b, lev.sor_x, kind, updown,
                            periodic, shard)

    def ly(x):
        return line_relax_y(lev.so, x, b, lev.sor_y, kind, updown,
                            periodic, shard)

    if rt == RelaxType.line_x:
        return lx(x)
    if rt == RelaxType.line_y:
        return ly(x)
    if rt == RelaxType.line_xy:
        if updown == "down":
            return ly(lx(x))
        return lx(ly(x))
    raise ValueError(f"invalid 2D relaxation: {rt}")


def _nsmooth(lev, kind, x, b, settings, updown, periodic, nrelax,
             shard=None):
    """``nrelax`` identical sweeps as one lax.scan (smaller compiled graph)."""
    if nrelax <= 1:
        for _ in range(nrelax):
            x = _smooth(lev, kind, x, b, settings, updown, periodic, shard)
        return x

    def body(x, _):
        return (
            _smooth(lev, kind, x, b, settings, updown, periodic, shard),
            None,
        )

    x, _ = jax.lax.scan(body, x, None, length=nrelax)
    return x


def _coarse_solve_inner(coarse, cb, settings: MLSettings, periodic):
    """Inner multigrid coarse solve (cg-solver "cedar"/"redist").

    Runs the nested solver's tol/maxiter iteration on the coarsest-grid
    system (reference: redist multilevel_wrapper + setup_cg_solve)."""
    from cedar_jax.core.types import StencilKind

    inner = coarse.inner
    ist = settings.cg_settings
    kinds = [StencilKind.nine_pt] * len(inner)
    r0 = jnp.sqrt(jnp.sum(cb * cb))
    r0 = jnp.maximum(r0, jnp.asarray(1e-300, cb.dtype))

    def cond(carry):
        i, x, rel = carry
        return (i < ist.maxiter) & (rel >= ist.tol)

    def body(carry):
        i, x, _ = carry
        x = run_cycle(inner, kinds, x, cb, ist, periodic)
        r = residual(inner[0].so, x, cb, kinds[0], periodic)
        rel = jnp.sqrt(jnp.sum(r * r)) / r0
        return i + 1, x, rel

    x0 = jnp.zeros_like(cb)
    rel0 = jnp.asarray(jnp.inf, cb.dtype)
    _, x, _ = jax.lax.while_loop(cond, body, (0, x0, rel0))
    return x


def fuse_final_ok(levels, kinds, shape, dtype, settings: MLSettings,
                  periodic, constraints) -> bool:
    """Whether the top level's last post-sweep can fuse the convergence
    residual (Pallas fused sweep with ``fuse_residual``): V-cycle, point
    relaxation with a post-sweep, Pallas-supported fine level."""
    shard = constraints[0] if constraints is not None else None
    return (
        settings.cycle.value == "v"
        and settings.relaxation == RelaxType.point
        and settings.nrelax_post >= 1
        and len(levels) >= 2
        and _use_pallas(settings, kinds[0], shape, dtype, periodic, shard)
    )


def ncycle(
    levels,
    kinds,
    lvl: int,
    x: jnp.ndarray,
    b: jnp.ndarray,
    settings: MLSettings,
    periodic=(False, False),
    n: int = 1,
    constraints=None,
    fuse_final_residual: bool = False,
):
    """Recursive n-cycle (n=1: V, n=2: W).  Reference: vcycle.h:57-115.

    With ``fuse_final_residual`` (top level only; caller checks
    :func:`fuse_final_ok`), the last post-sweep also emits the residual
    in the same HBM pass and the return value is ``(x, res)`` — the solve
    loop's convergence check then costs no extra pass."""
    lev = levels[lvl]
    kind = kinds[lvl]
    shard = constraints[lvl] if constraints is not None else None

    if (
        settings.relaxation == RelaxType.point
        and settings.nrelax_pre >= 1
        and _use_pallas(settings, kind, x.shape, x.dtype, periodic, shard)
    ):
        # fused final pre-smooth + residual: one pass for both
        with scope("relaxation"):
            x = _nsmooth(lev, kind, x, b, settings, "down", periodic,
                         settings.nrelax_pre - 1, shard)
        with scope("relaxation-residual-fused"):
            x, res = _pallas_relax(lev, kind, x, b, settings, "down",
                                   fuse_residual=True, periodic=periodic)
    else:
        with scope("relaxation"):
            x = _nsmooth(lev, kind, x, b, settings, "down", periodic,
                         settings.nrelax_pre, shard)
        with scope("residual"):
            res = residual(lev.so, x, b, kind, periodic)
    coarse = levels[lvl + 1]
    with scope("restrict"):
        cb = restrict(coarse.ci, res, periodic)
    if constraints is not None:
        # agglomeration point: pin the coarse level's (sub)mesh placement
        cb = jax.lax.with_sharding_constraint(cb, constraints[lvl + 1])

    if lvl + 1 == len(levels) - 1:
        with scope("coarse-solve"):
            if coarse.inner is not None:
                cx = _coarse_solve_inner(coarse, cb, settings, periodic)
            else:
                cx = cg.solve_cg(coarse.ainv, cb)
    else:
        cx = jnp.zeros_like(cb)
        for _ in range(n):
            cx = ncycle(levels, kinds, lvl + 1, cx, cb, settings, periodic,
                        n, constraints)

    with scope("interp-add"):
        x = interp_add(coarse.ci, lev.so, cx, res, x, periodic)
    if constraints is not None:
        x = jax.lax.with_sharding_constraint(x, constraints[lvl])

    # nonsymmetric relaxation (solver.relax-symmetric false) keeps the
    # forward sweep order for post-smoothing (reference: IRELAX_SYM
    # branches, BMG2_SymStd_relax_GS.f90:78-87)
    post = "up" if settings.relax_symmetric else "down"
    if fuse_final_residual:
        with scope("relaxation"):
            x = _nsmooth(lev, kind, x, b, settings, post, periodic,
                         settings.nrelax_post - 1, shard)
        with scope("relaxation-residual-fused"):
            return _pallas_relax(lev, kind, x, b, settings, post,
                                 fuse_residual=True, periodic=periodic)
    with scope("relaxation"):
        x = _nsmooth(lev, kind, x, b, settings, post, periodic,
                     settings.nrelax_post, shard)
    return x


def fmg_cycle(
    levels,
    kinds,
    lvl: int,
    b: jnp.ndarray,
    settings: MLSettings,
    periodic=(False, False),
    constraints=None,
):
    """Full multigrid cycle (reference: fcycle.h:49-84).  Returns x."""
    lev = levels[lvl]
    if lvl == len(levels) - 1:
        if lev.inner is not None:
            return _coarse_solve_inner(lev, b, settings, periodic)
        return cg.solve_cg(lev.ainv, b)
    coarse = levels[lvl + 1]
    cb = restrict(coarse.ci, b, periodic)
    if constraints is not None:
        cb = jax.lax.with_sharding_constraint(cb, constraints[lvl + 1])
    cx = fmg_cycle(levels, kinds, lvl + 1, cb, settings, periodic,
                   constraints)
    zero = jnp.zeros_like(b)
    x = interp_add(coarse.ci, lev.so, cx, zero, zero, periodic)
    return ncycle(levels, kinds, lvl, x, b, settings, periodic, 1,
                  constraints)


def run_cycle(levels, kinds, x, b, settings: MLSettings, periodic,
              constraints=None):
    """One cycle of the configured type (reference: multilevel.h:289-296)."""
    if len(levels) == 1:
        return cg.solve_cg(levels[0].ainv, b)
    if settings.cycle.value == "f":
        return fmg_cycle(levels, kinds, 0, b, settings, periodic,
                         constraints)
    return ncycle(levels, kinds, 0, x, b, settings, periodic, 1,
                  constraints)
