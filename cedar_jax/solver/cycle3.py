"""3D V- and F-cycles over a static level hierarchy.

3D analogue of :mod:`cedar_jax.solver.cycle2` (reference:
include/cedar/cycle/vcycle.h:44-115, fcycle.h:49-84, relaxation dispatch
multilevel.h:134-223).  Plane relaxation embeds batched 2D cycles
(:mod:`cedar_jax.ops.planes3`): where the reference loops zebra planes
sequentially, each with its own 2D solver (include/cedar/3d/relax_planes.h),
here all planes of one color run as ONE vmapped 2D V-cycle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cedar_jax.ops import cg
from cedar_jax.ops.interp3 import interp_add, restrict
from cedar_jax.ops.relax3 import point_relax
from cedar_jax.settings import MLSettings, RelaxType
from cedar_jax.utils.timing import scope
from cedar_jax.ops.stencil3 import residual


def _smooth(lev, kind, x, b, settings: MLSettings, updown: str, periodic,
            shard=None):
    """One smoothing application (reference: multilevel.h:134-223).

    For plane-xyz relaxation the reference applies xy, yz, xz sweeps on the
    way down and xz, yz, xy on the way up (3d/mpi/solver.h relax_dir
    dispatch).
    """
    rt = settings.relaxation
    if rt == RelaxType.point:
        return point_relax(lev.so, x, b, lev.recip, kind, updown, periodic)
    if rt in (RelaxType.plane_xy, RelaxType.plane_xz, RelaxType.plane_yz,
              RelaxType.plane_xyz):
        from cedar_jax.ops.planes3 import ORIENTS_OF, plane_relax

        orients = ORIENTS_OF[rt]
        if updown == "up":
            orients = tuple(reversed(orients))
        for o in orients:
            x = plane_relax(lev, kind, x, b, o, updown, settings, periodic)
        return x
    raise ValueError(f"invalid 3D relaxation: {rt}")


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
    kinds = [StencilKind.twenty_seven_pt] * len(inner)
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


def ncycle(
    levels,
    kinds,
    lvl: int,
    x: jnp.ndarray,
    b: jnp.ndarray,
    settings: MLSettings,
    periodic=(False, False, False),
    n: int = 1,
    constraints=None,
):
    """Recursive n-cycle (n=1: V, n=2: W).  Reference: vcycle.h:57-115."""
    lev = levels[lvl]
    kind = kinds[lvl]
    shard = constraints[lvl] if constraints is not None else None

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

    # nonsymmetric relaxation keeps the forward sweep order for
    # post-smoothing (reference: IRELAX_SYM, BMG3_SymStd_relax_GS.f90)
    post = "up" if settings.relax_symmetric else "down"
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
    periodic=(False, False, False),
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
