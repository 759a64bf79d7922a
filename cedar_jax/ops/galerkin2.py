"""Generic Galerkin (variational) coarse-operator product: A_c = Pᵀ A P.

The reference hand-expands this triple product into ~400 lines of stencil
algebra for 2D (BMG2_SymStd_SETUP_ITLI_ex.f90) and 1100/2000 lines for 3D
(BMG3_SymStd_SETUP_ITLI07/27_ex.f90).  Here it is computed *generically* as
two small shifted-window contractions, valid for any stencil width and any
dimension:

1. ``AP[(p,q)](zc,wc) = Σ_(du,dv) A_full[2zc+p, 2wc+q, (du-p, dv-q)] ·
   PW[(du,dv)](zc,wc)`` — the 5×5 fine-grid patch of A·P columns around each
   coarse point (PW = per-coarse-point interpolation footprint, coincident
   weight 1).
2. ``A_c[(di,dj)](zc,wc) = Σ_(p,q) PW[(p-2di, q-2dj)](zc+di, wc+dj) ·
   AP[(p,q)](zc,wc)``.

This is the same sum the reference computes term-by-term (R = Pᵀ exactly,
include/cedar/2d/restrict_op.h:13-27), so the result agrees to roundoff; the
static Python loops unroll to ~170 fused multiply-adds over the coarse grid,
which XLA fuses into a handful of elementwise passes.
"""

from __future__ import annotations

import jax.numpy as jnp

from cedar_jax.core.parity import deinterleave2
from cedar_jax.core.shift import coarse_sample, shift2
from cedar_jax.core.types import StencilKind
from cedar_jax.ops.interp2 import parity_sample, pw_weights
from cedar_jax.ops.stencil2 import full_offsets


def coarsen_op(
    ci: jnp.ndarray,
    so: jnp.ndarray,
    kind: StencilKind,
    periodic=(False, False),
) -> jnp.ndarray:
    """Galerkin coarse stencil (always nine_pt) from fine stencil + CI.

    Non-periodic grids use mod-3 comb-basis extraction (cheap to compile,
    see :func:`coarsen_op_comb`); periodic grids use the explicit product.
    """
    if any(periodic):
        return coarsen_op_explicit(ci, so, kind, periodic)
    return coarsen_op_comb(ci, so, kind)


def coarsen_op_comb(
    ci: jnp.ndarray, so: jnp.ndarray, kind: StencilKind
) -> jnp.ndarray:
    """A_c = Pᵀ A P by comb-basis probing: the 9 coarse-stencil offsets are
    distinct mod 3, so applying Pᵀ A P to the 9 mod-3 indicator combs
    recovers every row entry exactly (see galerkin3.coarsen_op_comb)."""
    import jax

    from cedar_jax.ops.interp2 import interp_add, restrict
    from cedar_jax.ops.stencil2 import matvec

    nc = (ci.shape[1] - 1, ci.shape[2] - 1)
    nf = (so.shape[1], so.shape[2])
    dtype = so.dtype

    # comb indicators built in-graph (host constants would bloat the HLO)
    iz = jax.lax.broadcasted_iota(jnp.int32, nc, 0) % 3
    iw = jax.lax.broadcasted_iota(jnp.int32, nc, 1) % 3
    cls = iz * 3 + iw
    combs = (jnp.arange(9, dtype=jnp.int32)[:, None, None]
             == cls[None]).astype(dtype)

    zf = jnp.zeros(nf, dtype)

    def probe(qc):
        xf = interp_add(ci, so, qc, zf, zf)
        return restrict(ci, matvec(so, xf, kind))

    # sequential map over probes: vmap would hold 9 fine-grid probe
    # intermediates live at once (OOM at bench sizes); setup is not
    # latency-critical
    results = jax.lax.map(probe, combs)  # (9, *nc)

    def entry(di, dj):
        j = (iz + di) % 3 * 3 + (iw + dj) % 3
        return jnp.take_along_axis(results, j[None], axis=0)[0]

    o = entry(0, 0)
    w_ = -entry(-1, 0)
    s_ = -entry(0, -1)
    sw = -entry(-1, -1)
    nw = -shift2(entry(-1, 1), 0, -1)
    return jnp.stack([o, w_, s_, sw, nw])


def coarsen_op_explicit(
    ci: jnp.ndarray,
    so: jnp.ndarray,
    kind: StencilKind,
    periodic=(False, False),
) -> jnp.ndarray:
    """Explicit two-stage shifted-window product (any boundary conditions)."""
    nxc = ci.shape[1] - 1
    nyc = ci.shape[2] - 1
    nc = (nxc, nyc)

    af = full_offsets(so, kind, periodic)   # (dz,dw) -> fine array (true sign)
    pw = pw_weights(ci)                      # (du,dv) -> coarse array

    if any(periodic):
        def fs(off, p, q):
            return coarse_sample(af[off], (p, q), nc, periodic)
    else:
        afd = {off: deinterleave2(field) for off, field in af.items()}

        def fs(off, p, q):
            return parity_sample(afd[off], p, q, nc)

    # -- stage 1: AP patches -------------------------------------------------
    ap = {}
    for p in range(-2, 3):
        for q in range(-2, 3):
            acc = None
            for (du, dv), w in pw.items():
                off = (du - p, dv - q)
                if off not in af:
                    continue
                term = fs(off, p, q) * w
                acc = term if acc is None else acc + term
            if acc is not None:
                ap[(p, q)] = acc

    # -- stage 2: coarse row-form entries ------------------------------------
    def ac_entry(di, dj):
        acc = None
        for (p, q), patch in ap.items():
            woff = (p - 2 * di, q - 2 * dj)
            if woff not in pw:
                continue
            term = shift2(pw[woff], di, dj, periodic) * patch
            acc = term if acc is None else acc + term
        return acc

    o = ac_entry(0, 0)
    w_ = -ac_entry(-1, 0)
    s_ = -ac_entry(0, -1)
    sw = -ac_entry(-1, -1)
    # stored NW(a,b) couples (a,b-1) <-> (a-1,b): row-form (-1,+1) at (a,b-1)
    nw = -shift2(ac_entry(-1, 1), 0, -1, periodic)
    return jnp.stack([o, w_, s_, sw, nw])
