"""Generic 3D Galerkin (variational) coarse-operator product A_c = Pᵀ A P.

The reference hand-expands this triple product into 1117 lines (7-point fine,
BMG3_SymStd_SETUP_ITLI07_ex.f90) / 2047 lines (27-point,
BMG3_SymStd_SETUP_ITLI27_ex.f90) of stencil algebra.  Here it is the same
two-stage shifted-window contraction as 2D (:mod:`cedar_jax.ops.galerkin2`),
over the 27-offset row-form table and the 27-point interpolation footprint:

1. ``AP[(p,q,r)](c) = Σ_off A_full[2c+(p,q,r), off-(p,q,r)] · PW[off](c)``
2. ``A_c[(di,dj,dk)](c) = Σ_(p,q,r) PW[(p,q,r)-2(di,dj,dk)](c+(di,dj,dk))
   · AP[(p,q,r)](c)``

R = Pᵀ exactly (include/cedar/3d/restrict_op.h), so this equals the
reference's ITLI to roundoff; validated against a scipy-sparse PᵀAP oracle
in tests/test_kernels_3d.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cedar_jax.core.parity import deinterleave3
from cedar_jax.core.shift import coarse_sample, shift3
from cedar_jax.core.types import StencilKind
from cedar_jax.ops.interp3 import parity_sample, pw_weights
from cedar_jax.ops.stencil3 import NEIGHBOR_COUPLINGS_27, full_offsets


def coarsen_op(
    ci: jnp.ndarray,
    so: jnp.ndarray,
    kind: StencilKind,
    periodic=(False, False, False),
) -> jnp.ndarray:
    """Galerkin coarse stencil (always 27-point) from fine stencil + CI.

    Non-periodic grids use the mod-3 comb-basis extraction
    (:func:`coarsen_op_comb`, far cheaper to compile); periodic grids fall
    back to the explicit two-stage product (mod-3 combs misalign under
    wrap-around unless the grid size divides by 3).
    """
    if any(periodic):
        return coarsen_op_explicit(ci, so, kind, periodic)
    return coarsen_op_comb(ci, so, kind)


def coarsen_op_comb(
    ci: jnp.ndarray, so: jnp.ndarray, kind: StencilKind
) -> jnp.ndarray:
    """A_c by comb-basis probing: the 27 coarse-stencil offsets are distinct
    mod 3, so applying Pᵀ A P to the 27 mod-3 indicator combs e_j recovers
    every row entry exactly: (Pᵀ A P e_j)(c) = A_c[δ](c) for the unique
    δ ≡ j − c (mod 3).  One vmapped interp→matvec→restrict evaluates all
    combs; entries outside the grid come out exactly zero (no real coarse
    point of that class lies in the row's support).

    This computes the same triple product the reference hand-expands over
    1117/2047 Fortran lines (BMG3_SymStd_SETUP_ITLI{07,27}_ex.f90), with a
    compile-time graph the size of one cycle stage.
    """
    from cedar_jax.ops.interp3 import interp_add, restrict
    from cedar_jax.ops.stencil3 import matvec

    nc = (ci.shape[1] - 1, ci.shape[2] - 1, ci.shape[3] - 1)
    nf = (so.shape[1], so.shape[2], so.shape[3])
    dtype = so.dtype

    # 27 mod-3 comb indicator fields on the coarse grid, built in-graph
    # (a host-side constant would bake O(27 * coarse grid) bytes into the
    # HLO — too large to ship at bench sizes)
    iz = jax.lax.broadcasted_iota(jnp.int32, nc, 0) % 3
    iw = jax.lax.broadcasted_iota(jnp.int32, nc, 1) % 3
    iv = jax.lax.broadcasted_iota(jnp.int32, nc, 2) % 3
    cls = iz * 9 + iw * 3 + iv
    combs = (jnp.arange(27, dtype=jnp.int32)[:, None, None, None]
             == cls[None]).astype(dtype)

    zf = jnp.zeros(nf, dtype)

    def probe(qc):
        xf = interp_add(ci, so, qc, zf, zf)
        return restrict(ci, matvec(so, xf, kind))

    # sequential map over probes: vmap would hold 27 fine-grid probe
    # intermediates live at once (OOM at bench sizes); setup is not
    # latency-critical
    results = jax.lax.map(probe, combs)  # (27, *nc)

    def entry(delta):
        j = (
            (iz + delta[0]) % 3 * 9
            + (iw + delta[1]) % 3 * 3
            + (iv + delta[2]) % 3
        )
        return jnp.take_along_axis(results, j[None], axis=0)[0]

    # assemble the 14 stored planes (see coarsen_op_explicit for the
    # canonical-offset derivation)
    canonical = _canonical_planes()
    planes = [entry((0, 0, 0))]
    for plane in range(1, 14):
        off, sht = canonical[plane]
        ent = -entry(off)
        if any(sht):
            ent = shift3(ent, -sht[0], -sht[1], -sht[2])
        planes.append(ent)
    return jnp.stack(planes)


def _canonical_planes():
    canonical = {}
    for off, (plane, sht) in NEIGHBOR_COUPLINGS_27.items():
        if plane not in canonical or sum(sht) < sum(canonical[plane][1]):
            canonical[plane] = (off, sht)
    return canonical


def coarsen_op_explicit(
    ci: jnp.ndarray,
    so: jnp.ndarray,
    kind: StencilKind,
    periodic=(False, False, False),
) -> jnp.ndarray:
    """Explicit two-stage shifted-window product (any boundary conditions)."""
    nc = (ci.shape[1] - 1, ci.shape[2] - 1, ci.shape[3] - 1)

    af = full_offsets(so, kind, periodic)  # off -> fine array (true sign)
    pw = pw_weights(ci)                    # off -> coarse array

    if any(periodic):
        def fs(off, pqr):
            return coarse_sample(af[off], pqr, nc, periodic)
    else:
        afd = {off: deinterleave3(field) for off, field in af.items()}

        def fs(off, pqr):
            return parity_sample(afd[off], pqr, nc)

    # -- stage 1: AP patches over the 5×5×5 fine neighborhood ----------------
    ap = {}
    for p in range(-2, 3):
        for q in range(-2, 3):
            for r in range(-2, 3):
                acc = None
                for (du, dv, dw), w in pw.items():
                    off = (du - p, dv - q, dw - r)
                    if off not in af:
                        continue
                    term = fs(off, (p, q, r)) * w
                    acc = term if acc is None else acc + term
                if acc is not None:
                    ap[(p, q, r)] = acc

    # -- stage 2: coarse row-form entries -------------------------------------
    def ac_entry(di, dj, dk):
        acc = None
        for (p, q, r), patch in ap.items():
            woff = (p - 2 * di, q - 2 * dj, r - 2 * dk)
            if woff not in pw:
                continue
            term = shift3(pw[woff], di, dj, dk, periodic) * patch
            acc = term if acc is None else acc + term
        return acc

    # -- store in the reference's 14-plane symmetric convention ---------------
    # For each stored plane, the canonical row-form offset is the table entry
    # with zero shift when present; otherwise un-shift (see
    # cedar_jax.ops.stencil3.NEIGHBOR_COUPLINGS_27).
    canonical = _canonical_planes()

    planes = [ac_entry(0, 0, 0)]
    for plane in range(1, 14):
        off, sht = canonical[plane]
        ent = -ac_entry(*off)
        if any(sht):
            ent = shift3(ent, -sht[0], -sht[1], -sht[2], periodic)
        planes.append(ent)
    return jnp.stack(planes)
