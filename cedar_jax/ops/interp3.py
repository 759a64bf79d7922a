"""3D operator-induced (BoxMG) interpolation: setup, apply, restrict.

Rebuilds the math of BMG3_SymStd_SETUP_interp_OI.f90 (2811 lines of strided
scalar loops) as a handful of dense vectorized passes.  The reference
computes, for each fine-point category, a stencil collapse with an
indefiniteness guard; all categories share one generic structure over the
26-offset row-form coupling table (:mod:`cedar_jax.ops.stencil3`):

* **edge points** (odd in one axis d): collapse onto the d-line.
  ``a``/``b`` = sums of the 9 couplings with offset +1/-1 along d, guard with
  the total coupling sum (reference :127-232, e.g. lxyl/lxyr at :139-160).
* **face points** (odd in two axes): collapse the third axis into 8
  "column" sums, guard with the in-plane sum against ``diag - (out-of-plane
  couplings)``, then combine the column sums with the edge weights of the
  4 surrounding edge points (reference :234-383, e.g. lxynw at :268-280).
* **cell centers** (odd in all axes): weight toward each of the 8 coarse
  corners C = direct coupling + Σ over the 6 other vertices v of the
  fine-cell octant [G, C] of (weight of v toward C)·(coupling G→v), over
  the guarded total-sum denominator (reference :384-536).

Because every coupling enters through the (zero-for-absent-directions)
coupling table, the seven-point branch of the reference (:542-810) falls out
of the same code — its formulas are exactly the 27-point ones with zero
corner/face couplings.

The 7-point/27-point equivalence and the exact formulas are pinned by
tests/oracles3.py (a literal transcription of the Fortran).

Weight storage: 26 CI planes of shape ``(nxc+1, nyc+1, nzc+1)`` — see
:class:`cedar_jax.core.types.InterpDir3` for the plane/δ layout.
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp

from cedar_jax.core.parity import (
    deinterleave3,
    interleave3,
    subgrid_sample_nd,
)
from cedar_jax.core.shift import coarse_sample, shift3
from cedar_jax.core.types import Dir3, InterpDir3 as L, StencilKind
from cedar_jax.ops.stencil3 import NEIGHBOR_COUPLINGS_27, coupling, offsets_for


def _zeps(dtype) -> float:
    return float(jnp.finfo(dtype).eps)


def _gate(d, zeps):
    return jnp.maximum(d, 0.0) / (jnp.abs(d) + zeps)


# CI plane -> fine->coarse displacement δ (see InterpDir3 docstring).
DELTA = {
    L.XYL: (-1, 0, 0), L.XYR: (1, 0, 0),
    L.XYA: (0, 1, 0), L.XYB: (0, -1, 0),
    L.XZA: (0, 0, 1), L.XZB: (0, 0, -1),
    L.XYNE: (1, 1, 0), L.XYSE: (1, -1, 0),
    L.XYSW: (-1, -1, 0), L.XYNW: (-1, 1, 0),
    L.XZSW: (-1, 0, -1), L.XZNW: (-1, 0, 1),
    L.XZNE: (1, 0, 1), L.XZSE: (1, 0, -1),
    L.YZSW: (0, 1, -1), L.YZNW: (0, 1, 1),
    L.YZNE: (0, -1, 1), L.YZSE: (0, -1, -1),
    L.BSW: (-1, -1, -1), L.BNW: (-1, 1, -1),
    L.BNE: (1, 1, -1), L.BSE: (1, -1, -1),
    L.TSW: (-1, -1, 1), L.TNW: (-1, 1, 1),
    L.TNE: (1, 1, 1), L.TSE: (1, -1, 1),
}

# Per-coarse-point interpolation footprint: fine offset -> (plane, CI shift).
# off = -δ, shift = max(off, 0) per axis (verified against
# BMG3_SymStd_restrict.f90:115-145).
PW3_TABLE = {
    tuple(-d for d in delta): (
        plane,
        tuple(max(-d, 0) for d in delta),
    )
    for plane, delta in DELTA.items()
}


def setup_interp(
    so: jnp.ndarray, kind: StencilKind, periodic=(False, False, False)
) -> jnp.ndarray:
    """Build the 26-plane CI interpolation weights from the fine stencil."""
    P = so[Dir3.P]
    zeps = _zeps(so.dtype)
    nx, ny, nz = so.shape[1], so.shape[2], so.shape[3]
    nxc = (nx - 1) // 2 + 1
    nyc = (ny - 1) // 2 + 1
    nzc = (nz - 1) // 2 + 1
    kx, my, lz = nx // 2, ny // 2, nz // 2

    present = set(offsets_for(kind))
    cpl = {
        off: (coupling(so, off, periodic) if off in present else None)
        for off in NEIGHBOR_COUPLINGS_27
    }

    def csum(offs):
        acc = None
        for off in offs:
            c = cpl[off]
            if c is None:
                continue
            acc = c if acc is None else acc + c
        return jnp.zeros_like(P) if acc is None else acc

    def sh(arr, d0, d1, d2):
        return shift3(arr, d0, d1, d2, periodic)

    all_offs = list(NEIGHBOR_COUPLINGS_27.keys())

    # -- edge points: collapse onto the line through the two coarse
    #    neighbors (reference :127-232) ------------------------------------
    def edge(axis):
        a = csum([o for o in all_offs if o[axis] == -1])  # toward lower
        b = csum([o for o in all_offs if o[axis] == 1])   # toward upper
        lat = csum([o for o in all_offs if o[axis] == 0])
        ctot = a + b + lat
        ep = jnp.minimum(jnp.abs(a / P), jnp.abs(b / P))
        den = a + b + (P - ctot) * _gate(P - (1.0 + ep) * ctot, zeps)
        return a / den, b / den  # (weight to lower, weight to upper)

    xyl_d, xyr_d = edge(0)
    xyb_d, xya_d = edge(1)
    xzb_d, xza_d = edge(2)

    # -- face points: collapse the out-of-plane axis into 8 column sums,
    #    combine with surrounding edge weights (reference :234-383) --------
    def face(ax1, ax2, axc):
        """Column sums d[(e1, e2)], guarded inverse denominator s."""
        d = {}
        for e1 in (-1, 0, 1):
            for e2 in (-1, 0, 1):
                if e1 == 0 and e2 == 0:
                    continue
                offs = []
                for e3 in (-1, 0, 1):
                    o = [0, 0, 0]
                    o[ax1], o[ax2], o[axc] = e1, e2, e3
                    offs.append(tuple(o))
                d[(e1, e2)] = csum(offs)
        dp = sum(d.values())
        sides = [
            d[(-1, -1)] + d[(-1, 0)] + d[(-1, 1)],
            d[(-1, 1)] + d[(0, 1)] + d[(1, 1)],
            d[(1, 1)] + d[(1, 0)] + d[(1, -1)],
            d[(1, -1)] + d[(0, -1)] + d[(-1, -1)],
        ]
        ep = None
        for s_ in sides:
            e = jnp.abs(s_ / P)
            ep = e if ep is None else jnp.minimum(ep, e)
        oc = [0, 0, 0]
        oc[axc] = 1
        out_lo = cpl[tuple(-c for c in oc)]
        out_hi = cpl[tuple(oc)]
        sumv = P
        if out_lo is not None:
            sumv = sumv - out_lo
        if out_hi is not None:
            sumv = sumv - out_hi
        den = dp + (sumv - dp) * _gate(sumv - (1.0 + ep) * dp, zeps)
        return d, 1.0 / den

    # xy faces (collapse z; reference :234-283)
    d, s = face(0, 1, 2)
    xynw_d = s * (d[(-1, 1)] + sh(xya_d, -1, 0, 0) * d[(-1, 0)]
                  + sh(xyl_d, 0, 1, 0) * d[(0, 1)])
    xyne_d = s * (d[(1, 1)] + sh(xyr_d, 0, 1, 0) * d[(0, 1)]
                  + sh(xya_d, 1, 0, 0) * d[(1, 0)])
    xyse_d = s * (d[(1, -1)] + sh(xyb_d, 1, 0, 0) * d[(1, 0)]
                  + sh(xyr_d, 0, -1, 0) * d[(0, -1)])
    xysw_d = s * (d[(-1, -1)] + sh(xyl_d, 0, -1, 0) * d[(0, -1)]
                  + sh(xyb_d, -1, 0, 0) * d[(-1, 0)])

    # xz faces (collapse y; reference :285-332; "north" = +z)
    d, s = face(0, 2, 1)
    xznw_d = s * (d[(-1, 1)] + sh(xza_d, -1, 0, 0) * d[(-1, 0)]
                  + sh(xyl_d, 0, 0, 1) * d[(0, 1)])
    xzne_d = s * (d[(1, 1)] + sh(xyr_d, 0, 0, 1) * d[(0, 1)]
                  + sh(xza_d, 1, 0, 0) * d[(1, 0)])
    xzse_d = s * (d[(1, -1)] + sh(xzb_d, 1, 0, 0) * d[(1, 0)]
                  + sh(xyr_d, 0, 0, -1) * d[(0, -1)])
    xzsw_d = s * (d[(-1, -1)] + sh(xyl_d, 0, 0, -1) * d[(0, -1)]
                  + sh(xzb_d, -1, 0, 0) * d[(-1, 0)])

    # yz faces (collapse x; reference :334-382; "west" = +y, "north" = +z)
    d, s = face(1, 2, 0)
    yznw_d = s * (d[(1, 1)] + sh(xza_d, 0, 1, 0) * d[(1, 0)]
                  + sh(xya_d, 0, 0, 1) * d[(0, 1)])
    yzne_d = s * (d[(-1, 1)] + sh(xyb_d, 0, 0, 1) * d[(0, 1)]
                  + sh(xza_d, 0, -1, 0) * d[(-1, 0)])
    yzse_d = s * (d[(-1, -1)] + sh(xzb_d, 0, -1, 0) * d[(-1, 0)]
                  + sh(xyb_d, 0, 0, -1) * d[(0, -1)])
    yzsw_d = s * (d[(1, -1)] + sh(xya_d, 0, 0, -1) * d[(0, -1)]
                  + sh(xzb_d, 0, 1, 0) * d[(1, 0)])

    # -- cell centers (reference :384-536) ---------------------------------
    total = csum(all_offs)
    ep = None
    for axis in range(3):
        for sgn in (-1, 1):
            fsum = csum([o for o in all_offs if o[axis] == sgn])
            e = jnp.abs(fsum / P)
            ep = e if ep is None else jnp.minimum(ep, e)
    den = total + (P - total) * _gate(P - (1.0 + ep) * total, zeps)
    s = 1.0 / den

    fine_wt = {
        # category (by which δ components are nonzero) -> weight array by δ
        (1, 0, 0): {(-1, 0, 0): xyl_d, (1, 0, 0): xyr_d},
        (0, 1, 0): {(0, 1, 0): xya_d, (0, -1, 0): xyb_d},
        (0, 0, 1): {(0, 0, 1): xza_d, (0, 0, -1): xzb_d},
        (1, 1, 0): {(1, 1, 0): xyne_d, (1, -1, 0): xyse_d,
                    (-1, -1, 0): xysw_d, (-1, 1, 0): xynw_d},
        (1, 0, 1): {(-1, 0, -1): xzsw_d, (-1, 0, 1): xznw_d,
                    (1, 0, 1): xzne_d, (1, 0, -1): xzse_d},
        (0, 1, 1): {(0, 1, -1): yzsw_d, (0, 1, 1): yznw_d,
                    (0, -1, 1): yzne_d, (0, -1, -1): yzse_d},
    }

    def corner(delta):
        """Weight of cell-center G toward the coarse corner at G + δ."""
        acc = cpl[delta]
        acc = jnp.zeros_like(P) if acc is None else acc
        # the 6 other vertices v = G + m⊙δ of the octant [G, G+δ]
        for m in itertools.product((0, 1), repeat=3):
            if m == (0, 0, 0) or m == (1, 1, 1):
                continue
            voff = tuple(mi * di for mi, di in zip(m, delta))
            c = cpl[voff]
            if c is None:
                continue
            vdelta = tuple((1 - mi) * di for mi, di in zip(m, delta))
            cat = tuple(1 if x else 0 for x in vdelta)
            w = fine_wt[cat][vdelta]
            acc = acc + sh(w, *voff) * c
        return s * acc

    cc = {delta: corner(delta)
          for delta in itertools.product((-1, 1), repeat=3)}

    # -- harvest the valid parities into CI ---------------------------------
    parts_of = {}

    def deint(arr):
        key = id(arr)
        if key not in parts_of:
            parts_of[key] = deinterleave3(arr)
        return parts_of[key]

    ci = jnp.zeros((26, nxc + 1, nyc + 1, nzc + 1), so.dtype)
    windows = {
        (1, 0, 0): (slice(1, 1 + kx), slice(0, nyc), slice(0, nzc)),
        (0, 1, 0): (slice(0, nxc), slice(1, 1 + my), slice(0, nzc)),
        (0, 0, 1): (slice(0, nxc), slice(0, nyc), slice(1, 1 + lz)),
        (1, 1, 0): (slice(1, 1 + kx), slice(1, 1 + my), slice(0, nzc)),
        (1, 0, 1): (slice(1, 1 + kx), slice(0, nyc), slice(1, 1 + lz)),
        (0, 1, 1): (slice(0, nxc), slice(1, 1 + my), slice(1, 1 + lz)),
        (1, 1, 1): (slice(1, 1 + kx), slice(1, 1 + my), slice(1, 1 + lz)),
    }
    for cat, table in fine_wt.items():
        win = windows[cat]
        for delta, arr in table.items():
            plane = _PLANE_OF[delta]
            ci = ci.at[(plane,) + win].set(deint(arr)[cat])
    win = windows[(1, 1, 1)]
    for delta, arr in cc.items():
        plane = _PLANE_OF[delta]
        ci = ci.at[(plane,) + win].set(deint(arr)[(1, 1, 1)])

    # periodic wrap: fine point -1 ≡ n-1, so index 0 of planes stored at
    # odd parity along a periodic axis mirrors the high entry (requires
    # even extents along periodic axes)
    his = (kx, my, lz)
    for plane, delta in DELTA.items():
        cat = tuple(1 if d else 0 for d in delta)
        for ax in range(3):
            if periodic[ax] and cat[ax]:
                idx_lo = [slice(None)] * 3
                idx_hi = [slice(None)] * 3
                idx_lo[ax] = 0
                idx_hi[ax] = his[ax]
                ci = ci.at[(plane,) + tuple(idx_lo)].set(
                    ci[(plane,) + tuple(idx_hi)]
                )
    return ci


_PLANE_OF = {delta: plane for plane, delta in DELTA.items()}


def pw_weights(ci: jnp.ndarray):
    """Per-coarse-point interpolation footprint.

    Returns dict ``(du, dv, dw) -> (nxc, nyc, nzc)`` array: the weight from
    coarse point c to fine point 2c + off (coincident weight 1).
    """
    nxc, nyc, nzc = ci.shape[1] - 1, ci.shape[2] - 1, ci.shape[3] - 1
    out = {(0, 0, 0): jnp.ones((nxc, nyc, nzc), ci.dtype)}
    for off, (plane, sht) in PW3_TABLE.items():
        out[off] = ci[
            plane,
            sht[0] : sht[0] + nxc,
            sht[1] : sht[1] + nyc,
            sht[2] : sht[2] + nzc,
        ]
    return out


def parity_sample(parts: dict, off, nc):
    """``q[2c + off]`` on the coarse grid, from fine parity subgrids."""
    p = tuple(o % 2 for o in off)
    sht = tuple((o - pi) // 2 for o, pi in zip(off, p))
    return subgrid_sample_nd(parts[p], sht, nc)


def restrict(
    ci: jnp.ndarray, q: jnp.ndarray, periodic=(False, False, False)
) -> jnp.ndarray:
    """``qc = Pᵀ q`` (reference: BMG3_SymStd_restrict.f90:115-145)."""
    nc = (ci.shape[1] - 1, ci.shape[2] - 1, ci.shape[3] - 1)
    pw = pw_weights(ci)
    if any(periodic):
        qc = coarse_sample(q, (0, 0, 0), nc, periodic)
        for off, wgt in pw.items():
            if off != (0, 0, 0):
                qc = qc + wgt * coarse_sample(q, off, nc, periodic)
        return qc
    parts = deinterleave3(q)
    qc = parity_sample(parts, (0, 0, 0), nc)
    for off, wgt in pw.items():
        if off == (0, 0, 0):
            continue
        qc = qc + wgt * parity_sample(parts, off, nc)
    return qc


def interp_add(
    ci: jnp.ndarray,
    so: jnp.ndarray,
    qc: jnp.ndarray,
    res: jnp.ndarray,
    q: jnp.ndarray,
    periodic=(False, False, False),
) -> jnp.ndarray:
    """``q += P qc (+ res/diag at fine-only points)``.

    Reference: BMG3_SymStd_interp_add.f90:88-242 (RES is divided by the fine
    diagonal at :91 and added at every fine-only point).
    """
    nx, ny, nz = q.shape
    nxc, nyc, nzc = qc.shape
    kx, my, lz = nx // 2, ny // 2, nz // 2
    r2p = deinterleave3(res / so[Dir3.P])
    qcp = jnp.pad(qc, ((0, 1), (0, 1), (0, 1)))
    for ax, (per, n_c) in enumerate(zip(periodic, (nxc, nyc, nzc))):
        if per:
            idx_hi = [slice(None)] * 3
            idx_lo = [slice(None)] * 3
            idx_hi[ax] = n_c
            idx_lo[ax] = 0
            qcp = qcp.at[tuple(idx_hi)].set(qcp[tuple(idx_lo)])

    lo = {0: (slice(0, kx), slice(0, my), slice(0, lz))}
    # coarse-solution slices per axis: index 0 = toward lower coarse point,
    # 1 = toward upper
    csl = {
        0: {-1: slice(0, kx), 1: slice(1, 1 + kx), 0: slice(0, nxc)},
        1: {-1: slice(0, my), 1: slice(1, 1 + my), 0: slice(0, nyc)},
        2: {-1: slice(0, lz), 1: slice(1, 1 + lz), 0: slice(0, nzc)},
    }
    wsl = {
        0: {1: slice(1, 1 + kx), 0: slice(0, nxc)},
        1: {1: slice(1, 1 + my), 0: slice(0, nyc)},
        2: {1: slice(1, 1 + lz), 0: slice(0, nzc)},
    }

    parts = {(0, 0, 0): qc}
    for cat in [
        (1, 0, 0), (0, 1, 0), (0, 0, 1),
        (1, 1, 0), (1, 0, 1), (0, 1, 1), (1, 1, 1),
    ]:
        wwin = tuple(wsl[ax][cat[ax]] for ax in range(3))
        acc = r2p[cat]
        for plane, delta in DELTA.items():
            if tuple(1 if d else 0 for d in delta) != cat:
                continue
            w = ci[(plane,) + wwin]
            qsl = tuple(csl[ax][delta[ax]] for ax in range(3))
            acc = acc + w * qcp[qsl]
        parts[cat] = acc

    return q + interleave3(parts, nx, ny, nz)
