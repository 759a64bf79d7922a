"""2D operator-induced (BoxMG) interpolation: setup, apply, restrict.

Rebuilds the math of the reference's Fortran kernels as dense vectorized
array expressions:

* :func:`setup_interp` — BMG2_SymStd_SETUP_interp_OI.f90:105-256.  The
  stencil-collapse weights (with the indefiniteness guard
  ``SUM + (c-SUM)·max(c-(1+EP)SUM,0)/(|c-(1+EP)SUM|+ZEPS)``) are computed at
  EVERY fine point in one vectorized pass and then gathered onto the coarse
  grid with strided slices instead of the reference's strided scalar loops;
  the arithmetic per valid point is identical.
* :func:`restrict` — BMG2_SymStd_restrict.f90:76-92 (R = Pᵀ, the variational
  transpose with coincident weight 1).
* :func:`interp_add` — BMG2_SymStd_interp_add.f90:101-137, including the
  diagonally-scaled residual correction the reference adds at fine-only
  points (``Q += P·Qc`` at coincident points, ``Q += P·Qc + res/diag``
  elsewhere).

Weight storage: CI planes of shape ``(nxc+1, nyc+1)`` — see
:class:`cedar_jax.core.types.InterpDir2` for the exact layout.
"""

from __future__ import annotations

import jax.numpy as jnp

from cedar_jax.core.parity import deinterleave2, interleave2, subgrid_sample
from cedar_jax.core.shift import coarse_sample, shift2
from cedar_jax.core.types import Dir2, InterpDir2 as L, StencilKind


def _zeps(dtype) -> float:
    return float(jnp.finfo(dtype).eps)


def _guarded_den(c, a, b, sum0, extra, zeps):
    """The BoxMG indefiniteness-guarded collapse denominator.

    ``a``/``b`` are the two collapsed coupling sums, ``sum0`` the total
    off-diagonal sum, ``extra`` the additional terms entering EP's min.
    Returns ``A + B + (c - SUM)·gate`` with gate ∈ {0, ~1} (reference:
    SETUP_interp_OI.f90:116-126).
    """
    ep = jnp.minimum(jnp.abs(a / c), jnp.abs(b / c))
    for e in extra:
        ep = jnp.minimum(ep, jnp.abs(e / c))
    d = c - (1.0 + ep) * sum0
    gate = jnp.maximum(d, 0.0) / (jnp.abs(d) + zeps)
    return a + b + (c - sum0) * gate


def _guarded_den_corner(c, sum0, groups, zeps):
    """Corner variant: ``SUM + (c-SUM)·gate``, EP over the 4 group sums."""
    ep = None
    for g in groups:
        e = jnp.abs(g / c)
        ep = e if ep is None else jnp.minimum(ep, e)
    d = c - (1.0 + ep) * sum0
    gate = jnp.maximum(d, 0.0) / (jnp.abs(d) + zeps)
    return sum0 + (c - sum0) * gate


def setup_interp(
    so: jnp.ndarray, kind: StencilKind, periodic=(False, False)
) -> jnp.ndarray:
    """Build the 8-plane CI interpolation weights from the fine stencil."""
    O, W, S = so[Dir2.O], so[Dir2.W], so[Dir2.S]
    nine = kind != StencilKind.five_pt
    if nine:
        SW, NW = so[Dir2.SW], so[Dir2.NW]
    zeps = _zeps(so.dtype)
    per = periodic

    def sh(p, dz, dw):
        return shift2(p, dz, dw, per)

    nx, ny = so.shape[1], so.shape[2]
    nxc = (nx - 1) // 2 + 1
    nyc = (ny - 1) // 2 + 1

    # --- x-line fine points (z odd, w even): collapse E/W ------------------
    if nine:
        a_x = sh(W, 1, 0) + sh(NW, 1, 0) + sh(SW, 1, 1)  # east couplings
        b_x = W + SW + sh(NW, 0, 1)                      # west couplings
    else:
        a_x = sh(W, 1, 0)
        b_x = W
    sum_x = a_x + b_x + S + sh(S, 0, 1)
    den_x = _guarded_den(O, a_x, b_x, sum_x, (), zeps)
    lr_d = a_x / den_x
    ll_d = b_x / den_x

    # --- y-line fine points (z even, w odd): collapse N/S ------------------
    if nine:
        a_y = sh(S, 0, 1) + sh(NW, 0, 1) + sh(SW, 1, 1)  # north couplings
        b_y = S + SW + sh(NW, 1, 0)                      # south couplings
    else:
        a_y = sh(S, 0, 1)
        b_y = S
    sum_y = a_y + b_y + W + sh(W, 1, 0)
    den_y = _guarded_den(O, a_y, b_y, sum_y, (), zeps)
    la_d = a_y / den_y
    lb_d = b_y / den_y

    # --- cell-center fine points (z odd, w odd) ----------------------------
    # group sums = the W column / N row / E column / S row coupling sums;
    # they enter only EP's min — the collapse SUM counts each of the 8
    # couplings ONCE (SETUP_interp_OI.f90:152-154), so the corner couplings,
    # which belong to two groups each, must not be double counted.
    g_w = W + (SW + sh(NW, 0, 1) if nine else 0.0)
    g_n = sh(S, 0, 1) + (sh(NW, 0, 1) + sh(SW, 1, 1) if nine else 0.0)
    g_e = sh(W, 1, 0) + (sh(SW, 1, 1) + sh(NW, 1, 0) if nine else 0.0)
    g_s = S + (SW + sh(NW, 1, 0) if nine else 0.0)
    sum_c = W + sh(W, 1, 0) + S + sh(S, 0, 1)
    if nine:
        sum_c = sum_c + SW + sh(SW, 1, 1) + sh(NW, 0, 1) + sh(NW, 1, 0)
    den_c = _guarded_den_corner(O, sum_c, (g_w, g_n, g_e, g_s), zeps)
    s_c = 1.0 / den_c

    # corner weights reuse the already-computed edge weights of the four
    # surrounding line points (SETUP_interp_OI.f90:168-179):
    #   LSW(f) = (S(f)·LL(f south) + W(f)·LB(f west) + SW(f)) · s
    #   LSE(f) = (S(f)·LR(f south) + E(f)·LB(f east) + NW(z+1,w)) · s
    #   LNW(f) = (W(f)·LA(f west) + N(f)·LL(f north) + NW(z,w+1)) · s
    #   LNE(f) = (N(f)·LR(f north) + E(f)·LA(f east) + SW(z+1,w+1)) · s
    ll_s = sh(ll_d, 0, -1)
    lr_s = sh(lr_d, 0, -1)
    ll_n = sh(ll_d, 0, 1)
    lr_n = sh(lr_d, 0, 1)
    lb_w = sh(lb_d, -1, 0)
    la_w = sh(la_d, -1, 0)
    lb_e = sh(lb_d, 1, 0)
    la_e = sh(la_d, 1, 0)
    E = sh(W, 1, 0)
    N = sh(S, 0, 1)
    if nine:
        lsw_d = (S * ll_s + W * lb_w + SW) * s_c
        lse_d = (S * lr_s + E * lb_e + sh(NW, 1, 0)) * s_c
        lnw_d = (W * la_w + N * ll_n + sh(NW, 0, 1)) * s_c
        lne_d = (N * lr_n + E * la_e + sh(SW, 1, 1)) * s_c
    else:
        lsw_d = (S * ll_s + W * lb_w) * s_c
        lse_d = (S * lr_s + E * lb_e) * s_c
        lnw_d = (W * la_w + N * ll_n) * s_c
        lne_d = (N * lr_n + E * la_e) * s_c

    # --- gather the valid parities into CI ---------------------------------
    # (deinterleave, not double-strided slices — see cedar_jax.core.parity)
    ci = jnp.zeros((8, nxc + 1, nyc + 1), so.dtype)
    kx = nx // 2   # number of x-line points per coarse row
    my = ny // 2   # number of y-line points per coarse column
    ci = ci.at[L.LL, 1 : 1 + kx, 0:nyc].set(deinterleave2(ll_d)[(1, 0)])
    ci = ci.at[L.LR, 1 : 1 + kx, 0:nyc].set(deinterleave2(lr_d)[(1, 0)])
    ci = ci.at[L.LA, 0:nxc, 1 : 1 + my].set(deinterleave2(la_d)[(0, 1)])
    ci = ci.at[L.LB, 0:nxc, 1 : 1 + my].set(deinterleave2(lb_d)[(0, 1)])
    ci = ci.at[L.LSW, 1 : 1 + kx, 1 : 1 + my].set(deinterleave2(lsw_d)[(1, 1)])
    ci = ci.at[L.LSE, 1 : 1 + kx, 1 : 1 + my].set(deinterleave2(lse_d)[(1, 1)])
    ci = ci.at[L.LNW, 1 : 1 + kx, 1 : 1 + my].set(deinterleave2(lnw_d)[(1, 1)])
    ci = ci.at[L.LNE, 1 : 1 + kx, 1 : 1 + my].set(deinterleave2(lne_d)[(1, 1)])

    # periodic wrap: fine point -1 ≡ nx-1, so index 0 of the planes stored
    # at odd x-parity mirrors the high entry kx (requires even nx, the
    # standard periodic-coarsening compatibility); likewise in y.
    if periodic[0]:
        for p in (L.LL, L.LR, L.LSW, L.LNW, L.LNE, L.LSE):
            ci = ci.at[p, 0, :].set(ci[p, kx, :])
    if periodic[1]:
        for p in (L.LA, L.LB, L.LSW, L.LNW, L.LNE, L.LSE):
            ci = ci.at[p, :, 0].set(ci[p, :, my])
    return ci


# Restriction weights around coarse point (zc, wc): the fine neighbor at
# offset (du, dv) contributes with the CI plane and CI slice offset below.
# Derived from BMG2_SymStd_restrict.f90:82-90; also the per-coarse-point
# interpolation footprint used by the generic Galerkin product.
#   (du, dv) -> (plane, kshift, mshift): weight = CI[plane][zc+kshift, wc+mshift]
PW_TABLE = {
    (-1, 0): (L.LR, 0, 0),
    (1, 0): (L.LL, 1, 0),
    (0, -1): (L.LA, 0, 0),
    (0, 1): (L.LB, 0, 1),
    (-1, -1): (L.LNE, 0, 0),
    (1, -1): (L.LNW, 1, 0),
    (-1, 1): (L.LSE, 0, 1),
    (1, 1): (L.LSW, 1, 1),
}


def pw_weights(ci: jnp.ndarray):
    """Per-coarse-point interpolation footprint.

    Returns dict ``(du, dv) -> (nxc, nyc)`` array: the weight from coarse
    point ``(zc, wc)`` to fine point ``(2zc+du, 2wc+dv)`` (coincident weight
    is identically 1).
    """
    nxc = ci.shape[1] - 1
    nyc = ci.shape[2] - 1
    out = {(0, 0): jnp.ones((nxc, nyc), ci.dtype)}
    for off, (plane, ks, ms) in PW_TABLE.items():
        out[off] = ci[plane, ks : ks + nxc, ms : ms + nyc]
    return out


def parity_sample(parts: dict, du: int, dv: int, nc):
    """``q[2zc+du, 2wc+dv]`` on the coarse grid, from parity subgrids.

    Contiguous shift of the right parity subgrid — avoids double-strided
    slices entirely (see cedar_jax.core.parity).
    """
    pz, pw_ = du % 2, dv % 2
    sz = (du - pz) // 2
    sw = (dv - pw_) // 2
    return subgrid_sample(parts[(pz, pw_)], sz, sw, nc)


def restrict(
    ci: jnp.ndarray, q: jnp.ndarray, periodic=(False, False)
) -> jnp.ndarray:
    """``qc = Pᵀ q`` (reference: BMG2_SymStd_restrict.f90:76-92)."""
    nxc = ci.shape[1] - 1
    nyc = ci.shape[2] - 1
    nc = (nxc, nyc)
    pw = pw_weights(ci)
    if any(periodic):
        # wrap sampling path (setup-rate only; periodic wrap crosses parity)
        qc = coarse_sample(q, (0, 0), nc, periodic)
        for off, wgt in pw.items():
            if off != (0, 0):
                qc = qc + wgt * coarse_sample(q, off, nc, periodic)
        return qc
    parts = deinterleave2(q)
    qc = parity_sample(parts, 0, 0, nc)
    for off, wgt in pw.items():
        if off == (0, 0):
            continue
        qc = qc + wgt * parity_sample(parts, off[0], off[1], nc)
    return qc


def interp_add(
    ci: jnp.ndarray,
    so: jnp.ndarray,
    qc: jnp.ndarray,
    res: jnp.ndarray,
    q: jnp.ndarray,
    periodic=(False, False),
) -> jnp.ndarray:
    """``q += P qc  (+ res/diag at fine-only points)``.

    Reference: BMG2_SymStd_interp_add.f90:101-137.  The residual used is the
    one computed before restriction (the cycle's ``level.res``), divided by
    the FINE diagonal.
    """
    nx, ny = q.shape
    nxc, nyc = qc.shape
    kx = nx // 2
    my = ny // 2
    r2p = deinterleave2(res / so[Dir2.O])
    # padded coarse solution: index nxc/nyc reads 0 (Dirichlet) or wraps to
    # coarse index 0 (periodic)
    qcp = jnp.pad(qc, ((0, 1), (0, 1)))
    if periodic[0]:
        qcp = qcp.at[nxc, :].set(qcp[0, :])
    if periodic[1]:
        qcp = qcp.at[:, nyc].set(qcp[:, 0])

    parts = {(0, 0): qc}

    # x-line points (2k-1, 2m), k in 1..kx, m in 0..nyc-1
    lr = ci[L.LR, 1 : 1 + kx, 0:nyc]
    ll = ci[L.LL, 1 : 1 + kx, 0:nyc]
    parts[(1, 0)] = (
        lr * qcp[1 : 1 + kx, 0:nyc]
        + ll * qcp[0:kx, 0:nyc]
        + r2p[(1, 0)]
    )

    # y-line points (2k, 2m-1), k in 0..nxc-1, m in 1..my
    la = ci[L.LA, 0:nxc, 1 : 1 + my]
    lb = ci[L.LB, 0:nxc, 1 : 1 + my]
    parts[(0, 1)] = (
        la * qcp[0:nxc, 1 : 1 + my]
        + lb * qcp[0:nxc, 0:my]
        + r2p[(0, 1)]
    )

    # cell centers (2k-1, 2m-1), k in 1..kx, m in 1..my
    lsw = ci[L.LSW, 1 : 1 + kx, 1 : 1 + my]
    lnw = ci[L.LNW, 1 : 1 + kx, 1 : 1 + my]
    lne = ci[L.LNE, 1 : 1 + kx, 1 : 1 + my]
    lse = ci[L.LSE, 1 : 1 + kx, 1 : 1 + my]
    parts[(1, 1)] = (
        lsw * qcp[0:kx, 0:my]
        + lnw * qcp[0:kx, 1 : 1 + my]
        + lne * qcp[1 : 1 + kx, 1 : 1 + my]
        + lse * qcp[1 : 1 + kx, 0:my]
        + r2p[(1, 1)]
    )

    return q + interleave2(parts, nx, ny)
