"""Kernel-level oracle tests for the 2D numeric kernels.

Two independent oracles, mirroring the reference's test strategy
(test/2d/test_relax.cc + pyrelax.pyx cross-validate against pyamg with
identical coloring, SURVEY §4):

1. literal numpy transcriptions of the reference Fortran loops
   (tests/oracles.py) — catches any semantic deviation exactly;
2. scipy sparse algebra — restriction must equal Pᵀ, interpolation P, and
   the Galerkin product Pᵀ A P (R is a pointer to P in the reference,
   include/cedar/2d/restrict_op.h:13-27).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

import oracles as orc
from cedar_jax.core.types import InterpDir2 as L, StencilKind
from cedar_jax.ops.galerkin2 import coarsen_op
from cedar_jax.ops.interp2 import interp_add, restrict, setup_interp
from cedar_jax.ops.relax2 import point_relax, setup_recip
from cedar_jax.ops.stencil2 import full_offsets, matvec, residual

SHAPES = [(8, 8), (9, 7), (10, 9), (7, 10), (16, 12)]


def random_so(rng, nx, ny, nine):
    ndir = 5 if nine else 3
    so = np.zeros((ndir, nx, ny))
    so[orc.KW, 1:, :] = rng.uniform(0.5, 1.5, (nx - 1, ny))
    so[orc.KS, :, 1:] = rng.uniform(0.5, 1.5, (nx, ny - 1))
    if nine:
        so[orc.KSW, 1:, 1:] = rng.uniform(0.1, 0.5, (nx - 1, ny - 1))
        so[orc.KNW, 1:, 1:] = rng.uniform(0.1, 0.5, (nx - 1, ny - 1))
    # diagonally dominant center via the ghosted row sums
    g = orc.pad_ghost_so(so)
    rowsum = np.zeros((nx + 2, ny + 2))
    W, S, SW, NW = g[orc.KW], g[orc.KS], g[orc.KSW], g[orc.KNW]
    for plane, sz, sw in [
        (W, 0, 0), (W, 1, 0), (S, 0, 0), (S, 0, 1),
        (SW, 0, 0), (NW, 1, 0), (NW, 0, 1), (SW, 1, 1),
    ]:
        p = np.roll(np.roll(plane, -sz, 0), -sw, 1)
        if sz:
            p[-1, :] = 0
        if sw:
            p[:, -1] = 0
        rowsum += p
    so[orc.KO] = rowsum[1:-1, 1:-1] + rng.uniform(0.05, 0.2, (nx, ny))
    return so


def sparse_from_so(so, kind, nshape):
    af = full_offsets(jnp.asarray(so), kind)
    n = int(np.prod(nshape))
    A = sp.lil_matrix((n, n))
    for (dz, dw), field in af.items():
        f = np.asarray(field)
        for z in range(nshape[0]):
            for w in range(nshape[1]):
                z2, w2 = z + dz, w + dw
                if 0 <= z2 < nshape[0] and 0 <= w2 < nshape[1]:
                    A[z * nshape[1] + w, z2 * nshape[1] + w2] += f[z, w]
    return A.tocsr()


def sparse_P(ci, nx, ny, nxc, nyc):
    cin = np.asarray(ci)
    P = sp.lil_matrix((nx * ny, nxc * nyc))
    fidx = lambda z, w: z * ny + w  # noqa: E731
    cidx = lambda k, m: k * nyc + m  # noqa: E731
    for k in range(nxc):
        for m in range(nyc):
            P[fidx(2 * k, 2 * m), cidx(k, m)] = 1.0
    for k in range(1, nx // 2 + 1):
        for m in range(nyc):
            z = 2 * k - 1
            P[fidx(z, 2 * m), cidx(k - 1, m)] += cin[L.LL, k, m]
            if k < nxc:
                P[fidx(z, 2 * m), cidx(k, m)] += cin[L.LR, k, m]
    for k in range(nxc):
        for m in range(1, ny // 2 + 1):
            w = 2 * m - 1
            P[fidx(2 * k, w), cidx(k, m - 1)] += cin[L.LB, k, m]
            if m < nyc:
                P[fidx(2 * k, w), cidx(k, m)] += cin[L.LA, k, m]
    for k in range(1, nx // 2 + 1):
        for m in range(1, ny // 2 + 1):
            z, w = 2 * k - 1, 2 * m - 1
            P[fidx(z, w), cidx(k - 1, m - 1)] += cin[L.LSW, k, m]
            if m < nyc:
                P[fidx(z, w), cidx(k - 1, m)] += cin[L.LNW, k, m]
            if k < nxc and m < nyc:
                P[fidx(z, w), cidx(k, m)] += cin[L.LNE, k, m]
            if k < nxc:
                P[fidx(z, w), cidx(k, m - 1)] += cin[L.LSE, k, m]
    return P.tocsr()


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("nine", [False, True])
def test_matvec_residual_vs_sparse(nx, ny, nine):
    rng = np.random.default_rng(nx * 100 + ny + nine)
    so = random_so(rng, nx, ny, nine)
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    A = sparse_from_so(so, kind, (nx, ny))
    assert abs(A - A.T).max() < 1e-14, "operator must be symmetric"
    q = rng.standard_normal((nx, ny))
    b = rng.standard_normal((nx, ny))
    mv = np.asarray(matvec(jnp.asarray(so), jnp.asarray(q), kind))
    np.testing.assert_allclose(
        mv, (A @ q.reshape(-1)).reshape(nx, ny), atol=1e-13
    )
    r = np.asarray(residual(jnp.asarray(so), jnp.asarray(q), jnp.asarray(b), kind))
    np.testing.assert_allclose(
        r, b - (A @ q.reshape(-1)).reshape(nx, ny), atol=1e-13
    )


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_point_relax_vs_fortran_oracle(nx, ny, nine, updown):
    rng = np.random.default_rng(7 + nx + ny)
    so = random_so(rng, nx, ny, nine)
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    g = orc.pad_ghost_so(so)
    q0 = rng.standard_normal((nx, ny))
    b0 = rng.standard_normal((nx, ny))
    sor = np.zeros((nx + 2, ny + 2))
    sor[1:-1, 1:-1] = 1.0 / so[orc.KO]
    qo = orc.relax_gs(
        g, orc.pad_ghost(q0), orc.pad_ghost(b0), sor, 5 if nine else 3, updown
    )
    qm = point_relax(
        jnp.asarray(so), jnp.asarray(q0), jnp.asarray(b0),
        setup_recip(jnp.asarray(so)), kind, updown,
    )
    np.testing.assert_allclose(orc.unpad(qo), np.asarray(qm), atol=1e-13)


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("nine", [False, True])
def test_interp_ops_vs_fortran_oracle(nx, ny, nine):
    rng = np.random.default_rng(13 + nx * ny)
    so = random_so(rng, nx, ny, nine)
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    g = orc.pad_ghost_so(so)
    nxc, nyc = (nx - 1) // 2 + 1, (ny - 1) // 2 + 1
    iif, jjf, iic, jjc = nx + 2, ny + 2, nxc + 2, nyc + 2

    cio = orc.setup_interp_oi(g, iif, jjf, iic, jjc, 0 if nine else 1)
    cim = np.asarray(setup_interp(jnp.asarray(so), kind))
    np.testing.assert_allclose(cio[:, 1:, 1:], cim, atol=1e-14)

    qf = rng.standard_normal((nx, ny))
    rco = orc.restrict(cio, orc.pad_ghost(qf), iic, jjc)
    rcm = np.asarray(restrict(jnp.asarray(cim), jnp.asarray(qf)))
    np.testing.assert_allclose(orc.unpad(rco), rcm, atol=1e-13)

    qcg = np.zeros((iic, jjc))
    qcg[1:-1, 1:-1] = rng.standard_normal((nxc, nyc))
    resg = orc.pad_ghost(rng.standard_normal((nx, ny)))
    q0 = rng.standard_normal((nx, ny))
    qao = orc.interp_add(cio, g, orc.pad_ghost(q0), qcg, resg, iif, jjf, iic, jjc)
    qam = np.asarray(
        interp_add(
            jnp.asarray(cim), jnp.asarray(so), jnp.asarray(qcg[1:-1, 1:-1]),
            jnp.asarray(resg[1:-1, 1:-1]), jnp.asarray(q0),
        )
    )
    np.testing.assert_allclose(orc.unpad(qao), qam, atol=1e-13)


@pytest.mark.parametrize("nx,ny", SHAPES)
@pytest.mark.parametrize("nine", [False, True])
def test_transfers_are_variational(nx, ny, nine):
    """restrict == Pᵀ·, interp == P·, coarsen == PᵀAP (sparse oracle)."""
    rng = np.random.default_rng(17 + nx + 3 * ny)
    so = random_so(rng, nx, ny, nine)
    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    nxc, nyc = (nx - 1) // 2 + 1, (ny - 1) // 2 + 1

    ci = setup_interp(jnp.asarray(so), kind)
    P = sparse_P(ci, nx, ny, nxc, nyc)
    A = sparse_from_so(so, kind, (nx, ny))

    qf = rng.standard_normal((nx, ny))
    rc = np.asarray(restrict(ci, jnp.asarray(qf)))
    np.testing.assert_allclose(
        rc, (P.T @ qf.reshape(-1)).reshape(nxc, nyc), atol=1e-13
    )

    qc = rng.standard_normal((nxc, nyc))
    xa = np.asarray(
        interp_add(ci, jnp.asarray(so), jnp.asarray(qc),
                   jnp.zeros((nx, ny)), jnp.zeros((nx, ny)))
    )
    np.testing.assert_allclose(
        xa, (P @ qc.reshape(-1)).reshape(nx, ny), atol=1e-13
    )

    soc = coarsen_op(ci, jnp.asarray(so), kind)
    Ac = sparse_from_so(np.asarray(soc), StencilKind.nine_pt, (nxc, nyc))
    Ac_ref = (P.T @ A @ P).tocsr()
    assert abs(Ac - Ac_ref).max() < 1e-12


def test_coarse_direct_solve():
    from cedar_jax.ops import cg

    rng = np.random.default_rng(3)
    so = random_so(rng, 7, 6, True)
    ainv = cg.setup_cg_lu(jnp.asarray(so), StencilKind.nine_pt, (False, False))
    b = rng.standard_normal((7, 6))
    x = cg.solve_cg(ainv, jnp.asarray(b))
    r = residual(jnp.asarray(so), x, jnp.asarray(b), StencilKind.nine_pt)
    assert float(jnp.max(jnp.abs(r))) < 1e-11
