"""Kernel-level oracle tests for the 3D numeric kernels.

Same strategy as tests/test_kernels_2d.py: (1) literal Fortran
transcriptions (tests/oracles3.py) pin relaxation/interp-setup/transfer
semantics; (2) scipy sparse algebra pins the variational identities
(restrict = Pᵀ, interp = P, coarsen = PᵀAP); (3) the seven-point path must
equal the 27-point path on a zero-padded operator (the reference's 7-point
branch of BMG3_SymStd_SETUP_interp_OI.f90:542-810 is exactly that
degeneration).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

import oracles3 as orc
from cedar_jax.core.types import StencilKind
from cedar_jax.ops.galerkin3 import coarsen_op
from cedar_jax.ops.interp3 import (
    interp_add,
    pw_weights,
    restrict,
    setup_interp,
)
from cedar_jax.ops.relax3 import point_relax, setup_recip
from cedar_jax.ops.stencil3 import full_offsets, matvec, offdiag_apply, residual

SHAPES = [(8, 8, 8), (9, 7, 6), (6, 9, 8), (7, 6, 9)]


def random_so(rng, nx, ny, nz, twenty_seven):
    """Random symmetric diagonally-dominant operator in stored form."""
    ndir = 14 if twenty_seven else 4
    so = np.zeros((ndir, nx, ny, nz))
    so[orc.KPW, 1:, :, :] = rng.uniform(0.5, 1.5, (nx - 1, ny, nz))
    so[orc.KPS, :, 1:, :] = rng.uniform(0.5, 1.5, (nx, ny - 1, nz))
    so[orc.KB, :, :, 1:] = rng.uniform(0.5, 1.5, (nx, ny, nz - 1))
    if twenty_seven:
        so[orc.KPSW, 1:, 1:, :] = rng.uniform(0.1, 0.4, (nx - 1, ny - 1, nz))
        so[orc.KPNW, 1:, 1:, :] = rng.uniform(0.1, 0.4, (nx - 1, ny - 1, nz))
        so[orc.KBW, 1:, :, 1:] = rng.uniform(0.1, 0.4, (nx - 1, ny, nz - 1))
        so[orc.KBE, 1:, :, 1:] = rng.uniform(0.1, 0.4, (nx - 1, ny, nz - 1))
        so[orc.KBS, :, 1:, 1:] = rng.uniform(0.1, 0.4, (nx, ny - 1, nz - 1))
        so[orc.KBN, :, 1:, 1:] = rng.uniform(0.1, 0.4, (nx, ny - 1, nz - 1))
        for d in (orc.KBSW, orc.KBNW, orc.KBNE, orc.KBSE):
            so[d, 1:, 1:, 1:] = rng.uniform(
                0.05, 0.2, (nx - 1, ny - 1, nz - 1)
            )
    kind = (
        StencilKind.twenty_seven_pt if twenty_seven else StencilKind.seven_pt
    )
    so[orc.KP] = 1.0  # placeholder for coupling-sum computation
    rowsum = np.asarray(
        offdiag_apply(jnp.asarray(so), jnp.ones((nx, ny, nz)), kind)
    )
    so[orc.KP] = rowsum + rng.uniform(0.05, 0.2, (nx, ny, nz))
    return so


def sparse_from_so(so, kind, nshape):
    af = full_offsets(jnp.asarray(so), kind)
    n = int(np.prod(nshape))
    A = sp.lil_matrix((n, n))
    strides = (nshape[1] * nshape[2], nshape[2], 1)
    for off, field in af.items():
        f = np.asarray(field)
        for z in range(nshape[0]):
            for w in range(nshape[1]):
                for v in range(nshape[2]):
                    nb = (z + off[0], w + off[1], v + off[2])
                    if all(0 <= nb[d] < nshape[d] for d in range(3)):
                        row = z * strides[0] + w * strides[1] + v
                        col = sum(nb[d] * strides[d] for d in range(3))
                        A[row, col] += f[z, w, v]
    return A.tocsr()


def sparse_P(ci, nf, nc):
    """Interpolation matrix from the framework's coarse-point footprint."""
    pw = {k: np.asarray(v) for k, v in pw_weights(jnp.asarray(ci)).items()}
    P = sp.lil_matrix((int(np.prod(nf)), int(np.prod(nc))))
    fst = (nf[1] * nf[2], nf[2], 1)
    cst = (nc[1] * nc[2], nc[2], 1)
    for kc in range(nc[0]):
        for mc in range(nc[1]):
            for lc in range(nc[2]):
                col = kc * cst[0] + mc * cst[1] + lc
                for off, w in pw.items():
                    fi = (2 * kc + off[0], 2 * mc + off[1], 2 * lc + off[2])
                    if all(0 <= fi[d] < nf[d] for d in range(3)):
                        row = sum(fi[d] * fst[d] for d in range(3))
                        P[row, col] += w[kc, mc, lc]
    return P.tocsr()


@pytest.mark.parametrize("nx,ny,nz", SHAPES[:2])
@pytest.mark.parametrize("twenty_seven", [False, True])
def test_matvec_residual_vs_sparse(nx, ny, nz, twenty_seven):
    rng = np.random.default_rng(nx * 100 + ny * 10 + nz + twenty_seven)
    so = random_so(rng, nx, ny, nz, twenty_seven)
    kind = (
        StencilKind.twenty_seven_pt if twenty_seven else StencilKind.seven_pt
    )
    A = sparse_from_so(so, kind, (nx, ny, nz))
    assert abs(A - A.T).max() < 1e-14, "operator must be symmetric"
    q = rng.standard_normal((nx, ny, nz))
    b = rng.standard_normal((nx, ny, nz))
    mv = np.asarray(matvec(jnp.asarray(so), jnp.asarray(q), kind))
    np.testing.assert_allclose(
        mv, (A @ q.reshape(-1)).reshape(nx, ny, nz), atol=1e-12
    )
    r = np.asarray(
        residual(jnp.asarray(so), jnp.asarray(q), jnp.asarray(b), kind)
    )
    np.testing.assert_allclose(
        r, b - (A @ q.reshape(-1)).reshape(nx, ny, nz), atol=1e-12
    )


@pytest.mark.parametrize("nx,ny,nz", SHAPES[:2])
@pytest.mark.parametrize("twenty_seven", [False, True])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_point_relax_vs_fortran_oracle(nx, ny, nz, twenty_seven, updown):
    rng = np.random.default_rng(7 + nx + ny + nz)
    so = random_so(rng, nx, ny, nz, twenty_seven)
    kind = (
        StencilKind.twenty_seven_pt if twenty_seven else StencilKind.seven_pt
    )
    g = orc.pad_ghost_so(so)
    q0 = rng.standard_normal((nx, ny, nz))
    b0 = rng.standard_normal((nx, ny, nz))
    sor = orc.pad_ghost(1.0 / so[orc.KP])
    qo = orc.relax_gs(
        g, orc.pad_ghost(q0), orc.pad_ghost(b0), sor,
        14 if twenty_seven else 4, updown,
    )
    qm = point_relax(
        jnp.asarray(so), jnp.asarray(q0), jnp.asarray(b0),
        setup_recip(jnp.asarray(so)), kind, updown,
    )
    np.testing.assert_allclose(orc.unpad(qo), np.asarray(qm), atol=1e-12)


@pytest.mark.parametrize("nx,ny,nz", SHAPES)
def test_interp_ops_vs_fortran_oracle(nx, ny, nz):
    rng = np.random.default_rng(13 + nx * ny + nz)
    so = random_so(rng, nx, ny, nz, True)
    g = orc.pad_ghost_so(so)
    nxc, nyc, nzc = [(n - 1) // 2 + 1 for n in (nx, ny, nz)]
    dims_f = (nx + 2, ny + 2, nz + 2)
    dims_c = (nxc + 2, nyc + 2, nzc + 2)

    cio = orc.setup_interp_oi(g, *dims_f, *dims_c)
    cim = np.asarray(setup_interp(jnp.asarray(so), StencilKind.twenty_seven_pt))
    np.testing.assert_allclose(cio[:, 1:, 1:, 1:], cim, atol=1e-13)

    qf = rng.standard_normal((nx, ny, nz))
    rco = orc.restrict(cio, orc.pad_ghost(qf), *dims_c)
    rcm = np.asarray(restrict(jnp.asarray(cim), jnp.asarray(qf)))
    np.testing.assert_allclose(orc.unpad(rco), rcm, atol=1e-12)

    qcg = np.zeros(dims_c)
    qcg[1:-1, 1:-1, 1:-1] = rng.standard_normal((nxc, nyc, nzc))
    resg = orc.pad_ghost(rng.standard_normal((nx, ny, nz)))
    q0 = rng.standard_normal((nx, ny, nz))
    qao = orc.interp_add(
        cio, g, orc.pad_ghost(q0), qcg, resg, *dims_f, *dims_c
    )
    qam = np.asarray(
        interp_add(
            jnp.asarray(cim), jnp.asarray(so),
            jnp.asarray(qcg[1:-1, 1:-1, 1:-1]),
            jnp.asarray(resg[1:-1, 1:-1, 1:-1]), jnp.asarray(q0),
        )
    )
    np.testing.assert_allclose(orc.unpad(qao), qam, atol=1e-12)


@pytest.mark.parametrize("nx,ny,nz", SHAPES[:2])
def test_seven_pt_equals_embedded_27pt(nx, ny, nz):
    """The 7-pt interp branch is the 27-pt math with zero corners
    (reference: BMG3_SymStd_SETUP_interp_OI.f90:542-810)."""
    rng = np.random.default_rng(29 + nx)
    so7 = random_so(rng, nx, ny, nz, False)
    so27 = np.zeros((14, nx, ny, nz))
    so27[:4] = so7
    ci7 = np.asarray(setup_interp(jnp.asarray(so7), StencilKind.seven_pt))
    ci27 = np.asarray(
        setup_interp(jnp.asarray(so27), StencilKind.twenty_seven_pt)
    )
    np.testing.assert_allclose(ci7, ci27, atol=1e-14)


@pytest.mark.parametrize("nx,ny,nz", SHAPES[:3])
@pytest.mark.parametrize("twenty_seven", [False, True])
def test_transfers_are_variational(nx, ny, nz, twenty_seven):
    """restrict == Pᵀ·, interp == P·, coarsen == PᵀAP (sparse oracle)."""
    rng = np.random.default_rng(17 + nx + 3 * ny + nz)
    so = random_so(rng, nx, ny, nz, twenty_seven)
    kind = (
        StencilKind.twenty_seven_pt if twenty_seven else StencilKind.seven_pt
    )
    nf = (nx, ny, nz)
    nc = tuple((n - 1) // 2 + 1 for n in nf)

    ci = setup_interp(jnp.asarray(so), kind)
    P = sparse_P(ci, nf, nc)
    A = sparse_from_so(so, kind, nf)

    qf = rng.standard_normal(nf)
    rc = np.asarray(restrict(ci, jnp.asarray(qf)))
    np.testing.assert_allclose(
        rc, (P.T @ qf.reshape(-1)).reshape(nc), atol=1e-12
    )

    qc = rng.standard_normal(nc)
    xa = np.asarray(
        interp_add(ci, jnp.asarray(so), jnp.asarray(qc),
                   jnp.zeros(nf), jnp.zeros(nf))
    )
    np.testing.assert_allclose(
        xa, (P @ qc.reshape(-1)).reshape(nf), atol=1e-12
    )

    soc = coarsen_op(ci, jnp.asarray(so), kind)
    Ac = sparse_from_so(
        np.asarray(soc), StencilKind.twenty_seven_pt, nc
    )
    Ac_ref = (P.T @ A @ P).tocsr()
    assert abs(Ac - Ac_ref).max() < 1e-11


def test_coarse_direct_solve():
    from cedar_jax.ops import cg

    rng = np.random.default_rng(3)
    so = random_so(rng, 5, 6, 4, True)
    ainv = cg.setup_cg_lu(
        jnp.asarray(so), StencilKind.twenty_seven_pt, (False, False, False)
    )
    b = rng.standard_normal((5, 6, 4))
    x = cg.solve_cg(ainv, jnp.asarray(b))
    r = residual(
        jnp.asarray(so), x, jnp.asarray(b), StencilKind.twenty_seven_pt
    )
    assert float(jnp.max(jnp.abs(r))) < 1e-11
