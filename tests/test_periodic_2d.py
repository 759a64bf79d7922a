"""Periodic boundary conditions, 2D.

The reference supports per-axis periodicity via JPN flags in every kernel
(e.g. BMG2_SymStd_relax_GS.f90 periodic branches, restrict ghost wraps) and
an indefiniteness shift + mean subtraction in the coarse solve for the
fully-periodic singular case (BMG2_SymStd_SOLVE_cg.f90:124-141).  Here
periodicity is wrap-around shifts; these tests pin the x-periodic definite
case against a scipy sparse direct solve.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from cedar_jax import FivePt, Solver2
from cedar_jax.config import Config
from cedar_jax.core.types import Dir2, StencilKind
from cedar_jax.ops.stencil2 import matvec, residual


def periodic_x_poisson(nx, ny):
    """5-point Poisson, periodic in x, Dirichlet in y (definite)."""
    so = np.zeros((3, nx, ny))
    so[Dir2.W, :, :] = 1.0       # W at z=0 wraps to z=nx-1
    so[Dir2.S, :, 1:] = 1.0
    so[Dir2.O] = 4.0
    return so


def sparse_periodic(so, nshape, periodic):
    from cedar_jax.ops.stencil2 import full_offsets

    af = full_offsets(jnp.asarray(so), StencilKind.five_pt, periodic)
    n = int(np.prod(nshape))
    A = sp.lil_matrix((n, n))
    for (dz, dw), field in af.items():
        f = np.asarray(field)
        for z in range(nshape[0]):
            for w in range(nshape[1]):
                z2, w2 = z + dz, w + dw
                if periodic[0]:
                    z2 %= nshape[0]
                if periodic[1]:
                    w2 %= nshape[1]
                if 0 <= z2 < nshape[0] and 0 <= w2 < nshape[1]:
                    A[z * nshape[1] + w, z2 * nshape[1] + w2] += f[z, w]
    return A.tocsr()


def test_periodic_matvec_vs_sparse():
    nx, ny = 16, 12
    so = periodic_x_poisson(nx, ny)
    per = (True, False)
    A = sparse_periodic(so, (nx, ny), per)
    assert abs(A - A.T).max() < 1e-14
    rng = np.random.default_rng(0)
    q = rng.standard_normal((nx, ny))
    mv = np.asarray(matvec(jnp.asarray(so), jnp.asarray(q),
                           StencilKind.five_pt, per))
    np.testing.assert_allclose(
        mv, (A @ q.reshape(-1)).reshape(nx, ny), atol=1e-13)


def test_periodic_x_solve():
    nx, ny = 32, 32
    so = periodic_x_poisson(nx, ny)
    per = (True, False)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((nx, ny))
    conf = Config({
        "log": [],
        "grid": {"periodic": [True, False]},
        "solver": {"tol": 1e-10, "max-iter": 40},
    })
    s = Solver2(jnp.asarray(so), FivePt, conf)
    x = s.solve(jnp.asarray(b))
    r = residual(jnp.asarray(so), x, jnp.asarray(b),
                 StencilKind.five_pt, per)
    rel = float(jnp.sqrt(jnp.sum(r * r)) / np.linalg.norm(b))
    assert rel < 1e-10
    A = sparse_periodic(so, (nx, ny), per)
    xd = spla.spsolve(A.tocsc(), b.reshape(-1)).reshape(nx, ny)
    np.testing.assert_allclose(np.asarray(x), xd, atol=1e-8)


def periodic_x_aniso(nx, ny, eps=0.1):
    """Anisotropic operator, periodic + strong coupling in x."""
    so = np.zeros((3, nx, ny))
    so[Dir2.W, :, :] = 1.0
    so[Dir2.S, :, 1:] = eps
    so[Dir2.O] = 2.0 + 2.0 * eps
    return so


def test_cyclic_line_exact_decoupled():
    """With zero y-coupling each x-line is an independent cyclic tridiagonal
    system: ONE zebra sweep must solve the system exactly (the reference's
    PER_x line branch, BMG2_SymStd_relax_lines_x.f90:72-172)."""
    from cedar_jax.ops.lines2 import line_relax_x, setup_lines

    nx, ny = 24, 8
    so = np.zeros((3, nx, ny))
    so[Dir2.W, :, :] = 1.0
    so[Dir2.O] = 2.5
    rng = np.random.default_rng(3)
    b = rng.standard_normal((nx, ny))
    so_j = jnp.asarray(so)
    sor = setup_lines(so_j, StencilKind.five_pt, "x")
    q = line_relax_x(so_j, jnp.zeros((nx, ny)), jnp.asarray(b), sor,
                     StencilKind.five_pt, "down", (True, False))
    r = residual(so_j, q, jnp.asarray(b), StencilKind.five_pt, (True, False))
    assert float(jnp.abs(r).max()) < 1e-12


def test_cyclic_line_solve_vs_sparse():
    """Full line-x multigrid solve on an x-periodic anisotropic problem
    matches a scipy sparse direct solve."""
    nx, ny = 32, 32
    so = periodic_x_aniso(nx, ny)
    per = (True, False)
    rng = np.random.default_rng(4)
    b = rng.standard_normal((nx, ny))
    conf = Config({
        "log": [],
        "grid": {"periodic": [True, False]},
        "solver": {"relaxation": "line-x", "tol": 1e-10, "max-iter": 40},
    })
    s = Solver2(jnp.asarray(so), FivePt, conf)
    x = s.solve(jnp.asarray(b))
    A = sparse_periodic(so, (nx, ny), per)
    xd = spla.spsolve(A.tocsc(), b.reshape(-1)).reshape(nx, ny)
    np.testing.assert_allclose(np.asarray(x), xd, atol=1e-8)


def test_cyclic_line_y_solve():
    """line-y on a y-periodic problem (transposed path)."""
    nx, ny = 32, 32
    so = np.zeros((3, nx, ny))
    so[Dir2.S, :, :] = 1.0
    so[Dir2.W, 1:, :] = 0.1
    so[Dir2.O] = 2.2
    per = (False, True)
    rng = np.random.default_rng(5)
    b = rng.standard_normal((nx, ny))
    conf = Config({
        "log": [],
        "grid": {"periodic": [False, True]},
        "solver": {"relaxation": "line-y", "tol": 1e-10, "max-iter": 40},
    })
    s = Solver2(jnp.asarray(so), FivePt, conf)
    x = s.solve(jnp.asarray(b))
    A = sparse_periodic(so, (nx, ny), per)
    xd = spla.spsolve(A.tocsc(), b.reshape(-1)).reshape(nx, ny)
    np.testing.assert_allclose(np.asarray(x), xd, atol=1e-8)


def test_zebra_odd_periodic_orthogonal_raises():
    """Zebra x-lines with an ODD number of lines on a periodic y axis would
    put two same-color lines adjacent — must raise, not mis-solve."""
    import pytest

    from cedar_jax.ops.lines2 import line_relax_x, setup_lines

    nx, ny = 16, 9
    so = np.zeros((3, nx, ny))
    so[Dir2.W, :, :] = 1.0
    so[Dir2.S, :, :] = 1.0
    so[Dir2.O] = 4.0
    so_j = jnp.asarray(so)
    sor = setup_lines(so_j, StencilKind.five_pt, "x")
    with pytest.raises(ValueError, match="even number of lines"):
        line_relax_x(so_j, jnp.zeros((nx, ny)), jnp.zeros((nx, ny)), sor,
                     StencilKind.five_pt, "down", (True, True))


def test_fully_periodic_singular():
    """Doubly periodic Poisson is singular: the coarse solve applies the
    reference's rank-deficiency shift (BMG2_SymStd_SETUP_cg_LU indefinite
    branch) and the cycle converges on compatible right-hand sides."""
    nx = ny = 32
    so = np.zeros((3, nx, ny))
    so[Dir2.W] = 1.0
    so[Dir2.S] = 1.0
    so[Dir2.O] = 4.0
    rng = np.random.default_rng(2)
    b = rng.standard_normal((nx, ny))
    b -= b.mean()  # compatibility: b ⟂ null space
    conf = Config({
        "log": [],
        "grid": {"periodic": [True, True]},
        "solver": {"definite": False, "tol": 1e-10, "max-iter": 60},
    })
    s = Solver2(jnp.asarray(so), FivePt, conf)
    x = s.solve(jnp.asarray(b))
    r = residual(jnp.asarray(so), x, jnp.asarray(b),
                 StencilKind.five_pt, (True, True))
    rel = float(jnp.sqrt(jnp.sum(r * r)) / np.linalg.norm(b))
    assert rel < 1e-10


# ---------------------------------------------------------------------------
# Periodic fast path: the fused Pallas sweep with wrap halos / lane rolls
# (reference: PER_x / PER_y / PER_xy branches of
# BMG2_SymStd_relax_GS.f90:139-226)
# ---------------------------------------------------------------------------

def _random_periodic_so(rng, nx, ny, nine, per):
    """Random SPD-ish operator honoring the storage convention: boundary
    couplings are zero on non-periodic axes, nonzero (wrapping) on
    periodic ones."""
    ndir = 5 if nine else 3
    so = rng.random((ndir, nx, ny)) * 0.5 + 0.25
    # storage convention: every plane entry referencing a nonexistent
    # low-index point is zero on non-periodic axes (W/SW/NW row 0 for x,
    # S/SW/NW column 0 for y — cf. test_kernels_2d.random_so)
    if not per[0]:
        so[Dir2.W, 0, :] = 0.0
        if nine:
            so[Dir2.SW, 0, :] = 0.0
            so[Dir2.NW, 0, :] = 0.0
    if not per[1]:
        so[Dir2.S, :, 0] = 0.0
        if nine:
            so[Dir2.SW, :, 0] = 0.0
            so[Dir2.NW, :, 0] = 0.0
    so[Dir2.O] = 4.0 + rng.random((nx, ny))
    return so


def _periodic_sweep_case(rng, nx, ny, nine, per):
    from cedar_jax.ops import pallas2, relax2

    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    assert pallas2.supported((nx, ny), jnp.float32, kind, per)
    so = jnp.asarray(_random_periodic_so(rng, nx, ny, nine, per),
                     jnp.float32)
    q0 = jnp.asarray(rng.standard_normal((nx, ny)), jnp.float32)
    b = jnp.asarray(rng.standard_normal((nx, ny)), jnp.float32)
    recip = relax2.setup_recip(so)
    for updown in ("down", "up"):
        ref = relax2.point_relax(so, q0, b, recip, kind, updown, per)
        got = pallas2.point_relax(so, q0, b, kind, updown, periodic=per,
                                  interpret=True)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=1e-5,
            atol=1e-5, err_msg=f"{kind} {per} {updown}")
    # fused residual
    ref = relax2.point_relax(so, q0, b, recip, kind, "down", per)
    rref = residual(so, ref, b, kind, per)
    got, res = pallas2.point_relax(so, q0, b, kind, "down", True,
                                   periodic=per, interpret=True)
    np.testing.assert_allclose(np.asarray(res), np.asarray(rref),
                               rtol=1e-5, atol=1e-5)


def test_pallas_periodic_sweep_matches_xla():
    rng = np.random.default_rng(7)
    for nine in (False, True):
        for per in [(True, False), (False, True), (True, True)]:
            _periodic_sweep_case(rng, 64, 256, nine, per)


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("per", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("shape", [(37, 45), (10, 9)])
def test_pallas_periodic_sweep_odd_shapes(nine, per, shape):
    """Odd periodic extents: the wrap-pad and the folded color index."""
    rng = np.random.default_rng(sum(shape) + 3 * nine)
    _periodic_sweep_case(rng, *shape, nine, per)


def test_pallas_periodic_solver_matches_xla():
    """End-to-end: an x-periodic solve with the pallas backend takes the
    periodic fused sweep on the fine level and matches the XLA-backend
    history.  The kernel runs in the interpreter: the solver is built on
    the XLA backend, then switched over before its first solve."""
    from cedar_jax.solver import cycle2

    nx, ny = 64, 256
    so = np.zeros((3, nx, ny))
    so[Dir2.W, :, :] = 1.0       # periodic x: W wraps at z=0
    so[Dir2.S, :, 1:] = 1.0
    so[Dir2.O] = 4.0
    rng = np.random.default_rng(11)
    b = rng.standard_normal((nx, ny))
    base = {
        "log": [],
        "grid": {"periodic": [True, False]},
        "solver": {"tol": 1e-6, "max-iter": 6},
        "kernels": {"backend": "xla"},
    }
    s_xla = Solver2(jnp.asarray(so, jnp.float32), FivePt, Config(base))
    x_xla = s_xla.solve(jnp.asarray(b, jnp.float32))

    s_pal = Solver2(jnp.asarray(so, jnp.float32), FivePt, Config(base))
    s_pal.settings.kernel_backend = "pallas"
    s_pal.settings.kernel_interpret = True
    assert cycle2._use_pallas(s_pal.settings, StencilKind.five_pt,
                              (nx, ny), jnp.float32, (True, False))
    x_pal = s_pal.solve(jnp.asarray(b, jnp.float32))
    np.testing.assert_allclose(np.asarray(x_xla), np.asarray(x_pal),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(s_xla.history),
                               np.asarray(s_pal.history), rtol=1e-3)
