"""Coarse-solver equivalence (reference: test/2d/mpi/test_cgsolve.cc —
LU vs inner-cedar coarse solves agree < 1e-10)."""

import jax
import jax.numpy as jnp
import pytest

from cedar_jax import FivePt, SevenPt, Solver2, Solver3, gallery
from cedar_jax.config import Config


def test_cgsolve_lu_vs_cedar_2d():
    so = gallery.poisson(128, 128)
    b = gallery.poisson_rhs(128, 128)
    xa = Solver2(so, FivePt, Config({
        "log": [], "solver": {"tol": 1e-10, "max-iter": 30}})).solve(b)
    s = Solver2(so, FivePt, Config({
        "log": [],
        "solver": {"tol": 1e-10, "max-iter": 30, "num-levels": 3,
                   "cg-solver": "cedar"},
        "cg-config": {"solver": {"tol": 1e-12, "max-iter": 20}},
    }))
    assert s.levels[-1].inner is not None
    xb = s.solve(b)
    assert float(jnp.max(jnp.abs(xa - xb))) < 1e-10


def test_cgsolve_lu_vs_cedar_3d():
    n = 24
    so = gallery.poisson3(n, n, n)
    b = gallery.poisson3_rhs(n, n, n)
    xa = Solver3(so, SevenPt, Config({
        "log": [], "solver": {"tol": 1e-10, "max-iter": 30}})).solve(b)
    s = Solver3(so, SevenPt, Config({
        "log": [],
        "solver": {"tol": 1e-10, "max-iter": 30, "num-levels": 2,
                   "cg-solver": "cedar"},
        "cg-config": {"solver": {"tol": 1e-12, "max-iter": 20}},
    }))
    assert s.levels[-1].inner is not None
    xb = s.solve(b)
    assert float(jnp.max(jnp.abs(xa - xb))) < 1e-10


def test_cgsolve_nested_depth2_2d():
    """Depth-2 cg-config recursion: the inner coarse solver itself uses an
    inner-cedar coarse solve (reference nests to depth 3+,
    test/2d/mpi/test-cgredist-1.json path [[4,4],[2,2],[2,1],[1,1]])."""
    so = gallery.poisson(128, 128)
    b = gallery.poisson_rhs(128, 128)
    xa = Solver2(so, FivePt, Config({
        "log": [], "solver": {"tol": 1e-10, "max-iter": 30}})).solve(b)
    s = Solver2(so, FivePt, Config({
        "log": [],
        "solver": {"tol": 1e-10, "max-iter": 30, "num-levels": 2,
                   "cg-solver": "cedar"},
        "cg-config": {
            "solver": {"tol": 1e-12, "max-iter": 20, "num-levels": 2,
                       "cg-solver": "cedar"},
            "cg-config": {"solver": {"tol": 1e-12, "max-iter": 20}},
        },
    }))
    inner = s.levels[-1].inner
    assert inner is not None
    assert inner[-1].inner is not None  # depth-2 nesting materialized
    xb = s.solve(b)
    assert float(jnp.max(jnp.abs(xa - xb))) < 1e-10


def test_cgsolve_lu_vs_redist_sharded():
    """Agglomerated (redist) vs direct-LU coarse solve under sharding on
    the virtual 8-CPU mesh: solutions agree < 1e-10 (the analogue of the
    reference's np=16 equivalence test, test/2d/mpi/test_cgredist.cc:84)."""
    import jax

    from cedar_jax.parallel import DistSolver2, make_mesh

    mesh = make_mesh(2, devices=jax.devices("cpu"))
    so = gallery.poisson(64, 64)
    b = gallery.poisson_rhs(64, 64)
    xa = DistSolver2(so, FivePt, Config({
        "log": [], "solver": {"tol": 1e-10, "max-iter": 30}}), mesh).solve(b)
    s = DistSolver2(so, FivePt, Config({
        "log": [],
        "solver": {"tol": 1e-10, "max-iter": 30, "num-levels": 3,
                   "cg-solver": "redist"},
        "cg-config": {"solver": {"tol": 1e-12, "max-iter": 20}},
    }), mesh)
    assert s.levels[-1].inner is not None
    xb = s.solve(b)
    assert float(jnp.max(jnp.abs(xa - xb))) < 1e-10


def _coarse_cases():
    import numpy as np

    from test_kernels_2d import random_so as rso2
    from test_kernels_3d import random_so as rso3
    from cedar_jax.core.types import StencilKind

    rng = np.random.default_rng(21)
    return {
        "5pt": (rso2(rng, 7, 6, False), StencilKind.five_pt),
        "9pt": (rso2(rng, 5, 7, True), StencilKind.nine_pt),
        "7pt": (rso3(rng, 4, 5, 3, False), StencilKind.seven_pt),
        "27pt": (rso3(rng, 3, 4, 5, True), StencilKind.twenty_seven_pt),
    }


@pytest.mark.parametrize("case", ["5pt", "9pt", "7pt", "27pt"])
def test_coarse_solve_lowers_at_highest_precision(case):
    """The coarse solve's matrix-vector product asks for full precision
    (a GPU may otherwise take a float32 product in TF32)."""
    from jax import lax

    from cedar_jax.ops import cg

    so, kind = _coarse_cases()[case]
    ainv = jnp.zeros((so[0].size,) * 2, jnp.float32)
    b = jnp.zeros(so.shape[1:], jnp.float32)
    eqns = jax.make_jaxpr(cg.solve_cg)(ainv, b).jaxpr.eqns
    dots = [e for e in eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 1
    prec = dots[0].params["precision"]
    assert prec is not None and all(
        p == lax.Precision.HIGHEST for p in prec)


@pytest.mark.parametrize("case", ["5pt", "9pt", "7pt", "27pt"])
def test_coarse_solve_matches_numpy_solve(case):
    """A^-1 b from the setup-time inverse equals numpy.linalg.solve on the
    assembled dense operator, to 1e-10 in float64."""
    import numpy as np

    from cedar_jax.ops import cg

    so, kind = _coarse_cases()[case]
    per = (False,) * kind.ndim
    ainv = cg.setup_cg_lu(jnp.asarray(so), kind, per)
    rng = np.random.default_rng(5)
    b = rng.standard_normal(so.shape[1:])
    x = np.asarray(cg.solve_cg(ainv, jnp.asarray(b)))
    A = np.asarray(cg.assemble_dense(jnp.asarray(so), kind, per))
    # x-fastest flattening, the ordering assemble_dense uses
    axes = tuple(reversed(range(b.ndim)))
    ref = np.linalg.solve(A, b.transpose(axes).reshape(-1))
    ref = ref.reshape(tuple(reversed(b.shape))).transpose(axes)
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-10 * np.abs(ref).max())
