"""Handle-based procedural API tests (reference: C API round-trip,
src/2d/interface/c/solver.cc)."""

import numpy as np
import jax.numpy as jnp

import cedar_jax.capi as capi
from cedar_jax import gallery


def test_capi_2d_roundtrip():
    n = 64
    topo = capi.bmg2_topo_create(n, n)
    op = capi.bmg2_operator_create(topo)
    so = np.asarray(gallery.poisson(n, n))
    capi.bmg2_operator_set_full(op, so)

    b = np.asarray(gallery.poisson_rhs(n, n))
    # operator apply: A x against the module-level matvec
    x0 = np.random.default_rng(0).standard_normal((n, n))
    ax = capi.bmg2_operator_apply(op, x0)
    from cedar_jax.core.types import StencilKind
    from cedar_jax.ops.stencil2 import matvec

    np.testing.assert_allclose(
        ax, np.asarray(matvec(jnp.asarray(so), jnp.asarray(x0),
                              StencilKind.five_pt)), atol=1e-13)

    slv = capi.bmg2_solver_create(op, {"log": [],
                                       "solver": {"tol": 1e-9,
                                                  "max-iter": 30}})
    x = np.zeros((n, n))
    capi.bmg2_solver_run(slv, x, b)
    err = np.abs(x - np.asarray(gallery.poisson_solution(n, n))).max()
    assert err < 1e-3
    capi.bmg2_solver_destroy(slv)
    capi.bmg2_operator_destroy(op)


def test_capi_3d_roundtrip():
    n = 16
    topo = capi.bmg3_topo_create(n, n, n)
    op = capi.bmg3_operator_create(topo)
    capi.bmg3_operator_set_full(op, np.asarray(gallery.poisson3(n, n, n)))
    b = np.asarray(gallery.poisson3_rhs(n, n, n))
    slv = capi.bmg3_solver_create(op, {"log": [],
                                       "solver": {"tol": 1e-9,
                                                  "max-iter": 30}})
    x = np.zeros((n, n, n))
    capi.bmg3_solver_run(slv, x, b)
    err = np.abs(x - np.asarray(gallery.poisson3_solution(n, n, n))).max()
    assert err < 2e-2
    capi.bmg3_solver_destroy(slv)
