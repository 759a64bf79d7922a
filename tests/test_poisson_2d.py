"""2D Poisson convergence tests.

Mirrors the reference's integration tests (test/2d/test_poisson.cc:64-159):
full solve with final ‖res‖₂ < 1e-8·‖b‖ and ‖x − x*‖∞ < 1e-4 gates, plus the
exact README residual history (README.md:49-63, BASELINE.md).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cedar_jax import FivePt, NinePt, Solver2, gallery
from cedar_jax.config import Config
from cedar_jax.ops.stencil2 import residual

# Published per-iteration relative l2 norms (reference README.md:51-61),
# produced by a 7-level hierarchy on the 400x400 problem with V(1,1).
CEDAR_HISTORY = [
    0.388629, 0.0443548, 0.00494131, 0.000513399, 5.44908e-05,
    5.60612e-06, 5.86933e-07, 6.04942e-08, 6.30975e-09, 6.52713e-10,
]


def _solve_poisson(nx, ny, conf):
    so = gallery.poisson(nx, ny)
    b = gallery.poisson_rhs(nx, ny)
    s = Solver2(so, FivePt, conf)
    x = s.solve(b)
    return s, so, b, x


def test_poisson_200_point_relax():
    """Reference gate: test/2d/test_poisson.cc:82-92 (200x200, point)."""
    conf = Config({"log": [], "solver": {"tol": 1e-9, "max-iter": 30}})
    s, so, b, x = _solve_poisson(200, 200, conf)
    r = residual(so, x, b, FivePt)
    assert float(jnp.sqrt(jnp.sum(r * r))) < 1e-8
    err = jnp.max(jnp.abs(x - gallery.poisson_solution(200, 200)))
    assert float(err) < 1e-4


def test_poisson_matches_cedar_history_exactly():
    """Match the published residual history digit-for-digit (BASELINE.md)."""
    conf = Config({
        "log": [],
        "solver": {
            "num-levels": 7,
            "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
            "tol": 1e-10,
            "max-iter": 10,
        },
    })
    s, so, b, x = _solve_poisson(400, 400, conf)
    assert len(s.history) == 10
    np.testing.assert_allclose(s.history, CEDAR_HISTORY, rtol=2e-5)
    err = float(jnp.max(jnp.abs(x - gallery.poisson_solution(400, 400))))
    # README.md:62 "Solution norm: 2.04592e-05"
    np.testing.assert_allclose(err, 2.04592e-05, rtol=1e-4)


def test_poisson_irregular_sizes():
    """Odd / non-square sizes exercise parity handling at every level."""
    for nx, ny in [(125, 93), (96, 130)]:
        conf = Config({"log": [], "solver": {"tol": 1e-9, "max-iter": 30}})
        s, so, b, x = _solve_poisson(nx, ny, conf)
        r = residual(so, x, b, FivePt)
        rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b * b)))
        assert rel < 1e-9


def test_fe_nine_point():
    """9-point fine-grid operator path (gallery fe)."""
    nx = ny = 64
    so = gallery.fe(nx, ny)
    b = gallery.poisson_rhs(nx, ny)
    conf = Config({"log": [], "solver": {"tol": 1e-9, "max-iter": 30}})
    s = Solver2(so, NinePt, conf)
    x = s.solve(b)
    r = residual(so, x, b, NinePt)
    rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b * b)))
    assert rel < 1e-9
    # BoxMG should converge fast (~0.1/cycle) on this operator
    assert len(s.history) <= 12


def test_fcycle():
    """F-cycle (FMG) reaches discretization accuracy in one visit."""
    nx = ny = 128
    conf = Config({
        "log": [],
        "solver": {"cycle": {"type": "f"}, "tol": 1e-8, "max-iter": 8},
    })
    s, so, b, x = _solve_poisson(nx, ny, conf)
    err = float(jnp.max(jnp.abs(x - gallery.poisson_solution(nx, ny))))
    assert err < 1e-3  # discretization-level accuracy after FMG
