"""3D Poisson convergence tests.

Mirrors the reference's 3D integration test (test/3d/test_poisson.cc:74-105:
200³ 7-point Poisson, ‖res‖₂ < 1e-8 and ‖x − x*‖∞ < 1e-4) at CI-friendly
sizes — the convergence-factor gate is size-independent, the error gate is
scaled to the h² discretization error of the smaller grid.
"""

import jax.numpy as jnp

from cedar_jax import SevenPt, TwentySevenPt, Solver3, gallery
from cedar_jax.config import Config
from cedar_jax.ops.stencil3 import residual


def test_poisson3_point_relax():
    n = 32
    so = gallery.poisson3(n, n, n)
    b = gallery.poisson3_rhs(n, n, n)
    conf = Config({"log": [], "solver": {"tol": 1e-9, "max-iter": 30}})
    s = Solver3(so, SevenPt, conf)
    x = s.solve(b)
    r = residual(so, x, b, SevenPt)
    assert float(jnp.sqrt(jnp.sum(r * r))) < 1e-8
    err = float(jnp.max(jnp.abs(x - gallery.poisson3_solution(n, n, n))))
    assert err < 5e-3  # h² discretization error at n=32
    # BoxMG-quality convergence: ~0.1 per V(2,1) cycle on Poisson
    assert len(s.history) <= 12


def test_poisson3_irregular_sizes():
    for nx, ny, nz in [(21, 13, 17), (12, 22, 15)]:
        so = gallery.poisson3(nx, ny, nz)
        b = gallery.poisson3_rhs(nx, ny, nz)
        conf = Config({"log": [], "solver": {"tol": 1e-9, "max-iter": 30}})
        s = Solver3(so, SevenPt, conf)
        x = s.solve(b)
        r = residual(so, x, b, SevenPt)
        rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b * b)))
        assert rel < 1e-9


def test_fe3_twenty_seven_point():
    n = 16
    so = gallery.fe3(n, n, n)
    b = gallery.poisson3_rhs(n, n, n)
    conf = Config({"log": [], "solver": {"tol": 1e-9, "max-iter": 30}})
    s = Solver3(so, TwentySevenPt, conf)
    x = s.solve(b)
    r = residual(so, x, b, TwentySevenPt)
    rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b * b)))
    assert rel < 1e-9
    assert len(s.history) <= 12


def test_fcycle3():
    n = 32
    so = gallery.poisson3(n, n, n)
    b = gallery.poisson3_rhs(n, n, n)
    conf = Config({
        "log": [],
        "solver": {"cycle": {"type": "f"}, "tol": 1e-8, "max-iter": 8},
    })
    s = Solver3(so, SevenPt, conf)
    x = s.solve(b)
    err = float(jnp.max(jnp.abs(x - gallery.poisson3_solution(n, n, n))))
    assert err < 6e-3
