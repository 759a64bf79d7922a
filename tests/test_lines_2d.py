"""Zebra line relaxation tests (reference: test/2d/test_poisson.cc:94-159,
BMG2_SymStd_relax_lines_{x,y}.f90).

Property tests: after a colored line sweep, every line of that color exactly
satisfies its tridiagonal equation given the frozen neighbor rows (the
reference solves each line directly with DPTTRF/DPTTRS).  Convergence tests:
anisotropic problems on stretched grids, which point relaxation cannot solve
efficiently, must converge with the matching line relaxation — the same
configurations as the reference's 800x200 / 200x800 gates (scaled down).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cedar_jax import FivePt, Solver2, gallery
from cedar_jax.config import Config
from cedar_jax.core.types import Dir2, StencilKind
from cedar_jax.ops.lines2 import line_relax_x, line_relax_y, setup_lines
from cedar_jax.ops.stencil2 import residual
from cedar_jax.core.shift import shift2


def _poisson_like(nx, ny, dx=1.0, dy=1.0):
    return gallery.diag_diffusion(nx, ny, dx, dy)


@pytest.mark.parametrize("nx,ny", [(12, 9), (9, 12)])
def test_line_x_solves_lines_exactly(nx, ny):
    so = _poisson_like(nx, ny)
    sor = setup_lines(so, StencilKind.five_pt, "x")
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((nx, ny)))
    b = jnp.asarray(rng.standard_normal((nx, ny)))
    q1 = line_relax_x(so, q, b, sor, StencilKind.five_pt, "down")
    # after the sweep each row j satisfies:
    #   O*q - W*q_w - E*q_e = b + S*q_below + N*q_above  (with final q)
    lhs = (
        so[Dir2.O] * q1
        - so[Dir2.W] * shift2(q1, -1, 0)
        - shift2(so[Dir2.W], 1, 0) * shift2(q1, 1, 0)
    )
    rhs = (
        b
        + so[Dir2.S] * shift2(q1, 0, -1)
        + shift2(so[Dir2.S], 0, 1) * shift2(q1, 0, 1)
    )
    # black lines (even interior rows) were relaxed last against the final
    # red rows, so they hold exactly; red rows were relaxed against the OLD
    # black rows, so only check the final color.
    np.testing.assert_allclose(
        np.asarray(lhs)[:, 0::2], np.asarray(rhs)[:, 0::2], atol=1e-12
    )


def test_line_y_matches_transposed_line_x():
    nx, ny = 10, 13
    so = _poisson_like(nx, ny, 2.0, 0.5)
    sor_y = setup_lines(so, StencilKind.five_pt, "y")
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.standard_normal((nx, ny)))
    b = jnp.asarray(rng.standard_normal((nx, ny)))
    q1 = line_relax_y(so, q, b, sor_y, StencilKind.five_pt, "down")
    lhs = (
        so[Dir2.O] * q1
        - so[Dir2.S] * shift2(q1, 0, -1)
        - shift2(so[Dir2.S], 0, 1) * shift2(q1, 0, 1)
    )
    rhs = (
        b
        + so[Dir2.W] * shift2(q1, -1, 0)
        + shift2(so[Dir2.W], 1, 0) * shift2(q1, 1, 0)
    )
    np.testing.assert_allclose(
        np.asarray(lhs)[0::2, :], np.asarray(rhs)[0::2, :], atol=1e-12
    )


def _stretched_poisson(nx, ny):
    """Poisson on a stretched grid == anisotropic coefficients.

    The reference's line-relax gates use 800x200 and 200x800 grids on the
    unit square (test/2d/test_poisson.cc:94-159); the hx/hy scaling makes
    the x- (resp. y-) coupling dominate.
    """
    return gallery.poisson(nx, ny)


def test_anisotropic_line_x():
    """Strong x-coupling (nx >> ny) needs x-line relaxation."""
    nx, ny = 200, 50
    so = _stretched_poisson(nx, ny)
    b = gallery.poisson_rhs(nx, ny)
    conf = Config({
        "log": [],
        "solver": {"relaxation": "line-x", "tol": 1e-9, "max-iter": 30},
    })
    s = Solver2(so, FivePt, conf)
    x = s.solve(b)
    r = residual(so, x, b, FivePt)
    assert float(jnp.sqrt(jnp.sum(r * r))) < 1e-8
    err = jnp.max(jnp.abs(x - gallery.poisson_solution(nx, ny)))
    # discretization error at ny=50 is O(h²) ≈ 7e-4 (the reference's 1e-4
    # gate is for its larger 800x200 grid)
    assert float(err) < 1e-3
    assert len(s.history) <= 15  # line relax must keep textbook rates


def test_anisotropic_line_y():
    nx, ny = 50, 200
    so = _stretched_poisson(nx, ny)
    b = gallery.poisson_rhs(nx, ny)
    conf = Config({
        "log": [],
        "solver": {"relaxation": "line-y", "tol": 1e-9, "max-iter": 30},
    })
    s = Solver2(so, FivePt, conf)
    x = s.solve(b)
    r = residual(so, x, b, FivePt)
    assert float(jnp.sqrt(jnp.sum(r * r))) < 1e-8
    err = jnp.max(jnp.abs(x - gallery.poisson_solution(nx, ny)))
    assert float(err) < 1e-3
    assert len(s.history) <= 15


def test_line_xy_on_variable_anisotropy():
    """line-xy handles anisotropy in either direction."""
    nx = ny = 64
    so = gallery.diag_diffusion(nx, ny, 100.0, 1.0)
    b = gallery.poisson_rhs(nx, ny)
    conf = Config({
        "log": [],
        "solver": {"relaxation": "line-xy", "tol": 1e-9, "max-iter": 30},
    })
    s = Solver2(so, FivePt, conf)
    x = s.solve(b)
    r = residual(so, x, b, FivePt)
    rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b * b)))
    assert rel < 1e-9
    assert len(s.history) <= 15


def test_pcr_matches_thomas():
    """The PCR path (long lines) must agree with the sequential Thomas
    factorization to roundoff."""
    import cedar_jax.ops.lines2 as L

    rng = np.random.default_rng(11)
    n, m = 128, 24
    dg = jnp.asarray(rng.uniform(2.5, 3.5, (n, m)))
    lo_np = np.concatenate(
        [np.zeros((1, m)), rng.uniform(0.5, 1.0, (n - 1, m))]
    )
    lo = jnp.asarray(lo_np)
    up = L._shift0(lo, 1, 0.0)
    d = jnp.asarray(rng.standard_normal((n, m)))
    x_pcr = L._pcr_solve(lo, dg, up, d)

    # Thomas via the stored-stencil factorization: so[W] = -lo, so[O] = dg
    so = jnp.stack([dg, -lo, jnp.zeros_like(dg)])
    sor = L.setup_lines(so, StencilKind.five_pt, "x")
    x_thomas = L._tridiag_solve(sor, d)
    np.testing.assert_allclose(
        np.asarray(x_pcr), np.asarray(x_thomas), atol=1e-11
    )


def test_spike_matches_pcr_sweep():
    """The cached interface-reduction (SPIKE) path must reproduce the PCR
    sweep to roundoff — whole zebra sweeps, both axes, odd shapes."""
    import cedar_jax.ops.lines2 as L

    rng = np.random.default_rng(5)
    nx, ny = 129, 97
    so = gallery.diag_diffusion(nx, ny, 1.0, 1e-2)
    b = jnp.asarray(rng.standard_normal((nx, ny)))
    q0 = jnp.asarray(rng.standard_normal((nx, ny)))

    sor_ldl_x = L.setup_lines(so, StencilKind.five_pt, "x")
    sor_ldl_y = L.setup_lines(so, StencilKind.five_pt, "y")
    spike_x = L.setup_lines_spike(so, StencilKind.five_pt, "x")
    spike_y = L.setup_lines_spike(so, StencilKind.five_pt, "y")
    assert isinstance(spike_x, L.SpikeLines)

    for updown in ("down", "up"):
        a = L.line_relax_x(so, q0, b, sor_ldl_x, StencilKind.five_pt,
                           updown)
        s = L.line_relax_x(so, q0, b, spike_x, StencilKind.five_pt, updown)
        np.testing.assert_allclose(np.asarray(a), np.asarray(s), atol=1e-11)
        a = L.line_relax_y(so, q0, b, sor_ldl_y, StencilKind.five_pt,
                           updown)
        s = L.line_relax_y(so, q0, b, spike_y, StencilKind.five_pt, updown)
        np.testing.assert_allclose(np.asarray(a), np.asarray(s), atol=1e-11)


def test_ml_relax_knob_selects_log_depth_algorithm():
    """solver.ml-relax.enabled switches long-line solves to the log-depth
    (PCR) algorithm — the reference's "n-level" line relax analogue
    (include/cedar/2d/mpi/ml_relax.h) — with identical results."""
    nx = ny = 96
    so = gallery.diag_diffusion(nx, ny, 100.0, 1.0)
    b = gallery.poisson_rhs(nx, ny)
    base = {
        "log": [],
        "solver": {"relaxation": "line-xy", "tol": 1e-9, "max-iter": 30},
    }
    s0 = Solver2(so, FivePt, Config(base))
    ml = dict(base)
    ml["solver"] = dict(base["solver"])
    ml["solver"]["ml-relax"] = {
        "enabled": True, "min-gsz": 3, "factorize": False,
    }
    s1 = Solver2(so, FivePt, Config(ml))
    from cedar_jax.ops import lines2
    assert isinstance(s0.levels[0].sor_x, lines2.SpikeLines)
    assert not isinstance(s1.levels[0].sor_x, lines2.SpikeLines)
    x0 = s0.solve(b)
    x1 = s1.solve(b)
    np.testing.assert_allclose(np.asarray(x0), np.asarray(x1), atol=1e-9)
