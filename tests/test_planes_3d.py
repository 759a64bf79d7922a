"""3D plane relaxation tests.

Mirrors the reference's plane-relaxation oracle strategy
(test/3d/test_planes.cc + pyplanes.pyx: each zebra plane solved
sparse-directly, SURVEY §4): a numpy/scipy oracle performs the zebra sweep
with EXACT 2D plane solves; the framework sweep with a deep plane-solver
config (many embedded V-cycles) must agree to solver tolerance.  Plus
convergence gates on anisotropic problems where plane relaxation is the
robust smoother.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import oracles3 as orc
from cedar_jax import SevenPt, Solver3, gallery
from cedar_jax.config import Config
from cedar_jax.core.types import Dir3, StencilKind
from cedar_jax.ops.planes3 import (
    PLANE_SPECS,
    plane_kind2,
    plane_relax,
    setup_planes,
    slice_so,
)
from cedar_jax.ops.stencil3 import coupling, offsets_for, residual
from cedar_jax.settings import MLSettings
from test_kernels_3d import random_so

from cedar_jax.ops.stencil2 import full_offsets as full_offsets2


def _sparse2(so2, kind2, nshape):
    af = full_offsets2(jnp.asarray(so2), kind2)
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


def oracle_plane_sweep(so3, kind3, x, b, orient, updown):
    """Zebra plane sweep with EXACT plane solves (scipy spsolve)."""
    axis, _, _ = PLANE_SPECS[orient]
    kind2 = plane_kind2(kind3)
    so2b = np.asarray(slice_so(jnp.asarray(so3), kind3, orient))
    x = np.array(x)
    npl = x.shape[axis]
    order = (0, 1) if updown == "down" else (1, 0)
    for c in order:
        # out-of-plane rhs at current values
        oop = np.zeros_like(x)
        for off in offsets_for(kind3):
            if off[axis] == 0:
                continue
            cpl = np.asarray(coupling(jnp.asarray(so3), off))
            xs = np.asarray(
                jnp.asarray(x)
            )
            # shift x by off with zero fill
            pad = [(max(-o, 0), max(o, 0)) for o in off]
            xp = np.pad(xs, pad)
            sl = tuple(
                slice(pad[d][0] + off[d], pad[d][0] + off[d] + x.shape[d])
                for d in range(3)
            )
            oop += cpl * xp[sl]
        rhs = b + oop
        for ipl in range(c, npl, 2):
            so2 = so2b[ipl]
            n1, n2 = so2.shape[1], so2.shape[2]
            A2 = _sparse2(so2, kind2, (n1, n2))
            b2 = np.take(rhs, ipl, axis=axis).reshape(-1)
            x2 = spla.spsolve(A2.tocsc(), b2)
            idx = [slice(None)] * 3
            idx[axis] = ipl
            x[tuple(idx)] = x2.reshape(n1, n2)
    return x


@pytest.mark.parametrize("orient", ["xy", "yz"])
@pytest.mark.parametrize("updown", ["down", "up"])
def test_plane_relax_vs_exact_oracle(orient, updown):
    """npl is odd for xy (unrolled path) and even for yz (scanned path)."""
    nx, ny, nz = 10, 8, 7
    rng = np.random.default_rng(42)
    so = random_so(rng, nx, ny, nz, True)
    kind3 = StencilKind.twenty_seven_pt
    x0 = rng.standard_normal((nx, ny, nz))
    b = rng.standard_normal((nx, ny, nz))

    # deep embedded solves ≈ exact plane solves
    conf = Config({
        "log": [],
        "solver": {"relaxation": f"plane-{orient}", "max-iter": 5},
        "plane-config": {
            "solver": {"relaxation": "line-xy", "max-iter": 20,
                       "tol": 1e-14},
        },
    })
    settings = MLSettings.from_config(conf)
    from cedar_jax.solver.level import Level
    from cedar_jax.ops.relax3 import setup_recip

    lev = Level(so=jnp.asarray(so), recip=setup_recip(jnp.asarray(so)))
    levels = setup_planes(
        (lev, lev), [kind3, kind3], settings, conf
    )
    xm = plane_relax(
        levels[0], kind3, jnp.asarray(x0), jnp.asarray(b), orient, updown,
        settings,
    )
    xo = oracle_plane_sweep(so, kind3, x0, b, orient, updown)
    np.testing.assert_allclose(np.asarray(xm), xo, atol=5e-11)


def test_plane_xy_anisotropic_convergence():
    """Strong xy-coupling: plane-xy relaxation is the robust smoother
    (reference: test/3d/test_planes.cc strategy)."""
    n = 16
    so = gallery.diag_diffusion3(n, n, n, 1.0, 1.0, 1e-3)
    b = gallery.poisson3_rhs(n, n, n)
    conf = Config({
        "log": [],
        "solver": {"relaxation": "plane-xy", "tol": 1e-9, "max-iter": 20},
    })
    s = Solver3(so, SevenPt, conf)
    x = s.solve(b)
    r = residual(so, x, b, SevenPt)
    rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b * b)))
    assert rel < 1e-9
    assert len(s.history) <= 5  # near-direct on plane-aligned anisotropy


def test_plane_xyz_poisson():
    n = 8
    so = gallery.poisson3(n, n, n)
    b = gallery.poisson3_rhs(n, n, n)
    conf = Config({
        "log": [],
        "solver": {"relaxation": "plane-xyz", "tol": 1e-9, "max-iter": 20},
    })
    s = Solver3(so, SevenPt, conf)
    x = s.solve(b)
    r = residual(so, x, b, SevenPt)
    rel = float(jnp.sqrt(jnp.sum(r * r)) / jnp.sqrt(jnp.sum(b * b)))
    assert rel < 1e-9
    assert len(s.history) <= 6
