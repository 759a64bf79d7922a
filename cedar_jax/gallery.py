"""Problem galleries (reference: src/2d/gallery.cc, src/3d/gallery.cc).

All builders return interior-only stencil arrays with the h²-scaled finite
difference / finite element coefficients the reference uses:

* 2D Poisson 5-point on the unit square with Dirichlet boundaries eliminated:
  h = 1/(n+1), stencil scaled by hx·hy (gallery.cc:7-39).
* 2D anisotropic `diag_diffusion` (gallery.cc:42-73).
* 2D 9-point finite element `fe` (gallery.cc:77-110).
* 3D analogues (src/3d/gallery.cc): 7-point Poisson and 27-point fe.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cedar_jax.core.types import Dir2, Dir3


def _default_dtype(dtype):
    return jnp.float64 if dtype is None else dtype


# ---------------------------------------------------------------------------
# 2D
# ---------------------------------------------------------------------------

def poisson(nx: int, ny: int, dtype=None) -> jnp.ndarray:
    """5-point Poisson, h²-scaled (reference: 2d/gallery.cc:7-39)."""
    return diag_diffusion(nx, ny, 1.0, 1.0, dtype)


def diag_diffusion(
    nx: int, ny: int, dx: float, dy: float, dtype=None
) -> jnp.ndarray:
    """Anisotropic diffusion -(dx u_xx + dy u_yy) (2d/gallery.cc:42-73)."""
    dtype = _default_dtype(dtype)
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    xh = hy / hx
    yh = hx / hy
    so = np.zeros((3, nx, ny))
    so[Dir2.S, :, 1:] = dy * yh
    so[Dir2.W, 1:, :] = dx * xh
    so[Dir2.O] = 2 * dx * xh + 2 * dy * yh
    return jnp.asarray(so, dtype)


def fe(nx: int, ny: int, dtype=None) -> jnp.ndarray:
    """9-point finite-element Laplacian (reference: 2d/gallery.cc:77-110)."""
    dtype = _default_dtype(dtype)
    so = np.zeros((5, nx, ny))
    so[Dir2.S, :, 1:] = 1.0
    so[Dir2.W, 1:, :] = 1.0
    so[Dir2.SW, 1:, 1:] = 1.0
    so[Dir2.NW, 1:, 1:] = 1.0
    so[Dir2.O] = 8.0
    return jnp.asarray(so, dtype)


def poisson_rhs(nx: int, ny: int, dtype=None) -> jnp.ndarray:
    """RHS 8π²·sin(2πx)sin(2πy)·hx·hy (examples/basic-2d-ser/poisson.cc)."""
    dtype = _default_dtype(dtype)
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    x = (np.arange(nx) + 1) * hx
    y = (np.arange(ny) + 1) * hy
    xx, yy = np.meshgrid(x, y, indexing="ij")
    b = 8 * np.pi**2 * np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy)
    return jnp.asarray(b * hx * hy, dtype)


def poisson_solution(nx: int, ny: int, dtype=None) -> jnp.ndarray:
    """Exact solution sin(2πx)sin(2πy) at interior points."""
    dtype = _default_dtype(dtype)
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    x = (np.arange(nx) + 1) * hx
    y = (np.arange(ny) + 1) * hy
    xx, yy = np.meshgrid(x, y, indexing="ij")
    return jnp.asarray(np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy), dtype)


# ---------------------------------------------------------------------------
# 3D
# ---------------------------------------------------------------------------

def poisson3(nx: int, ny: int, nz: int, dtype=None) -> jnp.ndarray:
    """7-point Poisson, h²-scaled (reference: 3d/gallery.cc)."""
    return diag_diffusion3(nx, ny, nz, 1.0, 1.0, 1.0, dtype)


def diag_diffusion3(
    nx: int, ny: int, nz: int, dx: float, dy: float, dz: float, dtype=None
) -> jnp.ndarray:
    """Anisotropic diffusion -(dx u_xx + dy u_yy + dz u_zz)
    (reference: 3d/gallery.cc diag_diffusion)."""
    dtype = _default_dtype(dtype)
    hx = 1.0 / (nx + 1)
    hy = 1.0 / (ny + 1)
    hz = 1.0 / (nz + 1)
    xh = hy * hz / hx
    yh = hx * hz / hy
    zh = hx * hy / hz
    so = np.zeros((4, nx, ny, nz))
    so[Dir3.PW, 1:, :, :] = dx * xh
    so[Dir3.PS, :, 1:, :] = dy * yh
    so[Dir3.B, :, :, 1:] = dz * zh
    so[Dir3.P] = 2 * (dx * xh + dy * yh + dz * zh)
    return jnp.asarray(so, dtype)


def poisson3_rhs(nx: int, ny: int, nz: int, dtype=None) -> jnp.ndarray:
    """RHS 12π²·sin(2πx)sin(2πy)sin(2πz)·hx·hy·hz (examples/basic-3d-*)."""
    dtype = _default_dtype(dtype)
    hs = [1.0 / (n + 1) for n in (nx, ny, nz)]
    grids = [
        (np.arange(n) + 1) * h for n, h in zip((nx, ny, nz), hs)
    ]
    xx, yy, zz = np.meshgrid(*grids, indexing="ij")
    b = (
        12
        * np.pi**2
        * np.sin(2 * np.pi * xx)
        * np.sin(2 * np.pi * yy)
        * np.sin(2 * np.pi * zz)
    )
    return jnp.asarray(b * hs[0] * hs[1] * hs[2], dtype)


def poisson3_solution(nx: int, ny: int, nz: int, dtype=None) -> jnp.ndarray:
    dtype = _default_dtype(dtype)
    hs = [1.0 / (n + 1) for n in (nx, ny, nz)]
    grids = [
        (np.arange(n) + 1) * h for n, h in zip((nx, ny, nz), hs)
    ]
    xx, yy, zz = np.meshgrid(*grids, indexing="ij")
    return jnp.asarray(
        np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy) * np.sin(2 * np.pi * zz),
        dtype,
    )


def fe3(nx: int, ny: int, nz: int, dtype=None) -> jnp.ndarray:
    """27-point finite-element operator (reference: 3d/gallery.cc fe)."""
    dtype = _default_dtype(dtype)
    so = np.zeros((14, nx, ny, nz))
    # same-plane couplings
    so[Dir3.PW, 1:, :, :] = 1.0
    so[Dir3.PS, :, 1:, :] = 1.0
    so[Dir3.PSW, 1:, 1:, :] = 1.0
    so[Dir3.PNW, 1:, 1:, :] = 1.0
    # below-plane couplings
    so[Dir3.B, :, :, 1:] = 1.0
    so[Dir3.BW, 1:, :, 1:] = 1.0
    so[Dir3.BE, 1:, :, 1:] = 1.0
    so[Dir3.BS, :, 1:, 1:] = 1.0
    so[Dir3.BN, :, 1:, 1:] = 1.0
    so[Dir3.BSW, 1:, 1:, 1:] = 1.0
    so[Dir3.BNW, 1:, 1:, 1:] = 1.0
    so[Dir3.BNE, 1:, 1:, 1:] = 1.0
    so[Dir3.BSE, 1:, 1:, 1:] = 1.0
    so[Dir3.P] = 26.0
    return jnp.asarray(so, dtype)
