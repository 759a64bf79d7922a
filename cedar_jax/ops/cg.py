"""Coarsest-grid direct solve.

The reference copies the coarsest stencil into a banded matrix and factors
it with LAPACK DPBTRF (banded Cholesky), solving with DPBTRS each cycle
(BMG2_SymStd_SETUP_cg_LU.f90:116-144, BMG2_SymStd_SOLVE_cg.f90:104-107).

The coarsest grid is tiny (min_coarse=3 ⇒ typically ≤ 7×7 ⇒ N ≤ 49), so we
assemble the DENSE coarse matrix once at setup, invert it via Cholesky, and
apply the inverse as a single small matrix-vector product inside the jitted
cycle — no host round-trip and no sequential triangular solves on device.
The product runs at full precision: a GPU may otherwise take a float32
matmul in TF32, whose ~3 decimal digits would cap the cycle's accuracy.
For indefinite problems (fully periodic), the reference adds the
last diagonal entry once more as a rank-deficiency shift and subtracts the
mean of the solution (SOLVE_cg.f90:124-141); we mirror both.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from cedar_jax.core.types import StencilKind


def _full_offsets(so, kind: StencilKind, periodic):
    if kind.ndim == 2:
        from cedar_jax.ops.stencil2 import full_offsets

        return full_offsets(so, kind, periodic)
    from cedar_jax.ops.stencil3 import full_offsets

    return full_offsets(so, kind, periodic)


def assemble_dense(so, kind: StencilKind, periodic) -> jnp.ndarray:
    """Dense row-form matrix of the operator, x-fastest ordering.

    Mirrors the reference's banded copy (SETUP_cg_LU.f90:116-144) but dense;
    the unknown ordering (x fastest, then y, then z) matches its KK loop.
    """
    af = _full_offsets(so, kind, periodic)
    nshape = so.shape[1:]
    n = int(np.prod(nshape))
    dims = len(nshape)

    strides = [1]
    for d in range(1, dims):
        strides.append(strides[-1] * nshape[d - 1])

    idx_grids = np.indices(nshape)  # (dims, *nshape)
    flat = sum(idx_grids[d] * strides[d] for d in range(dims)).reshape(-1)

    mat = jnp.zeros((n, n), so.dtype)
    for off, field in af.items():
        nb_flat = np.zeros(nshape, np.int64)
        valid = np.ones(nshape, bool)
        for d in range(dims):
            nb_d = idx_grids[d] + off[d]
            if periodic[d]:
                nb_d = nb_d % nshape[d]
            else:
                valid &= (nb_d >= 0) & (nb_d < nshape[d])
                nb_d = np.clip(nb_d, 0, nshape[d] - 1)
            nb_flat += nb_d * strides[d]
        col = nb_flat.reshape(-1)
        vals = jnp.where(
            jnp.asarray(valid.reshape(-1)), field.reshape(-1), 0.0
        )
        mat = mat.at[flat, col].add(vals)
    return mat


def setup_cg_lu(
    so: jnp.ndarray,
    kind: StencilKind,
    periodic=(False, False),
    indefinite: bool = False,
) -> jnp.ndarray:
    """Assemble, (shift,) and invert the coarse operator.  Returns A⁻¹."""
    mat = assemble_dense(so, kind, periodic)
    if indefinite:
        # reference: ABD(last,last) += SO(coarse last interior, KO)
        n = mat.shape[0]
        mat = mat.at[n - 1, n - 1].add(so[0].reshape(-1)[-1])
    chol = jnp.linalg.cholesky(mat)
    eye = jnp.eye(mat.shape[0], dtype=mat.dtype)
    y = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
    return jax.scipy.linalg.solve_triangular(chol.T, y, lower=False)


def solve_cg(
    ainv: jnp.ndarray,
    b: jnp.ndarray,
    subtract_mean: bool = False,
) -> jnp.ndarray:
    """x = A⁻¹ b on the coarsest grid (any dimension; x-fastest flattening)."""
    shape = b.shape
    axes = tuple(reversed(range(b.ndim)))  # make x fastest when flattened
    flat = b.transpose(axes).reshape(-1)
    x = jnp.matmul(ainv, flat, precision=jax.lax.Precision.HIGHEST)
    x = x.reshape(tuple(reversed(shape))).transpose(axes)
    if subtract_mean:
        x = x - jnp.mean(x)
    return x
