"""2D stencil application primitives: matvec, residual, full-offset views.

Replaces the reference's Fortran kernels BMG2_SymStd_residual.f90:85-119 and
BMG2_SymStd_UTILS_matvec.f90 with shifted-window jnp expressions; XLA fuses
the 9 shifted reads into a single pass over the grid.

Sign convention (reference residual loop): off-diagonals are stored positive
so ``(A q)(z,w) = O·q - Σ_offdiag so_d·q_neighbor`` and
``res = b - A q = b + Σ offdiag·q_nb - O·q``.
"""

from __future__ import annotations

import jax.numpy as jnp

from cedar_jax.core.shift import shift2
from cedar_jax.core.types import Dir2, StencilKind

# The 8 neighbor offsets of the full 2D stencil, with the symmetric-storage
# plane and the shift applied to that plane to place the coupling at the row
# point.  Entry: (dz, dw) -> (plane, plane_shift_z, plane_shift_w)
# Derivation (see BMG2_SymStd_residual.f90:91-100, with Fortran (I,J) -> our
# (z,w)):
#   coupling to (z-1,w)   = W(z,w)
#   coupling to (z+1,w)   = W(z+1,w)        = shift(W, +1, 0)
#   coupling to (z,w-1)   = S(z,w)
#   coupling to (z,w+1)   = S(z,w+1)        = shift(S, 0, +1)
#   coupling to (z-1,w-1) = SW(z,w)
#   coupling to (z+1,w-1) = NW(z+1,w)       = shift(NW, +1, 0)
#   coupling to (z-1,w+1) = NW(z,w+1)       = shift(NW, 0, +1)
#   coupling to (z+1,w+1) = SW(z+1,w+1)     = shift(SW, +1, +1)
NEIGHBOR_COUPLINGS = {
    (-1, 0): (Dir2.W, 0, 0),
    (1, 0): (Dir2.W, 1, 0),
    (0, -1): (Dir2.S, 0, 0),
    (0, 1): (Dir2.S, 0, 1),
    (-1, -1): (Dir2.SW, 0, 0),
    (1, -1): (Dir2.NW, 1, 0),
    (-1, 1): (Dir2.NW, 0, 1),
    (1, 1): (Dir2.SW, 1, 1),
}


def offsets_for(kind: StencilKind):
    if kind == StencilKind.five_pt:
        return [(-1, 0), (1, 0), (0, -1), (0, 1)]
    return list(NEIGHBOR_COUPLINGS.keys())


def coupling(so: jnp.ndarray, off, periodic=(False, False)) -> jnp.ndarray:
    """Positive coupling magnitude of each point to its ``off`` neighbor."""
    plane, sz, sw = NEIGHBOR_COUPLINGS[off]
    p = so[plane]
    if sz or sw:
        p = shift2(p, sz, sw, periodic)
    return p


def full_offsets(so: jnp.ndarray, kind: StencilKind, periodic=(False, False)):
    """Row-form full stencil: dict ``(dz,dw) -> A[(z,w),(z+dz,w+dw)]``.

    Off-diagonal entries carry their TRUE (negative of stored) sign;
    the center entry is ``+O``.
    """
    out = {(0, 0): so[Dir2.O]}
    for off in offsets_for(kind):
        out[off] = -coupling(so, off, periodic)
    return out


def offdiag_apply(
    so: jnp.ndarray, q: jnp.ndarray, kind: StencilKind, periodic=(False, False)
) -> jnp.ndarray:
    """``Σ_offdiag so_d(z,w) · q(neighbor)`` with positive-stored couplings."""
    acc = None
    for off in offsets_for(kind):
        term = coupling(so, off, periodic) * shift2(q, off[0], off[1], periodic)
        acc = term if acc is None else acc + term
    return acc


def matvec(
    so: jnp.ndarray, q: jnp.ndarray, kind: StencilKind, periodic=(False, False)
) -> jnp.ndarray:
    """``A q`` (reference: BMG2_SymStd_UTILS_matvec.f90)."""
    return so[Dir2.O] * q - offdiag_apply(so, q, kind, periodic)


def residual(
    so: jnp.ndarray,
    q: jnp.ndarray,
    b: jnp.ndarray,
    kind: StencilKind,
    periodic=(False, False),
) -> jnp.ndarray:
    """``b - A q`` (reference: BMG2_SymStd_residual.f90:85-119)."""
    return b + offdiag_apply(so, q, kind, periodic) - so[Dir2.O] * q
