"""3D stencil application primitives (7/27-point).

3D analogue of :mod:`cedar_jax.ops.stencil2`; replaces
BMG3_SymStd_residual.f90 / BMG3_SymStd_UTILS_matvec.f90.

Symmetric storage (reference: 3d/base_types.h, residual usage in
src/3d/ftn/BMG3_SymStd_residual.f90): plane directions pw/ps/psw/pnw behave
like the 2D w/s/sw/nw within each z-plane; the b* planes couple (x,y,z) to
the 9 points of the plane below (z-1):

  B(i,j,k)    couples (i,j,k)     <-> (i,j,k-1)
  BW(i,j,k)   couples (i,j,k)     <-> (i-1,j,k-1)
  BE(i,j,k)   couples (i-1,j,k)   <-> (i,j,k-1)
  BS(i,j,k)   couples (i,j,k)     <-> (i,j-1,k-1)
  BN(i,j,k)   couples (i,j-1,k)   <-> (i,j,k-1)
  BSW(i,j,k)  couples (i,j,k)     <-> (i-1,j-1,k-1)
  BSE(i,j,k)  couples (i-1,j,k)   <-> (i,j-1,k-1)
  BNW(i,j,k)  couples (i,j-1,k)   <-> (i-1,j,k-1)
  BNE(i,j,k)  couples (i-1,j-1,k) <-> (i,j,k-1)
"""

from __future__ import annotations

from cedar_jax.core.shift import shift3
from cedar_jax.core.types import Dir3, StencilKind

# (dz, dw, dv) -> (plane, shift applied to the plane)
# derived like the 2D table; the "upper" half (dv=+1 and in-plane uppers) are
# shifted reads of the stored lower half.
NEIGHBOR_COUPLINGS_27 = {
    # in-plane (dv = 0), same as 2D
    (-1, 0, 0): (Dir3.PW, (0, 0, 0)),
    (1, 0, 0): (Dir3.PW, (1, 0, 0)),
    (0, -1, 0): (Dir3.PS, (0, 0, 0)),
    (0, 1, 0): (Dir3.PS, (0, 1, 0)),
    (-1, -1, 0): (Dir3.PSW, (0, 0, 0)),
    (1, -1, 0): (Dir3.PNW, (1, 0, 0)),
    (-1, 1, 0): (Dir3.PNW, (0, 1, 0)),
    (1, 1, 0): (Dir3.PSW, (1, 1, 0)),
    # plane below (dv = -1); reads per BMG3_SymStd_residual.f90:80-89:
    #   BW/BS/BSW stored at the row point, BE/BSE at (i+1, ., .),
    #   BN/BNW at (., j+1, .), BNE at (i+1, j+1, .)
    (0, 0, -1): (Dir3.B, (0, 0, 0)),
    (-1, 0, -1): (Dir3.BW, (0, 0, 0)),
    (1, 0, -1): (Dir3.BE, (1, 0, 0)),
    (0, -1, -1): (Dir3.BS, (0, 0, 0)),
    (0, 1, -1): (Dir3.BN, (0, 1, 0)),
    (-1, -1, -1): (Dir3.BSW, (0, 0, 0)),
    (1, -1, -1): (Dir3.BSE, (1, 0, 0)),
    (-1, 1, -1): (Dir3.BNW, (0, 1, 0)),
    (1, 1, -1): (Dir3.BNE, (1, 1, 0)),
    # plane above (dv = +1); per BMG3_SymStd_residual.f90:90-98
    (0, 0, 1): (Dir3.B, (0, 0, 1)),
    (1, 0, 1): (Dir3.BW, (1, 0, 1)),
    (-1, 0, 1): (Dir3.BE, (0, 0, 1)),
    (0, 1, 1): (Dir3.BS, (0, 1, 1)),
    (0, -1, 1): (Dir3.BN, (0, 0, 1)),
    (1, 1, 1): (Dir3.BSW, (1, 1, 1)),
    (-1, 1, 1): (Dir3.BSE, (0, 1, 1)),
    (1, -1, 1): (Dir3.BNW, (1, 0, 1)),
    (-1, -1, 1): (Dir3.BNE, (0, 0, 1)),
}

SEVEN_OFFSETS = [
    (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1),
]


def offsets_for(kind: StencilKind):
    if kind == StencilKind.seven_pt:
        return list(SEVEN_OFFSETS)
    return list(NEIGHBOR_COUPLINGS_27.keys())


def coupling(so, off, periodic=(False, False, False)):
    plane, sh = NEIGHBOR_COUPLINGS_27[off]
    p = so[plane]
    if any(sh):
        p = shift3(p, *sh, periodic=periodic)
    return p


def full_offsets(so, kind: StencilKind, periodic=(False, False, False)):
    out = {(0, 0, 0): so[Dir3.P]}
    for off in offsets_for(kind):
        out[off] = -coupling(so, off, periodic)
    return out


def offdiag_apply(so, q, kind: StencilKind, periodic=(False, False, False)):
    acc = None
    for off in offsets_for(kind):
        term = coupling(so, off, periodic) * shift3(q, *off, periodic=periodic)
        acc = term if acc is None else acc + term
    return acc


def matvec(so, q, kind: StencilKind, periodic=(False, False, False)):
    return so[Dir3.P] * q - offdiag_apply(so, q, kind, periodic)


def residual(so, q, b, kind: StencilKind, periodic=(False, False, False)):
    return b + offdiag_apply(so, q, kind, periodic) - so[Dir3.P] * q
