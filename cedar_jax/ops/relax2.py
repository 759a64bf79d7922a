"""2D multicolor Gauss-Seidel point relaxation.

A data-parallel reformulation of BMG2_SymStd_relax_GS.f90: instead of a sequential
sweep over one color's points, each color phase is a dense masked update
``q <- where(mask_c, (b + offdiag·q) * recip, q)`` — every point of a color is
independent (that is the entire purpose of multicolor ordering), so the phase
is a single fused elementwise pass.  (The fused GPU kernel in
:mod:`cedar_jax.ops.pallas2` runs all phases in one pass; this is its
reference.)

Color semantics match the reference exactly:

* 5-point: red-black by parity of ``z + w`` (Fortran ``MOD(J+JO,2)``,
  BMG2_SymStd_relax_GS.f90:120-135).  DOWN order: even parity then odd;
  UP (symmetric postsmoothing) reversed (``LSTART/LEND/LSTRIDE``, :78-87).
* 9-point: four colors by ``(w % 2, z % 2)`` swept in lexicographic order
  (outer JBEG, inner IBEG, :93-114); UP reverses both loops.

Colors are anchored to GLOBAL indices — in the reference's MPI variant the
phase is ``iGs/jGs mod 2`` (src/2d/ftn/mpi/BMG2_SymStd_relax_GS.f90:95-99) so
all ranks sweep the same global color; here arrays are logically global, so
``broadcasted_iota`` gives that anchoring for free under any sharding.

The relaxation "setup" is the diagonal reciprocal (SOR(MSOR) = 1/diag,
BMG2_SymStd_SETUP_recip.f90).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cedar_jax.core.types import Dir2, StencilKind
from cedar_jax.ops.stencil2 import offdiag_apply


def setup_recip(so: jnp.ndarray) -> jnp.ndarray:
    """1/diag (reference: BMG2_SymStd_SETUP_recip.f90)."""
    return 1.0 / so[Dir2.O]


def _parity_masks(shape, dtype):
    z = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    w = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    return z % 2, w % 2


def color_masks(shape, kind: StencilKind, updown: str):
    """Boolean masks for each color phase, in reference sweep order."""
    zp, wp = _parity_masks(shape, jnp.int32)
    masks = []
    if kind == StencilKind.five_pt:
        s = (zp + wp) % 2
        order = (0, 1) if updown == "down" else (1, 0)
        for c in order:
            masks.append(s == c)
    else:
        order = (
            [(0, 0), (0, 1), (1, 0), (1, 1)]
            if updown == "down"
            else [(1, 1), (1, 0), (0, 1), (0, 0)]
        )
        for cw, cz in order:
            masks.append((wp == cw) & (zp == cz))
    return masks


def point_relax(
    so: jnp.ndarray,
    q: jnp.ndarray,
    b: jnp.ndarray,
    recip: jnp.ndarray,
    kind: StencilKind,
    updown: str,
    periodic=(False, False),
) -> jnp.ndarray:
    """One multicolor GS sweep (all colors), DOWN or UP ordering.

    Color phases run as a `lax.scan` over the stacked masks so the compiled
    graph holds one masked update, not 2/4 inlined copies.
    """
    masks = jnp.stack(color_masks(q.shape, kind, updown))

    def body(q, mask):
        upd = (b + offdiag_apply(so, q, kind, periodic)) * recip
        return jnp.where(mask, upd, q), None

    q, _ = jax.lax.scan(body, q, masks)
    return q
