"""3D multicolor Gauss-Seidel point relaxation.

A data-parallel reformulation of BMG3_SymStd_relax_GS.f90 (same design as the 2D
version, :mod:`cedar_jax.ops.relax2`): each color phase is one dense masked
update — all points of a color are independent by construction.

Color semantics match the reference exactly
(src/3d/ftn/BMG3_SymStd_relax_GS.f90:85-187):

* 27-point: EIGHT colors indexed ``pts = 1..8`` with interior parities
  ``x: (pts-1) % 2``, ``y: ((pts-1)//2) % 2``, ``z: ((pts-1)//4) % 2``
  (Fortran loop starts ``2 + mod(...)``, and interior Fortran index 2 is our
  global index 0).  UP (and non-symmetric) sweeps colors FORWARD 1..8;
  DOWN sweeps them REVERSED 8..1 (:86-96 — note this is the mirror of the
  2D convention, where DOWN is forward).
* 7-point: red-black on the parity of ``x+y+z`` (``ibeg = mod(j+k+pts,2)+2``,
  :144-152).  UP relaxes parity 0 then 1; DOWN reversed.

Colors are anchored to GLOBAL indices (the MPI variant uses global iGs/jGs/kGs
parity) — ``broadcasted_iota`` over the logically-global array gives exactly
that under any sharding.

Relaxation setup is the diagonal reciprocal (BMG3_SymStd_SETUP_recip.f90).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cedar_jax.core.types import Dir3, StencilKind
from cedar_jax.ops.stencil3 import offdiag_apply


def setup_recip(so: jnp.ndarray) -> jnp.ndarray:
    """1/diag (reference: BMG3_SymStd_SETUP_recip.f90)."""
    return 1.0 / so[Dir3.P]


def color_masks(shape, kind: StencilKind, updown: str):
    """Boolean masks per color phase, in reference sweep order."""
    z = jax.lax.broadcasted_iota(jnp.int32, shape, 0) % 2
    w = jax.lax.broadcasted_iota(jnp.int32, shape, 1) % 2
    v = jax.lax.broadcasted_iota(jnp.int32, shape, 2) % 2
    masks = []
    if kind == StencilKind.seven_pt:
        s = (z + w + v) % 2
        order = (0, 1) if updown == "up" else (1, 0)
        for c in order:
            masks.append(s == c)
    else:
        pts_order = range(1, 9) if updown == "up" else range(8, 0, -1)
        for pts in pts_order:
            cz = (pts - 1) % 2
            cw = ((pts - 1) // 2) % 2
            cv = ((pts - 1) // 4) % 2
            masks.append((z == cz) & (w == cw) & (v == cv))
    return masks


def point_relax(
    so: jnp.ndarray,
    q: jnp.ndarray,
    b: jnp.ndarray,
    recip: jnp.ndarray,
    kind: StencilKind,
    updown: str,
    periodic=(False, False, False),
) -> jnp.ndarray:
    """One multicolor GS sweep (all colors), DOWN or UP ordering.

    The color phases run as a `lax.scan` over the stacked color masks: the
    compiled graph contains ONE masked update instead of eight inlined
    copies (the sweep structure is identical per color; only the mask
    changes), which keeps whole-cycle compile times manageable.
    """
    masks = jnp.stack(color_masks(q.shape, kind, updown))

    def body(q, mask):
        upd = (b + offdiag_apply(so, q, kind, periodic)) * recip
        return jnp.where(mask, upd, q), None

    q, _ = jax.lax.scan(body, q, masks)
    return q
