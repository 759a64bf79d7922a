"""Per-level data container (reference: include/cedar/level.h:14-45).

A Level holds the stencil operator, interpolation weights from this level's
coarse grid (``ci`` lives on the COARSER level in the reference's level
container; here we attach to the coarser level likewise: ``levels[l+1].ci``
interpolates level ``l+1`` -> ``l``), relaxation workspace, and — on the
coarsest level only — the inverted coarse operator.

Represented as a NamedTuple so the whole hierarchy is a static-shape pytree
that flows through one jit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp


class Level(NamedTuple):
    so: jnp.ndarray                    # (ndir, nx, ny[, nz]) stencil operator
    recip: Optional[jnp.ndarray] = None      # 1/diag (point relax)
    ci: Optional[jnp.ndarray] = None          # interp weights to the finer level
    sor_x: Optional[jnp.ndarray] = None       # line-relax x factorization
    sor_y: Optional[jnp.ndarray] = None       # line-relax y factorization
    ainv: Optional[jnp.ndarray] = None        # coarsest: dense inverse
    planes: Optional[dict] = None             # 3D: orient -> batched 2D
    #                                           plane hierarchy (plane relax)
    inner: Optional[tuple] = None             # coarsest: inner multigrid
    #                                  hierarchy (cg-solver "cedar"/"redist")
