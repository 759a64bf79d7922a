"""cedar_jax — robust variational multigrid (BoxMG) in JAX, for the GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the Cedar
framework (robust variational multigrid for 2D/3D structured grids):

* stencil operators (2D 5/9-point, 3D 7/27-point) with Cedar's symmetric
  storage convention (center + lower off-diagonals, stored positive),
* operator-induced (BoxMG) interpolation and Galerkin (ITLI) coarsening,
* multicolor point relaxation, zebra line relaxation, 3D plane relaxation,
* V- and F-cycles with a direct (Cholesky) coarse-grid solve,
* multi-device scaling over a `jax.sharding.Mesh` (halo exchange via XLA
  collectives instead of MPI/MSG) and coarse-grid agglomeration onto
  shrinking submeshes.

Unlike the reference (C++/Fortran/MPI — see SURVEY.md), every
numeric kernel here is a pure function over interior-only JAX arrays, and the
entire multilevel cycle is jit-compiled end-to-end.
"""

from cedar_jax.config import Config
from cedar_jax.settings import MLSettings
from cedar_jax.core.types import FivePt, NinePt, SevenPt, TwentySevenPt
from cedar_jax.solver.solver2 import Solver2
from cedar_jax.solver.solver3 import Solver3
from cedar_jax import gallery

__version__ = "0.1.0"

__all__ = [
    "Config",
    "MLSettings",
    "FivePt",
    "NinePt",
    "SevenPt",
    "TwentySevenPt",
    "Solver2",
    "Solver3",
    "gallery",
]
