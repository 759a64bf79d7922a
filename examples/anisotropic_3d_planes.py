"""Plane relaxation on a plane-aligned anisotropic 3D problem
(reference: test/3d/test_planes.cc + config plane-config).

With dz << dx, dy point relaxation stalls; zebra xy-plane relaxation
(each plane smoothed by an embedded batched 2D BoxMG cycle) restores
textbook convergence.
Run:  python examples/anisotropic_3d_planes.py [n]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


import jax.numpy as jnp

from cedar_jax import SevenPt, Solver3, gallery
from cedar_jax.config import Config


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32

    so = gallery.diag_diffusion3(n, n, n, 1.0, 1.0, 1e-4,
                                 dtype=jnp.float32)
    b = gallery.poisson3_rhs(n, n, n, dtype=jnp.float32)
    # NB: float32 residual evaluation floors around 1e-4 relative at this
    # size (catastrophic cancellation in b - A x); the gate reflects that.
    bmg = Solver3(so, SevenPt, Config({
        "solver": {"relaxation": "plane-xy", "tol": 5e-4, "max-iter": 20},
        "plane-config": {"solver": {"relaxation": "line-xy",
                                    "max-iter": 1}},
    }))
    bmg.solve(b)
    print(f"converged in {len(bmg.history)} cycles "
          f"(first-cycle reduction {bmg.history[0]:.2e})")
    print("Finished Test")


if __name__ == "__main__":
    main()
