"""3D Poisson solve (reference: examples/basic-3d-ser/poisson.cc).

Run:  python examples/basic_3d_ser.py [n]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


import jax.numpy as jnp

from cedar_jax import SevenPt, Solver3, gallery
from cedar_jax.config import Config


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 64

    so = gallery.poisson3(n, n, n, dtype=jnp.float32)
    b = gallery.poisson3_rhs(n, n, n, dtype=jnp.float32)
    bmg = Solver3(so, SevenPt, Config({
        "solver": {"tol": 1e-6, "max-iter": 12},
    }))
    x = bmg.solve(b)
    err = float(jnp.max(jnp.abs(x - gallery.poisson3_solution(
        n, n, n, dtype=jnp.float32))))
    print(f"Solution norm: {err:g}")
    print("Finished Test")


if __name__ == "__main__":
    main()
