"""2D Poisson solve (reference: examples/basic-2d-ser/poisson.cc).

Builds the 5-point Poisson operator on an nx x ny grid, solves with BoxMG,
and reports the error against the analytic sin(2pi x) sin(2pi y) solution.
Run:  python examples/basic_2d_ser.py [nx ny]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


import jax.numpy as jnp

from cedar_jax import FivePt, Solver2, gallery
from cedar_jax.config import Config


def main():
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    ny = int(sys.argv[2]) if len(sys.argv) > 2 else nx

    so = gallery.poisson(nx, ny, dtype=jnp.float32)
    b = gallery.poisson_rhs(nx, ny, dtype=jnp.float32)

    conf = Config({
        "solver": {
            "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
            "tol": 1e-6, "max-iter": 10,
        },
    })
    bmg = Solver2(so, FivePt, conf)
    x = bmg.solve(b)

    err = float(jnp.max(jnp.abs(x - gallery.poisson_solution(
        nx, ny, dtype=jnp.float32))))
    print(f"Solution norm: {err:g}")
    bmg.save_timings("timings.json")
    print("Finished Test")


if __name__ == "__main__":
    main()
