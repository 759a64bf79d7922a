"""Distributed 2D Poisson over a device mesh
(reference: examples/basic-2d-mpi/poisson.cc).

The grid is block-partitioned over a 2-axis mesh of all available devices;
coarse levels agglomerate per the configured redistribution strategy.
Run:  python examples/basic_2d_dist.py [nx ny]
On a machine without multiple accelerators:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/basic_2d_dist.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


import jax
import jax.numpy as jnp

from cedar_jax import FivePt, gallery
from cedar_jax.config import Config
from cedar_jax.parallel import DistSolver2, make_mesh


def main():
    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    ny = int(sys.argv[2]) if len(sys.argv) > 2 else nx

    devs = jax.devices()
    if len(devs) == 1:
        devs = jax.devices("cpu")
    mesh = make_mesh(2, devices=devs)
    print(f"mesh: {dict(mesh.shape)}")

    so = gallery.poisson(nx, ny, dtype=jnp.float32)
    b = gallery.poisson_rhs(nx, ny, dtype=jnp.float32)
    conf = Config({
        "solver": {"tol": 1e-6, "max-iter": 12},
        "redist": {"search": {"strategy": "astar"}},
    })
    bmg = DistSolver2(so, FivePt, conf, mesh)
    print("per-level placement:", [str(s) for s in bmg.specs])
    x = bmg.solve(b)
    err = float(jnp.max(jnp.abs(jax.device_get(x) - gallery.poisson_solution(
        nx, ny, dtype=jnp.float32))))
    print(f"Solution norm: {err:g}")
    print("Finished Test")


if __name__ == "__main__":
    main()
