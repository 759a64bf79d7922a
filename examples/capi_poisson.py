"""Handle-based procedural API demo (reference: the C API,
include/cedar/capi.h used from a host application)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import numpy as np

import cedar_jax.capi as capi


def main():
    n = 128
    topo = capi.bmg2_topo_create(n, n)
    op = capi.bmg2_operator_create(topo)

    # assemble the 5-point Poisson operator through the entry interface
    h = 1.0 / (n + 1)
    coords, vals = [], []
    for i in range(n):
        for j in range(n):
            coords.append((i, j, capi.BMG2_O))
            vals.append(4.0)
            if i > 0:
                coords.append((i, j, capi.BMG2_W))
                vals.append(1.0)
            if j > 0:
                coords.append((i, j, capi.BMG2_S))
                vals.append(1.0)
    capi.bmg2_operator_set(op, coords, vals)

    xg = (np.arange(n) + 1) * h
    xx, yy = np.meshgrid(xg, xg, indexing="ij")
    b = (8 * np.pi**2 * np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy)
         * h * h).astype(np.float64)

    slv = capi.bmg2_solver_create(op, {"solver": {"tol": 1e-8,
                                                  "max-iter": 20}})
    x = np.zeros_like(b)
    capi.bmg2_solver_run(slv, x, b)

    exact = np.sin(2 * np.pi * xx) * np.sin(2 * np.pi * yy)
    print(f"Solution norm: {np.abs(x - exact).max():g}")
    capi.bmg2_solver_destroy(slv)
    capi.bmg2_operator_destroy(op)
    print("Finished Test")


if __name__ == "__main__":
    main()
