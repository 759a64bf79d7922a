"""Collective-cost analysis: sharded zebra-line PCR vs interface reduction.

Counts the collectives XLA's SPMD partitioner inserts for one zebra
x-line sweep when the grid is sharded along the LINE axis — the question
the reference answers with its hand-built interface reduction
(one gather + one scatter per color,
src/2d/ftn/mpi/BMG2_SymStd_relax_lines_x.f90:156-277) and its log-depth
ml_relax variant (include/cedar/2d/mpi/ml_relax.h).  Run on the virtual
8-CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python tools/analyze_lines.py
"""

import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cedar_jax import gallery
from cedar_jax.core.types import StencilKind
from cedar_jax.ops.lines2 import line_relax_x, setup_lines
from cedar_jax.parallel import make_mesh


def main(n=512):
    mesh = make_mesh(2, devices=jax.devices("cpu"))
    so = gallery.fe(n, n, dtype=jnp.float32)
    sor = setup_lines(so, StencilKind.nine_pt, "x")
    b = gallery.poisson_rhs(n, n, dtype=jnp.float32)
    q = jnp.zeros_like(b)
    sh = NamedSharding(mesh, P("x", "y"))  # x = the line axis
    so_s = jax.device_put(so, NamedSharding(mesh, P(None, "x", "y")))
    sor_s = jax.device_put(sor, NamedSharding(mesh, P(None, "x", "y")))
    q_s, b_s = jax.device_put(q, sh), jax.device_put(b, sh)

    def count(fn):
        """Count collective INSTRUCTIONS (one per `= op(...)` definition;
        a bare word-count over the HLO triple-counts via metadata and
        async start/done pairs)."""
        txt = fn.lower(so_s, q_s, b_s, sor_s).compile().as_text()
        counts = {}
        for op in ("collective-permute", "all-gather", "all-reduce",
                   "all-to-all", "reduce-scatter", "dynamic-slice"):
            counts[op] = len(
                re.findall(rf"= \S+ {op}(?:-start)?\(", txt)
            )
        return counts

    naive = jax.jit(lambda so, q, b, sor: line_relax_x(
        so, q, b, sor, StencilKind.nine_pt, "down"))
    local = jax.jit(lambda so, q, b, sor: line_relax_x(
        so, q, b, sor, StencilKind.nine_pt, "down", shard=sh))

    from cedar_jax.ops.lines2 import setup_lines_spike_dist

    spike_ws = setup_lines_spike_dist(
        so_s, StencilKind.nine_pt, "x", mesh, "x", "y")

    def spike_fn(so, q, b, sor):
        del sor
        return line_relax_x(so, q, b, spike_ws, StencilKind.nine_pt,
                            "down", shard=sh)

    spike = jax.jit(spike_fn)

    print(f"zebra x-line sweep at {n}^2 over mesh {dict(mesh.shape)} "
          f"(line axis sharded {mesh.shape['x']}-way):")
    for name, fn in (("naive PCR (auto-SPMD)", naive),
                     ("line-local shard_map", local),
                     ("dist SPIKE interface reduction", spike)):
        counts = count(fn)
        coll = {k: v for k, v in counts.items()
                if v and k != "dynamic-slice"}
        print(f"  {name}: {coll}  total "
              f"{sum(coll.values())}")
    print("  reference interface reduction: 2 per color (gather+scatter) "
          "= 4; log-depth ml_relax: O(log P) per color")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 512)
