"""Performance model + agglomeration-schedule search tests.

Reference counterpart: the A*-searched redistribution in
perf_factory::astar_vcycle (ss/astar.h) driven by machine.* config.
"""

import numpy as np
import jax
import pytest
from jax.sharding import PartitionSpec as P

import cedar_jax.perf as perf
from cedar_jax.perf import MachineParams, cycle_time, search_schedule


SHAPES2 = [(4096, 4096), (2049, 2049), (1025, 1025), (513, 513),
           (257, 257), (129, 129), (65, 65), (33, 33), (17, 17),
           (9, 9), (5, 5)]


def _allowed(shapes, mesh, min_local=8):
    out = []
    for s in shapes:
        mask = 0
        for d in range(len(s)):
            if mesh[d] > 1 and s[d] % mesh[d] == 0 \
                    and s[d] // mesh[d] >= min_local:
                mask |= 1 << d
        out.append(mask)
    return out


def test_native_matches_python_fallback():
    m = MachineParams()
    mesh = (4, 2)
    allowed = _allowed(SHAPES2, mesh)
    native = perf._load_native()
    masks_n, cost_n = search_schedule(SHAPES2, mesh, allowed, m)
    ct_n = cycle_time(SHAPES2, mesh, masks_n, m)
    # force the Python path
    saved = (perf._lib, perf._lib_tried)
    perf._lib, perf._lib_tried = None, True
    try:
        masks_p, cost_p = search_schedule(SHAPES2, mesh, allowed, m)
        ct_p = cycle_time(SHAPES2, mesh, masks_p, m)
    finally:
        perf._lib, perf._lib_tried = saved
    assert masks_n == masks_p
    np.testing.assert_allclose(cost_n, cost_p, rtol=1e-12)
    np.testing.assert_allclose(ct_n, ct_p, rtol=1e-12)
    if native is None:
        pytest.skip("no C++ toolchain: fallback-only run")


def test_search_is_optimal_and_monotone():
    m = MachineParams()
    mesh = (2, 2, 2)
    shapes = [(512, 512, 512), (256, 256, 256), (128, 128, 128),
              (64, 64, 64), (32, 32, 32), (16, 16, 16), (8, 8, 8)]
    allowed = _allowed(shapes, mesh, min_local=4)
    masks, cost = search_schedule(shapes, mesh, allowed, m,
                                  stencil_fine=7, stencil_coarse=27)
    # schedule cost equals the model's evaluation of the schedule
    np.testing.assert_allclose(cycle_time(
        shapes, mesh, masks, m, stencil_fine=7, stencil_coarse=27), cost,
        rtol=1e-12)
    # monotone: axes only dropped going coarser
    for a, b in zip(masks, masks[1:]):
        assert b & ~a == 0
    # the big fine level must be fully sharded; the tiny coarsest replicated
    assert masks[0] == 0b111
    assert masks[-1] == 0
    # exhaustive check of optimality on a small instance
    small = shapes[3:]
    allowed_s = _allowed(small, mesh, min_local=4)
    best = None
    import itertools

    def ok(seq):
        return all(
            (mk & ~al) == 0 for mk, al in zip(seq, allowed_s)
        ) and all(b & ~a == 0 for a, b in zip(seq, seq[1:]))

    for seq in itertools.product(range(8), repeat=len(small)):
        if not ok(seq):
            continue
        c = cycle_time(small, mesh, list(seq), m,
                       stencil_fine=7, stencil_coarse=27)
        if best is None or c < best:
            best = c
    _, cost_s = search_schedule(small, mesh, allowed_s, m,
                                stencil_fine=7, stencil_coarse=27)
    np.testing.assert_allclose(cost_s, best, rtol=1e-12)


def test_astar_strategy_in_policy():
    from cedar_jax.parallel import make_mesh
    from cedar_jax.parallel.policy import level_specs

    mesh = make_mesh(2, devices=jax.devices("cpu"))
    # 1024^2: large enough that the H100 model's bandwidth outweighs the
    # per-op overhead on the fine level (smaller grids price as cheaper
    # fully replicated)
    shapes = [(1024, 1024), (512, 512), (256, 256), (128, 128), (64, 64),
              (32, 32), (16, 16), (8, 8)]
    specs = level_specs(shapes, mesh, strategy="astar")
    assert specs[0] == P("x", "y")
    assert specs[-1] == P(None, None)
    # monotone agglomeration
    def rank(sp):
        return sum(1 for s in sp if s is not None)
    assert all(rank(b) <= rank(a) for a, b in zip(specs, specs[1:]))
