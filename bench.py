#!/usr/bin/env python
"""Benchmarks over the BASELINE.json configs, on one GPU.

Emits one JSON line per config — 2D anisotropic line relax, 2D F-cycle,
3D 7-pt, 3D plane-xy, 3D 27-pt — and LAST the headline line (2D Poisson
V(1,1) cycle throughput), whose ``extra.configs`` repeats the other
configs' numbers so a parser that reads a single line still records them
all:

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}

Every line names the device it ran on; the script refuses to run without
a GPU.  Times are the host clock around `block_until_ready`, after a
warm-up call that compiles.

Correctness gate: the reference's published residual history (Cedar's
README, the 400² Poisson example; see BASELINE.md) in float64, in this
process (x64 is on for the whole process; the throughput problems pass
float32 explicitly).

The reference publishes no throughput numbers (SURVEY §6), so
vs_baseline compares against a speed-of-light model: the V-cycle's
minimum device-memory traffic divided by the card's peak bandwidth from
:data:`PEAK_HBM_BW` — i.e. the fraction of memory-bound speed of light.

Set BENCH_FAST=1 to skip the extra configs (headline + gate only).

    python bench.py
"""

import json
import os
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

CEDAR_HISTORY = [
    0.388629, 0.0443548, 0.00494131, 0.000513399, 5.44908e-05,
    5.60612e-06, 5.86933e-07, 6.04942e-08, 6.30975e-09, 6.52713e-10,
]

#: device_kind -> peak device-memory bandwidth in B/s (NVIDIA data sheets)
PEAK_HBM_BW = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bandwidth(device_kind: str) -> float:
    """Peak bandwidth of a known card; an unknown one is an error."""
    try:
        return PEAK_HBM_BW[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak bandwidth for device kind {device_kind!r}; add it to "
            "PEAK_HBM_BW with its source"
        ) from None


def vcycle_traffic_bytes(nx, ny, nrelax=2, dtype_bytes=4):
    """Minimum device-memory bytes touched by one V(1,1)-cycle (all levels).

    Fine level: each of the nrelax sweeps streams q, b, 3 stencil planes
    and writes q; the residual is fused with the last pre-smooth; restrict
    reads res + CI (8 half-resolution planes) and writes the coarse rhs;
    interp_add reads CI + res + coarse x and updates q.  Coarse levels
    (9-point) have 5 stencil planes; geometric sum ≈ 4/3 at equal
    per-point cost (slightly conservative).
    """
    n = nx * ny
    relax = nrelax * (5 + 1) * n           # 3 so + q + b read, q write
    restrict = (1 + 2 + 0.25) * n          # res + CI(8 quarter-size) + rhs
    interp = (1 + 2 + 0.25 + 1) * n
    level = (relax + restrict + interp) * dtype_bytes
    return level * 4 / 3


def _cycle_ms(solver, b):
    """Milliseconds per cycle of ``solver`` on ``b`` from a zero start."""
    from cedar_jax.utils.timing import time_ms

    step = jax.jit(solver._cycle_impl)
    return time_ms(step, solver.levels, jnp.zeros_like(b), b)


def _extra_configs(device):
    """Configs 2-5 of BASELINE.json (+ the 2D F-cycle): one dict per
    config, also printed as individual JSON lines."""
    from cedar_jax import (FivePt, NinePt, SevenPt, TwentySevenPt, Solver2,
                           Solver3, gallery)
    from cedar_jax.config import Config

    f32 = jnp.float32
    out = {}
    conf11 = {"cycle": {"nrelax-pre": 1, "nrelax-post": 1},
              "max-iter": 4, "tol": 1e-6}

    def run_cfg(name, npts, make):
        dt = make() * 1e-3
        out[name] = {"dof_per_s": npts / dt, "cycle_ms": dt * 1e3}
        print(json.dumps({"metric": name, "value": out[name]["dof_per_s"],
                          "unit": "DOF/s", "cycle_ms": out[name]["cycle_ms"],
                          "device": device}), flush=True)

    def cfg_linexy():
        n = 2048
        s = Solver2(gallery.fe(n, n, dtype=f32), NinePt, Config({
            "log": [], "solver": {"relaxation": "line-xy", **conf11}}))
        return _cycle_ms(s, gallery.poisson_rhs(n, n, dtype=f32))

    def cfg_fcycle():
        n = 4096
        conf = {"cycle": {"type": "f", "nrelax-pre": 1, "nrelax-post": 1},
                "max-iter": 4, "tol": 1e-6}
        s = Solver2(gallery.poisson(n, n, dtype=f32), FivePt,
                    Config({"log": [], "solver": conf}))
        return _cycle_ms(s, gallery.poisson_rhs(n, n, dtype=f32))

    def cfg_3d7():
        n = 256
        s = Solver3(gallery.poisson3(n, n, n, dtype=f32), SevenPt,
                    Config({"log": [], "solver": conf11}))
        return _cycle_ms(s, gallery.poisson3_rhs(n, n, n, dtype=f32))

    def cfg_plane():
        n = 128
        s = Solver3(gallery.diag_diffusion3(n, n, n, 1.0, 1.0, 1e-3,
                                            dtype=f32), SevenPt, Config({
            "log": [], "solver": {"relaxation": "plane-xy", **conf11}}))
        return _cycle_ms(s, gallery.poisson3_rhs(n, n, n, dtype=f32))

    def cfg_27():
        n = 128
        s = Solver3(gallery.fe3(n, n, n, dtype=f32), TwentySevenPt,
                    Config({"log": [], "solver": conf11}))
        return _cycle_ms(s, gallery.poisson3_rhs(n, n, n, dtype=f32))

    run_cfg("2d_fe_9pt_linexy_2048", 2048 ** 2, cfg_linexy)
    run_cfg("2d_poisson_fcycle_4096", 4096 ** 2, cfg_fcycle)
    run_cfg("3d_poisson_7pt_256", 256 ** 3, cfg_3d7)
    run_cfg("3d_aniso_planexy_128", 128 ** 3, cfg_plane)
    run_cfg("3d_fe_27pt_128", 128 ** 3, cfg_27)
    return out


def history_gate():
    """The reference's 400² float64 residual history: ``(ok, iterations,
    max relative error)``, ok at 10 iterations within rtol 2e-5."""
    from cedar_jax import FivePt, Solver2, gallery
    from cedar_jax.config import Config

    s = Solver2(gallery.poisson(400, 400), FivePt, Config({
        "log": [], "solver": {"num-levels": 7,
                              "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
                              "tol": 1e-10, "max-iter": 10}}))
    s.solve(gallery.poisson_rhs(400, 400))
    if len(s.history) != len(CEDAR_HISTORY):
        return False, len(s.history), float("inf")
    err = float(np.max(np.abs(np.array(s.history) / CEDAR_HISTORY - 1)))
    return err <= 2e-5, len(s.history), err


def main():
    from cedar_jax import FivePt, Solver2, gallery
    from cedar_jax.config import Config
    from cedar_jax.utils.cache import enable_compile_cache
    from cedar_jax.utils.timing import card_info, require_gpu

    dev = require_gpu()
    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    peak = peak_bandwidth(dev.device_kind)
    card = card_info()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}
    print(f"card: {card}", flush=True)

    hist_ok = history_gate()[0]

    # -- throughput: 4096² float32 V(1,1) ----------------------------------
    n = 4096
    f32 = jnp.float32
    conf = Config({"log": [], "solver": {
        "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-6, "max-iter": 4}})
    b = gallery.poisson_rhs(n, n, dtype=f32)
    t0 = time.perf_counter()
    solver = Solver2(gallery.poisson(n, n, dtype=f32), FivePt, conf)
    jax.block_until_ready(solver.levels)
    setup_s = time.perf_counter() - t0
    dt = _cycle_ms(solver, b) * 1e-3

    def headline(configs):
        return json.dumps({
            "metric": "2d_poisson_vcycle_dof_per_s",
            "value": n * n / dt,
            "unit": "DOF/s",
            "vs_baseline": vcycle_traffic_bytes(n, n) / peak / dt,
            "extra": {
                "grid": [n, n],
                "dtype": "float32",
                "cycle_ms": dt * 1e3,
                "setup_s_incl_compile": setup_s,
                "kernel_backend": solver.settings.kernel_backend,
                "matches_reference_history_400sq_f64": hist_ok,
                "device": device,
                "configs": configs,
            },
        })

    # headline FIRST (so a timeout during the extra configs cannot lose
    # it), then one line per config, then the headline again with the
    # configs embedded (for a last-line parser)
    print(headline({}), flush=True)
    if not os.environ.get("BENCH_FAST"):
        print(headline(_extra_configs(device)), flush=True)


if __name__ == "__main__":
    main()
