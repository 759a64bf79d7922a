#!/usr/bin/env python
"""Smoke test of the solver on the GPU, through the public entry points.

    python chip_smoke.py             # one card: phases 0-4
    python chip_smoke.py --chips 4   # four cards: the distributed path only

One card:

0. device: refuses to run unless JAX's first device is a GPU; prints its
   kind, the card's name and power limit, and the JAX version;
1. float64 history gate: the reference's 400² Poisson residual history;
2. the main path, ``Solver2(...).solve(b)`` on 4096² 5-point Poisson in
   float32 with the kernel path ``auto`` picks on the card, timed, checked
   against a float64 host residual and against the same solve on the
   plain XLA path;
3. the fused sweep kernel against the plain XLA sweep at full size;
4. the other solver configurations of ``bench.py`` on the plain path, a
   few cycles each, with the host residual check.

Four cards (``--chips 4``): ``DistSolver2`` 5-point 8192² on a (2, 2) mesh
and ``DistSolver3`` 7-point 256³ on (2, 2, 1), each against a single-card
solve of the same problem, with each card's memory in use after setup.

Every phase prints its result on its own line; any failure raises.  The
last line is one JSON object naming the device.
"""

import argparse
import json
import os
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cedar_jax import (  # noqa: E402
    FivePt, NinePt, SevenPt, TwentySevenPt, Solver2, Solver3, gallery,
)
from cedar_jax.config import Config  # noqa: E402
from cedar_jax.ops import pallas2, relax2, stencil2, stencil3  # noqa: E402
from cedar_jax.utils.cache import enable_compile_cache  # noqa: E402
from cedar_jax.utils.timing import card_info, require_gpu, time_ms  # noqa

from bench import history_gate  # noqa: E402

F32 = jnp.float32
V11 = {"cycle": {"nrelax-pre": 1, "nrelax-post": 1}}


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


# -- independent float64 host residual ---------------------------------------

def _shift(a, off):
    """out[i] = a[i + off], zero beyond the grid."""
    out = np.zeros_like(a)
    src = tuple(slice(max(o, 0), n + min(o, 0)) for n, o in zip(a.shape, off))
    dst = tuple(slice(max(-o, 0), n + min(-o, 0))
                for n, o in zip(a.shape, off))
    out[dst] = a[src]
    return out


def host_residual(so, x, b, kind):
    """(||b - A x|| / ||b||, float32 evaluation-error scale) in float64
    numpy from the coupling tables.  The scale is eps32 * || |A| |x| ||
    / ||b||: how far a float32 evaluation of the same residual (the
    solver's own) can be off."""
    so = np.asarray(so, np.float64)
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    r = b - so[0] * x
    mag = np.abs(so[0] * x)
    if x.ndim == 2:
        terms = [(stencil2.NEIGHBOR_COUPLINGS[off][0],
                  stencil2.NEIGHBOR_COUPLINGS[off][1:], off)
                 for off in stencil2.offsets_for(kind)]
    else:
        terms = [(*stencil3.NEIGHBOR_COUPLINGS_27[off], off)
                 for off in stencil3.offsets_for(kind)]
    for plane, sh, off in terms:
        t = _shift(so[plane], sh) * _shift(x, off)
        r += t
        mag += np.abs(t)
    nb = np.linalg.norm(b)
    eps32 = float(np.finfo(np.float32).eps)
    return float(np.linalg.norm(r) / nb), eps32 * float(np.linalg.norm(mag)
                                                        / nb)


def check_host_residual(tag, so, x, b, kind, solver):
    """The returned x must really solve the system as far as the solver
    reports: its float64 host residual (||b - A x|| / ||b||, x0 = 0) is
    below 0.1 and at most twice the solver's own last relative residual
    plus the float32 evaluation-error scale of that residual."""
    host, scale = host_residual(so, x, b, kind)
    dev = solver.history[-1]
    ok = bool(np.isfinite(host) and host < 0.1
              and host <= 2.0 * dev + scale)
    say(tag, check="host_f64_residual", host_rel=host, device_rel=dev,
        f32_eval_scale=scale, ok=ok)
    assert ok, (tag, host, dev, scale)


# -- phases -------------------------------------------------------------------

def phase0():
    dev = require_gpu()
    say(0, device_kind=dev.device_kind, platform=dev.platform,
        count=len(jax.devices()), card=card_info(),
        jax_version=jax.__version__)
    return dev


def phase1():
    ok, iters, err = history_gate()
    say(1, check="f64_history_400sq", iterations=iters, max_rel_err=err,
        rtol=2e-5, ok=ok)
    assert ok


def _solve_4096(backend):
    n = 4096
    so = gallery.poisson(n, n, dtype=F32)
    b = gallery.poisson_rhs(n, n, dtype=F32)
    conf = Config({"log": [], "kernels": {"backend": backend},
                   "solver": {**V11, "tol": 1e-6, "max-iter": 10}})
    t0 = time.perf_counter()
    s = Solver2(so, FivePt, conf)
    jax.block_until_ready(s.levels)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = jax.block_until_ready(s.solve(b))
    first_s = time.perf_counter() - t0
    solve_ms = time_ms(s.solve, b, reps=3)
    # per cycle: one solve iteration (the cycle plus its convergence norm)
    say(2, backend=s.settings.kernel_backend, grid=[n, n],
        setup_s_incl_compile=setup_s, first_solve_s_incl_compile=first_s,
        solve_ms=solve_ms, iterations=len(s.history),
        cycle_ms=solve_ms / len(s.history), history=s.history)
    return s, so, b, x


def phase2():
    s, so, b, x = _solve_4096("auto")
    assert s.settings.kernel_backend == "pallas", s.settings.kernel_backend
    assert x.shape == b.shape and bool(jnp.all(jnp.isfinite(x)))
    check_host_residual(2, so, x, b, FivePt, s)
    s_x, _, _, x_x = _solve_4096("xla")
    # the same arithmetic on both paths (phase 3: the kernel's sweep
    # equals XLA's to rounding), so the histories agree to float32
    # reassociation; near the float32 floor, where the residual is mostly
    # rounding, that is 1e-3 relative
    hist_err = float(np.max(np.abs(np.array(s.history)
                                   / np.array(s_x.history) - 1)))
    xscale = float(jnp.max(jnp.abs(x_x)))
    x_err = float(jnp.max(jnp.abs(x - x_x))) / xscale
    ok = (len(s.history) == len(s_x.history) and hist_err <= 1e-3
          and x_err <= 1e-4)
    say(2, check="pallas_vs_xla_on_card", hist_max_rel_err=hist_err,
        hist_rtol=1e-3, x_max_err_over_max_x=x_err, x_tol=1e-4, ok=ok)
    assert ok


def phase3():
    rng = np.random.default_rng(0)
    for kind, n in ((FivePt, 4096), (NinePt, 2048)):
        base = (gallery.fe(n, n, dtype=F32) if kind == NinePt
                else gallery.poisson(n, n, dtype=F32))
        so = base * (1 + 0.1 * jnp.asarray(rng.random(base.shape), F32))
        q = jnp.asarray(rng.standard_normal(base.shape[1:]), F32)
        b = jnp.asarray(rng.standard_normal(base.shape[1:]), F32)
        rec = relax2.setup_recip(so)
        for updown in ("down", "up"):
            for fuse in (False, True):
                def plain(so, q, b, rec, updown=updown, fuse=fuse):
                    x = relax2.point_relax(so, q, b, rec, kind, updown)
                    if fuse:
                        return x, stencil2.residual(so, x, b, kind)
                    return x

                def kernel(so, q, b, updown=updown, fuse=fuse):
                    return pallas2.point_relax(so, q, b, kind, updown, fuse)

                plain_j, kernel_j = jax.jit(plain), jax.jit(kernel)
                ref = jax.tree.leaves(plain_j(so, q, b, rec))
                got = jax.tree.leaves(kernel_j(so, q, b))
                # f32 with the same terms in the same order; only FMA
                # contraction may differ (no matmul, so TF32 is moot)
                errs = [float(jnp.max(jnp.abs(g - r)) / jnp.max(jnp.abs(r)))
                        for g, r in zip(got, ref)]
                ok = all(e <= 1e-5 for e in errs)
                say(3, kind=kind.name, grid=[n, n], updown=updown,
                    fused_residual=fuse, max_rel_err=errs, rtol=1e-5,
                    kernel_ms=time_ms(kernel_j, so, q, b),
                    xla_ms=time_ms(plain_j, so, q, b, rec), ok=ok)
                assert ok


def phase4():
    cases = [
        ("3d_poisson_7pt_256", Solver3, SevenPt,
         lambda: gallery.poisson3(256, 256, 256, dtype=F32),
         lambda: gallery.poisson3_rhs(256, 256, 256, dtype=F32), {}),
        ("3d_fe_27pt_128", Solver3, TwentySevenPt,
         lambda: gallery.fe3(128, 128, 128, dtype=F32),
         lambda: gallery.poisson3_rhs(128, 128, 128, dtype=F32), {}),
        ("2d_fe_9pt_linexy_2048", Solver2, NinePt,
         lambda: gallery.fe(2048, 2048, dtype=F32),
         lambda: gallery.poisson_rhs(2048, 2048, dtype=F32),
         {"relaxation": "line-xy"}),
        ("3d_aniso_planexy_128", Solver3, SevenPt,
         lambda: gallery.diag_diffusion3(128, 128, 128, 1.0, 1.0, 1e-3,
                                         dtype=F32),
         lambda: gallery.poisson3_rhs(128, 128, 128, dtype=F32),
         {"relaxation": "plane-xy"}),
    ]
    for name, cls, kind, make_so, make_b, extra in cases:
        so, b = make_so(), make_b()
        t0 = time.perf_counter()
        s = cls(so, kind, Config({"log": [], "solver": {
            **V11, "tol": 1e-12, "max-iter": 3, **extra}}))
        jax.block_until_ready(s.levels)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        x = jax.block_until_ready(s.solve(b))
        first_s = time.perf_counter() - t0
        say(4, config=name, backend=s.settings.kernel_backend,
            setup_s_incl_compile=setup_s, first_solve_s_incl_compile=first_s,
            solve_ms=time_ms(s.solve, b, reps=3),
            iterations=len(s.history), history=s.history)
        check_host_residual(4, so, x, b, kind, s)


def phase_dist():
    """The distributed solvers on four cards against one card, in float64:
    the comparison is of the partitioned arithmetic, which float32's
    rounding floor at these sizes would hide."""
    from cedar_jax.parallel import DistSolver2, DistSolver3, make_mesh

    devs = jax.devices()
    assert len(devs) >= 4, devs
    cases = [
        ("dist2_5pt_8192", 2, DistSolver2, Solver2, FivePt, (2, 2),
         lambda: gallery.poisson(8192, 8192),
         lambda: gallery.poisson_rhs(8192, 8192)),
        ("dist3_7pt_256", 3, DistSolver3, Solver3, SevenPt, (2, 2, 1),
         lambda: gallery.poisson3(256, 256, 256),
         lambda: gallery.poisson3_rhs(256, 256, 256)),
    ]
    conf = {"log": [], "solver": {**V11, "tol": 1e-12, "max-iter": 3}}
    for name, ndim, dist_cls, ser_cls, kind, shape, make_so, make_b in cases:
        mesh = make_mesh(ndim, devices=devs[:4], shape=shape)
        so, b = make_so(), make_b()
        t0 = time.perf_counter()
        sd = dist_cls(so, kind, Config(conf), mesh)
        jax.block_until_ready(sd.levels)
        setup_s = time.perf_counter() - t0
        # card 0 also holds the float64 input operator and right-hand side
        in_use = [(d.memory_stats() or {}).get("bytes_in_use")
                  for d in devs[:4]]
        xd = jax.block_until_ready(sd.solve(b))
        dist_ms = time_ms(sd.solve, b, reps=2)
        ss = ser_cls(so, kind, Config(conf))
        xs = jax.block_until_ready(ss.solve(b))
        ser_ms = time_ms(ss.solve, b, reps=2)
        # the same cycle; the partition changes only the summation order
        # (of the norms and of sharded fusions): float64 reassociation
        err = float(np.max(np.abs(np.array(sd.history)
                                  / np.array(ss.history) - 1)))
        x_err = float(jnp.max(jnp.abs(jax.device_get(xd) - xs))
                      / jnp.max(jnp.abs(xs)))
        ok = (len(sd.history) == len(ss.history) and err <= 1e-9
              and x_err <= 1e-10 and bool(np.all(np.isfinite(xd))))
        say("dist", config=name, dtype="float64", mesh=list(shape),
            specs=[str(p) for p in sd.specs], input_bytes=so.nbytes + b.nbytes,
            bytes_in_use_after_setup=in_use, setup_s_incl_compile=setup_s,
            dist_solve_ms=dist_ms, single_card_solve_ms=ser_ms,
            history=sd.history, hist_max_rel_err=err, hist_rtol=1e-9,
            x_max_err_over_max_x=x_err, x_tol=1e-10, ok=ok)
        assert ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()
    dev = phase0()
    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    if args.chips == 4:
        phase_dist()
    else:
        phase1()
        phase2()
        phase3()
        phase4()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
