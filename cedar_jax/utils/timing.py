"""Hierarchical solver timers (reference: include/cedar/util/time_log.h).

The reference wraps every cycle stage ("setup", "solve", "relaxation",
"residual", "restrict", "interp-add", "coarse-solve", "agglomerate", …) in
`timer_begin/end` pairs bucketed per MG level (`timer_down/up` follow the
cycle), aggregates min/max/ratio/avg over MPI ranks, and saves
`timings.json`.

The cycle executes as ONE jitted XLA program, so per-stage wall timers
inside the cycle would only measure dispatch.  The equivalents:

* :class:`TimeLog` — host-side phase timers (setup / solve / per-iteration)
  with the reference's per-level bucket structure and `timings.json`
  output format.  Used around jitted calls, where host time is meaningful.
  A `redist`-style pause/play matches the reference's `timer_pause/play`
  around redistributed solves.
* :func:`scope` — `jax.named_scope` wrapper: stage names annotate the HLO,
  so device profiles (`jax.profiler.trace`) attribute device time to
  "relaxation"/"residual"/… exactly like the reference's labels.
* :func:`profile_trace` — context manager around `jax.profiler.trace` for
  a full device timeline.
* :func:`time_ms` — device time of a call, by the host clock around
  `block_until_ready` after a warm-up call; :func:`require_gpu` and
  :func:`card_info` for the scripts that measure on the GPU.

Forcing semantics: on asynchronous runtimes the caller must synchronize
(`jax.block_until_ready` / scalar fetch) before `timer_end` for the number
to mean anything; `timer_end(..., force=x)` does this when given a value.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import time
from collections import defaultdict

import jax


class TimeLog:
    """Label → elapsed seconds, bucketed per MG level (time_log.h:21-68)."""

    def __init__(self):
        self.lvl = 0
        self.stacks: list[tuple[str, float]] = []
        self.ltimes: dict[int, dict[str, float]] = defaultdict(
            lambda: defaultdict(float)
        )
        self.counts: dict[int, dict[str, int]] = defaultdict(
            lambda: defaultdict(int)
        )
        self._paused = False

    # -- reference API --------------------------------------------------------
    def begin(self, label: str) -> None:
        if self._paused:
            return
        self.stacks.append((label, time.perf_counter()))

    def end(self, label: str, force=None) -> None:
        if self._paused:
            return
        if force is not None:
            jax.block_until_ready(force)
        name, t0 = self.stacks.pop()
        assert name == label, f"timer mismatch: {name} != {label}"
        self.ltimes[self.lvl][label] += time.perf_counter() - t0
        self.counts[self.lvl][label] += 1

    def up(self) -> None:
        self.lvl -= 1

    def down(self) -> None:
        self.lvl += 1

    def pause(self) -> None:
        """reference: timer_pause around redistributed solves."""
        self._paused = True

    def play(self) -> None:
        self._paused = False

    @contextlib.contextmanager
    def timing(self, label: str, force_out=False):
        self.begin(label)
        out = []
        try:
            yield out
        finally:
            self.end(label, force=out[0] if (force_out and out) else None)

    # -- reporting -------------------------------------------------------------
    def todict(self) -> dict:
        """The reference's timings.json structure (single-rank: min=max=avg)."""
        out = {}
        for lvl in sorted(self.ltimes):
            blk = {}
            for label, t in sorted(self.ltimes[lvl].items()):
                blk[label] = {
                    "min": t, "max": t, "ratio": 1.0, "avg": t,
                    "count": self.counts[lvl][label],
                }
            out[f"level-{lvl}"] = blk
        return out

    def save(self, fname: str = "timings.json") -> None:
        with open(fname, "w") as f:
            json.dump(self.todict(), f, indent=2)


def scope(name: str):
    """Stage annotation for device profiles (e.g. 'relaxation')."""
    return jax.named_scope(name)


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a device profile of the enclosed block (view with
    tensorboard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_ms(fn, *args, reps: int = 10) -> float:
    """Median milliseconds of ``fn(*args)`` to ``block_until_ready``,
    after one warm-up call (which also compiles)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def require_gpu():
    """The first device, which must be a GPU (measurement paths do not
    fall back to the CPU)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"needs a GPU; JAX found {dev.platform!r} ({dev.device_kind})"
        )
    return dev


def card_info() -> str:
    """``name, power.limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
