"""Timing and logging subsystem tests (reference: util/time_log.h,
util/log.h)."""

import json

from cedar_jax.utils import log
from cedar_jax.utils.timing import TimeLog


def test_timelog_levels_and_report(tmp_path):
    tl = TimeLog()
    tl.begin("setup")
    tl.end("setup")
    tl.begin("solve")
    tl.down()
    tl.begin("relaxation")
    tl.end("relaxation")
    tl.up()
    tl.end("solve")
    d = tl.todict()
    assert "setup" in d["level-0"] and "solve" in d["level-0"]
    assert "relaxation" in d["level-1"]
    assert d["level-0"]["setup"]["count"] == 1
    fname = tmp_path / "timings.json"
    tl.save(str(fname))
    loaded = json.loads(fname.read_text())
    assert loaded.keys() == d.keys()


def test_timelog_pause_play():
    """timer_pause/play semantics around redistributed solves
    (reference: time_log.h timer_pause)."""
    tl = TimeLog()
    tl.begin("solve")
    tl.pause()
    tl.begin("inner")   # ignored while paused
    tl.end("inner")
    tl.play()
    tl.end("solve")
    d = tl.todict()
    assert "inner" not in d.get("level-0", {})
    assert "solve" in d["level-0"]


def test_log_header_stack(capsys):
    log.set_enabled({"status"})
    log.push_level("redist 1")
    log.status("hello")
    log.pop_level()
    log.status("plain")
    out = capsys.readouterr().out
    assert "(redist 1) hello" in out
    assert "plain" in out and "(redist 1) plain" not in out
    log.set_enabled({"status", "error"})
