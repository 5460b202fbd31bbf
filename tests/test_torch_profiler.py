"""The port's ``runtime/profiler.py`` against ``ssip_tpu/runtime/profiler.py``:
``PhaseTimer`` on a scripted clock, and ``trace``/``annotate`` writing a
Chrome trace only when profiling is enabled."""

import json

import pytest
import torch

from ssip_tpu.runtime import profiler as jprofiler
from ssip_tpu_torch.runtime import profiler


def _clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("script", [
    [("decode", 10, 0.5), ("embed", 128, 0.25), ("decode", 6, 0.125)],
    [("idle", 0, 0.0), ("embed", 3, 2.0)],
])
def test_phase_timer_matches_jax(monkeypatch, script):
    ticks = []
    t = 100.0
    for _name, _items, seconds in script:
        ticks += [t, t + seconds]
        t += seconds + 1.0
    timers = []
    for cls in (profiler.PhaseTimer, jprofiler.PhaseTimer):
        _clock(monkeypatch, list(ticks))
        timer = cls()
        for name, items, _seconds in script:
            with timer.phase(name, items):
                pass
        timers.append(timer)
    ours, theirs = timers
    assert ours.summary() == theirs.summary()
    assert ours.phases == theirs.phases and ours.counts == theirs.counts
    for name, _items, _seconds in script:
        assert ours.rate(name) == theirs.rate(name)
    assert ours.rate("missing") == theirs.rate("missing") == 0.0


def test_phase_timer_counts_a_phase_that_raises():
    timer = profiler.PhaseTimer()
    with pytest.raises(RuntimeError):
        with timer.phase("broken", 4):
            raise RuntimeError("boom")
    assert timer.counts["broken"] == 4 and timer.phases["broken"] >= 0.0


def test_trace_is_off_without_a_directory(monkeypatch, tmp_path):
    monkeypatch.delenv(profiler.ENV_PROFILE_DIR, raising=False)
    monkeypatch.chdir(tmp_path)
    with profiler.trace("embed"), profiler.annotate("step"):
        torch.ones(3).sum()
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("by_env", [True, False])
def test_trace_writes_a_chrome_trace(monkeypatch, tmp_path, by_env):
    if by_env:
        monkeypatch.setenv(profiler.ENV_PROFILE_DIR, str(tmp_path))
        ctx = profiler.trace("embed")
    else:
        monkeypatch.delenv(profiler.ENV_PROFILE_DIR, raising=False)
        ctx = profiler.trace("embed", profile_dir=tmp_path)
    with ctx:
        with profiler.annotate("ssip_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "embed" / profiler.TRACE_FILE).read_text())["traceEvents"]
    assert any(e.get("name") == "ssip_region" for e in events)
