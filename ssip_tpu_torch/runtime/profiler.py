"""Profiling hooks: trace capture, named regions and phase timers.

Counterpart of ``ssip_tpu/runtime/profiler.py``. ``trace`` wraps a section
in a ``torch.profiler`` session (host and CUDA activity) when
``SSIP_PROFILE_DIR`` is set or ``profile_dir`` is given, and writes a
Chrome trace, ``<dir>/<name>/trace.json``; otherwise it does nothing.
``annotate`` names a region inside an active trace
(``torch.profiler.record_function``). ``PhaseTimer`` is the JAX package's,
copied: named wall-clock phases and item counts, and their rates.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from ssip_tpu_torch.runtime.logging import get_logger

LOGGER = get_logger(__name__)

ENV_PROFILE_DIR = "SSIP_PROFILE_DIR"
TRACE_FILE = "trace.json"


@contextmanager
def trace(name: str, profile_dir: Optional[Path] = None) -> Iterator[None]:
    """A ``torch.profiler`` trace of the section when profiling is enabled."""
    directory = profile_dir or os.environ.get(ENV_PROFILE_DIR)
    if not directory:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    target = Path(directory) / name
    target.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    LOGGER.info("Capturing profiler trace for '%s' under %s", name, target)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(target / TRACE_FILE))


@contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside an active trace (on the host timeline)."""
    with torch.profiler.record_function(name):
        yield


@dataclass
class PhaseTimer:
    """Accumulates named phase durations + item counts → rates."""

    phases: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str, items: int = 0) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.phases[name] = self.phases.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + items

    def rate(self, name: str) -> float:
        seconds = self.phases.get(name, 0.0)
        return self.counts.get(name, 0) / seconds if seconds > 0 else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "seconds": round(self.phases[name], 4),
                "items": self.counts.get(name, 0),
                "items_per_sec": round(self.rate(name), 2),
            }
            for name in self.phases
        }
