"""Lightweight profiling/observability hooks.

The reference has no tracing beyond ad-hoc notebook timers (SURVEY.md
section 5). Here every fit can report per-stage wall-clock and the sampler
reports ESS/sec (the headline benchmark metric), and a jax.profiler trace
can wrap any stage for device timeline inspection.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional


class StageTimer:
    """Collects named wall-clock stages; attach as ``inv.timings``."""

    def __init__(self):
        self.stages = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> dict:
        return dict(self.stages)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Optional jax.profiler trace around a stage (device timeline).

    No-op when log_dir is None.
    """
    if log_dir is None:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield
