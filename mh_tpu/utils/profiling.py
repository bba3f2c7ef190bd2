"""Profiling + timing instrumentation.

Replacement for the vendor ``StopWatchInterface`` timers the reference
ships but never calls (SURVEY.md B3, ``helper_timer.h:381-486``): a phase
timer used with :func:`force_completion`, which waits for the device
before the clock is read (JAX dispatch is asynchronous), plus a thin
wrapper over ``jax.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


def force_completion(tree) -> None:
    """Wait until every array of a pytree has been computed."""
    jax.block_until_ready(tree)


class PhaseTimer:
    """Accumulating wall-clock timer per named phase.

    >>> timer = PhaseTimer()
    >>> with timer.phase("propose+cost"):
    ...     out = step(x)
    ...     force_completion(out)
    >>> timer.report()
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t * 1e3:10.2f} ms total  {t / c * 1e3:8.3f} ms/call  x{c}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
