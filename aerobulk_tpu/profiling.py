"""Lightweight observability: per-stage timers + jax.profiler hooks.

The reference has no tracing at all (its closest analogue is a handful of
debug PRINT flags, SURVEY.md §5).  Here: a ``stage`` context manager that
wall-times named stages (forcing host reads, device put, compile, step,
writeback), an optional ``jax.profiler`` trace directory for full XLA
device profiles, a warmed device timer, and a tiny report.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import jax

__all__ = ["Profiler", "device_time", "profiler"]


def device_time(fn, *args, reps: int = 5) -> float:
    """Median wall time of ``fn(*args)`` with its result ready on the
    device, in seconds.

    One untimed call first compiles and warms ``fn``, so no compilation
    falls inside the timed window; each timed call ends in
    ``jax.block_until_ready``.
    """
    import numpy as np

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


class Profiler:
    """Accumulating wall-clock stage timer.

    >>> prof = Profiler()
    >>> with prof.stage("compute"):
    ...     out = step(x)
    ...     jax.block_until_ready(out)
    >>> print(prof.report())
    """

    def __init__(self, trace_dir: Optional[str] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.trace_dir = trace_dir

    @contextlib.contextmanager
    def stage(self, name: str, block: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block:
                # ensure async dispatch is included in this stage
                jax.effects_barrier()
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    @contextlib.contextmanager
    def device_trace(self):
        """Wrap a region in a jax.profiler trace (TensorBoard format)."""
        if self.trace_dir is None:
            yield
            return
        jax.profiler.start_trace(self.trace_dir)
        try:
            yield
        finally:
            jax.profiler.stop_trace()

    def report(self) -> str:
        lines = [f"{'stage':<24s} {'calls':>6s} {'total[s]':>10s} "
                 f"{'mean[ms]':>10s}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:<24s} {n:>6d} {tot:>10.3f} "
                         f"{tot / n * 1e3:>10.2f}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


#: module-level default instance for casual use
profiler = Profiler()
