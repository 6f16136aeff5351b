"""
Lightweight observability: synchronized wall-clock timing and a context
wrapper around the JAX profiler.

The reference has no tracing/profiling at all (SURVEY.md §5); this is
the framework-side harness used by ``bench.py`` and available to users.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["synchronize", "Timer", "timed", "trace"]


def synchronize(tree):
    """
    Wait until every array in `tree` is computed and return it.
    """
    return jax.block_until_ready(tree)


class Timer:
    """Accumulating named wall-clock timer.

    >>> timer = Timer()
    >>> with timer("assembly"):
    ...     h = build(...)
    >>> timer.report()
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, name, sync=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - start
            )
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, stream=None):
        import sys

        stream = stream or sys.stderr
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            print(f"{name:32s} {total:9.3f}s  ({n}x, "
                  f"{total / n * 1000:8.2f} ms/call)", file=stream)


def timed(fn, *args, repeats=3, **kwargs):
    """Synchronized best-of-`repeats` wall time of ``fn(*args)``.

    Returns ``(seconds, result)``; the first call (compilation) is
    excluded."""
    result = synchronize(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(repeats):
        start = time.perf_counter()
        result = synchronize(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - start)
    return best, result


@contextlib.contextmanager
def trace(log_dir="/tmp/jax-trace"):
    """Capture a JAX profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
