"""Tracing / profiling helpers (SURVEY §5: the reference has only
wall-clock timing — `evaluator.py:325-365`, `fit_evaluate` split timing
`sgmcmc_sampler.py:833-867`; this rebuild adds the XLA-level profiler).

`trace(dir)` wraps a region in a `jax.profiler` trace whose output loads
in TensorBoard / Perfetto and shows per-kernel device time.  `Timer`
reproduces the reference's wall-clock split-timing; end each timed
section with `jax.block_until_ready` on its outputs, or the section
measures only the dispatch.
"""
from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Profile a region: ``with profiling.trace("/tmp/jax-trace"): ...``.

    Writes an XLA trace viewable in TensorBoard's profile plugin or
    Perfetto.  The traced region should include at least one executed
    (not cache-hit-compiled-only) jitted call.
    """
    jax.profiler.start_trace(log_dir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Named wall-clock split timer (reference `evaluate_sampler_step`
    timing rows, `evaluator.py:325-365`).

    >>> t = Timer()
    >>> with t.section("sampler"):
    ...     out = jax.block_until_ready(step(...))
    >>> t.totals  # {"sampler": seconds}
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def rows(self):
        """Tidy metric rows (metric, variable, value) like the reference's
        runtime rows."""
        return [dict(metric="runtime", variable=k,
                     value=self.totals[k], count=self.counts[k])
                for k in sorted(self.totals)]
