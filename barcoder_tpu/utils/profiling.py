"""Profiling and performance counters.

The reference's timing surface is limited to "Finished at {now}" table
captions (targets.py:718); here profiling is first-class (SURVEY.md §5):

  - :class:`Phases` — wall-clock per pipeline phase plus derived throughput
    counters (genome-positions-scanned/s, reads-counted/s);
  - :func:`device_trace` — context manager wrapping ``jax.profiler`` so any
    run can emit a TensorBoard-compatible device trace
    (``--profile DIR`` on the CLIs).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field


@dataclass
class Phases:
    """Accumulates named phase timings and counters."""

    timings: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (time.perf_counter() - t0)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def rate(self, counter: str, phase: str) -> float | None:
        t = self.timings.get(phase)
        c = self.counters.get(counter)
        if not t or c is None:
            return None
        return c / t

    def summary(self) -> dict:
        out = {"timings_s": dict(self.timings), "counters": dict(self.counters)}
        rates = {}
        if "spacer_positions" in self.counters and "scan" in self.timings:
            rates["spacer_positions_per_s"] = self.rate("spacer_positions", "scan")
        if "reads" in self.counters and "count" in self.timings:
            rates["reads_per_s"] = self.rate("reads", "count")
        out["rates"] = rates
        return out

    def log(self, logger) -> None:
        logger.json(self.summary())


class CompileStats:
    """XLA compile observability (VERDICT r2: the first scan's cold-start
    cost is executable-count × compile/cache-load time, and nothing
    measured it). Registers jax.monitoring listeners and aggregates:

      - ``compiles``: backend_compile invocations (one per new executable
        this process actually compiled — persistent-cache hits don't fire);
      - ``compile_s``: total backend compile seconds;
      - ``cache_hits`` / ``cache_requests``: persistent compilation cache
        outcomes (only populated when utils.jaxcache enabled the cache —
        GPU backend); misses = requests - hits.

    Use as a singleton via :func:`compile_stats` BEFORE the first jit runs;
    ``snapshot()``/``delta(prev)`` bracket a region of interest."""

    def __init__(self):
        self.compiles = 0
        self.compile_s = 0.0
        self.cache_hits = 0
        self.cache_requests = 0
        from jax._src import monitoring

        monitoring.register_event_duration_secs_listener(self._on_duration)
        monitoring.register_event_listener(self._on_event)

    def _on_duration(self, name: str, dur: float, **kw) -> None:
        if name == "/jax/core/compile/backend_compile_duration":
            self.compiles += 1
            self.compile_s += dur

    def _on_event(self, name: str, **kw) -> None:
        if name == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1
        elif name == "/jax/compilation_cache/compile_requests_use_cache":
            self.cache_requests += 1

    def snapshot(self) -> dict:
        return {
            "compiles": self.compiles,
            "compile_s": round(self.compile_s, 3),
            "cache_hits": self.cache_hits,
            "cache_requests": self.cache_requests,
        }

    def delta(self, prev: dict) -> dict:
        cur = self.snapshot()
        return {k: round(cur[k] - prev[k], 3) for k in cur}


_COMPILE_STATS: CompileStats | None = None


def compile_stats() -> CompileStats:
    """Process-wide CompileStats, created on first use."""
    global _COMPILE_STATS
    if _COMPILE_STATS is None:
        _COMPILE_STATS = CompileStats()
    return _COMPILE_STATS


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """jax.profiler trace when a directory is given; no-op otherwise."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def dump_summary(phases: Phases, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(phases.summary(), fh, indent=2)
