"""Counters, gauges and fixed-bucket latency histograms.

A :class:`MetricsRegistry` is a flat name → instrument map with
get-or-create accessors, so call sites never coordinate registration.
Histograms use FIXED bucket upper bounds (default: a log-spaced
seconds ladder), which makes them mergeable across processes and keeps
:meth:`Histogram.quantile` (p50/p99) a deterministic function of the
counts — no reservoir sampling, no data-dependent state.

Publishers bridge the existing stats objects into a registry:
:func:`publish_cache_stats` (`repro_torch.launch.scheduler.CacheStats`),
:func:`publish_scheduler_stats` (`repro_torch.launch.scheduler.SchedulerStats`
including per-bucket occupancy), and the checkpointer's save/restore
timings land in ``ckpt.save_s`` / ``ckpt.restore_s`` histograms of the
:func:`default_registry`.  ``serve.py --metrics-out`` snapshots the
registry to JSON.
"""

from __future__ import annotations

import bisect
import json
import os

# log-spaced seconds ladder: 100µs .. 100s — wide enough for both a
# cached-dispatch latency and a cold XLA compile
DEFAULT_BUCKETS_S = (
    1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0,
    30.0, 100.0)


class Counter:
    """Monotone accumulator."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` observations ≤
    ``buckets[i]``, plus one overflow cell; tracks count and sum so
    means and rates fall out."""

    __slots__ = ("name", "buckets", "counts", "count", "sum")

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS_S):
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"histogram {name}: buckets must ascend")
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v

    def quantile(self, q: float) -> float:
        """Deterministic quantile estimate: walk the cumulative counts
        to the target rank, interpolate linearly inside the bucket.
        The overflow bucket clamps to its lower edge (the estimate is
        then a lower bound — fixed buckets cannot see past the ladder).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= rank and c > 0:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.buckets[-1]

    def to_dict(self) -> dict:
        return {"type": "histogram", "buckets": list(self.buckets),
                "counts": list(self.counts), "count": self.count,
                "sum": self.sum, "p50": self.quantile(0.5),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Flat name → instrument map; accessors get-or-create, and a
    name can only ever hold one instrument kind."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, kind, *args):
        m = self._metrics.get(name)
        if m is None:
            m = kind(name, *args)
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} is {type(m).__name__}, "
                f"not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets=DEFAULT_BUCKETS_S) -> Histogram:
        return self._get(name, Histogram, buckets)

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def to_dict(self) -> dict:
        return {name: self._metrics[name].to_dict()
                for name in self.names()}

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry ambient instrumentation (checkpoint
    timings) publishes into."""
    return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Fresh default registry (test isolation)."""
    global _DEFAULT
    _DEFAULT = MetricsRegistry()
    return _DEFAULT


# ---------------------------------------------------------------------------
# publishers: existing stats objects → registry
# ---------------------------------------------------------------------------

def publish_cache_stats(stats, reg: MetricsRegistry,
                        prefix: str = "scheduler.compile_cache") -> None:
    """`repro_torch.launch.scheduler.CacheStats` → counters + compile-time
    histogram (one observation per recorded compile second — the stats
    object keeps only the total, so the histogram gets the mean; the
    per-compile distribution lives in `repro_torch.obs.trace` compile spans).
    """
    reg.counter(f"{prefix}.hits").value = stats.hits
    reg.counter(f"{prefix}.misses").value = stats.misses
    reg.counter(f"{prefix}.evictions").value = stats.evictions
    reg.counter(f"{prefix}.compiles").value = stats.compiles
    reg.gauge(f"{prefix}.compile_s_total").set(stats.compile_s)
    if stats.compiles:
        reg.histogram(f"{prefix}.compile_s").observe(
            stats.compile_s / stats.compiles)


def publish_scheduler_stats(stats, reg: MetricsRegistry,
                            prefix: str = "scheduler") -> None:
    """`repro_torch.launch.scheduler.SchedulerStats` → counters, plus one
    gauge pair per (B, mloc, engine) bucket for occupancy: served real
    lanes vs dispatched capacity."""
    for field in ("dispatches", "served", "filler_lanes",
                  "padded_requests", "preemptions", "resumes"):
        reg.counter(f"{prefix}.{field}").value = getattr(stats, field)
    for key, (served, capacity) in sorted(stats.per_bucket.items()):
        tag = f"B{key[0]}_mloc{key[1]}_{key[2]}"  # latency_summary's
        reg.gauge(f"{prefix}.bucket.{tag}.served").set(served)
        reg.gauge(f"{prefix}.bucket.{tag}.capacity").set(capacity)
        reg.gauge(f"{prefix}.bucket.{tag}.occupancy").set(
            served / capacity if capacity else 0.0)
