"""Metrics registry: counters, gauges, and streaming-percentile
histograms with bounded memory.

Design constraints, in order:

1. **No unbounded sample storage.** Histograms fold observations into
   log-spaced fixed buckets plus (count, sum, min, max); percentiles are
   reconstructed by interpolating within the winning bucket. Memory per
   histogram is O(n_buckets) forever.
2. **Cheap writes.** A counter increment is one dict lookup + int add.
   The registry interns each (name, labels) series once and hands back
   the metric object, so hot callers hold a direct reference and never
   re-resolve labels per event.
3. **Deterministic export.** ``snapshot()`` sorts series by key so two
   runs over the same trace produce byte-identical JSON (used by the
   trace/metrics determinism tests).

Series are keyed ``name{k=v,...}`` with labels sorted by key — the
Prometheus convention, kept so the glossary in README maps 1:1.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple


def series_key(name: str, labels: Dict[str, object]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic accumulator. ``inc`` accepts float deltas so byte and
    second totals share the type with event counts."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        self.value += delta


class Gauge:
    """Last-write-wins point-in-time value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Streaming log-spaced histogram.

    Buckets span [lo, hi) decades with ``per_decade`` buckets per 10x;
    observations outside the span clamp into the first/last bucket (the
    exact min/max are kept separately so clamping never loses range
    information). Quantiles interpolate linearly inside the winning
    bucket — a ~(1/per_decade) relative-error estimator, plenty for
    telemetry and bounded forever.
    """

    __slots__ = ("lo", "per_decade", "buckets", "count", "sum",
                 "min", "max")

    N_DECADES = 12  # 1e-9 .. 1e3 by default covers ns..kiloseconds

    def __init__(self, lo: float = 1e-9, per_decade: int = 8) -> None:
        self.lo = lo
        self.per_decade = per_decade
        self.buckets = [0] * (self.N_DECADES * per_decade)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if x <= self.lo:
            idx = 0
        else:
            idx = int(math.log10(x / self.lo) * self.per_decade)
            if idx < 0:
                idx = 0
            elif idx >= len(self.buckets):
                idx = len(self.buckets) - 1
        self.buckets[idx] += 1

    def _bucket_edges(self, idx: int) -> Tuple[float, float]:
        lo = self.lo * 10.0 ** (idx / self.per_decade)
        hi = self.lo * 10.0 ** ((idx + 1) / self.per_decade)
        return lo, hi

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        target = q * self.count
        seen = 0
        for idx, n in enumerate(self.buckets):
            if n == 0:
                continue
            if seen + n >= target:
                lo, hi = self._bucket_edges(idx)
                frac = (target - seen) / n
                est = lo + (hi - lo) * frac
                # the true extrema are known exactly; never extrapolate
                # past them out of a clamped edge bucket
                return min(max(est, self.min), self.max)
            seen += n
        return self.max

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """One flat namespace of counters/gauges/histograms.

    ``counter()``/``gauge()``/``histogram()`` intern the series and
    return the live metric object; callers on hot-ish paths should hold
    the reference rather than re-resolving every event.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str, **labels: object) -> Counter:
        key = series_key(name, labels)
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels: object) -> Gauge:
        key = series_key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, **labels: object) -> Histogram:
        key = series_key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram()
        return h

    def snapshot(self) -> Dict[str, object]:
        """Deterministic (sorted-key) dump of every series."""
        return {
            "counters": {k: self._counters[k].value
                         for k in sorted(self._counters)},
            "gauges": {k: self._gauges[k].value
                       for k in sorted(self._gauges)},
            "histograms": {k: self._histograms[k].summary()
                           for k in sorted(self._histograms)},
        }

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        text = json.dumps(self.snapshot(), indent=indent, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def counter_value(self, name: str, **labels: object) -> float:
        key = series_key(name, labels)
        c = self._counters.get(key)
        return 0.0 if c is None else c.value

    def find(self, prefix: str) -> List[str]:
        """Series keys (all kinds) starting with ``prefix`` — test and
        glossary helper."""
        keys = [k for k in self._counters if k.startswith(prefix)]
        keys += [k for k in self._gauges if k.startswith(prefix)]
        keys += [k for k in self._histograms if k.startswith(prefix)]
        return sorted(keys)
