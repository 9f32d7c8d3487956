"""In-process metrics registry: counters, gauges, histograms (the JAX
package's ``obs/metrics.py``; its snapshots are equal for the same calls).

The shared substrate every subsystem (trainer, device-prefetcher,
checkpoint manager, supervisor, serve engine) records through instead of
ad-hoc dicts. Design constraints, in order:

  1. Recording must be cheap enough for hot host-side paths — a single
     lock acquire plus a float add. All aggregation is deferred to
     :meth:`MetricsRegistry.snapshot`.
  2. Label sets are BOUNDED: each metric holds at most
     ``max_series_per_metric`` distinct label combinations; overflow
     combinations are dropped (and counted in
     ``telemetry_dropped_series_total``) instead of growing without limit
     across a long run — the classic cardinality-explosion failure mode.
  3. Snapshots are plain dicts of plain floats, safe to JSON-encode, ship
     over the stats WebSocket, or render as Prometheus text
     (obs/prometheus.py) without holding the registry lock.

Instances are per-owner (a Trainer owns one, a serve Engine owns one) —
there is deliberately NO process-global default registry, so tests and
multi-trainer processes never double count.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Hot metrics are recorded every step window; keep the per-metric series
# bound well above any legitimate label fanout (goodput components,
# checkpoint kinds) but far below "one series per step".
DEFAULT_MAX_SERIES = 64

DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 300.0,
)

# Millisecond-scale buckets for request-latency histograms (TTFT and its
# components). DEFAULT_BUCKETS is seconds-scale and would collapse every
# sub-second TTFT into two buckets.
LATENCY_MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


def quantile_from_buckets(rows: List[List[Any]], count: int,
                          q: float) -> Optional[float]:
    """Estimate the ``q``-quantile from cumulative histogram buckets.

    ``rows`` is the snapshot shape ``[[le, cumulative_count], ...]`` with a
    trailing ``["+Inf", total]`` row.  Returns the upper bound of the first
    bucket whose cumulative count reaches rank ``q * count`` (the standard
    Prometheus-style estimate, biased high by at most one bucket width);
    None when the series is empty.  The +Inf bucket reports the largest
    finite bound so the answer stays plottable.
    """
    if count <= 0 or not rows:
        return None
    rank = q * count
    last_finite = None
    for le, cum in rows:
        if le != "+Inf":
            last_finite = float(le)
            if cum >= rank:
                return float(le)
    return last_finite


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    __slots__ = ("value",)

    # Guarded by the registry's lock, not a lock of its own.
    def __init__(self):
        self.value = 0.0


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)
        self.sum = 0.0
        self.count = 0


class _Metric:
    """One named metric: a family of label-keyed series."""

    def __init__(self, name: str, kind: str, help_text: str,
                 registry: "MetricsRegistry",
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.help = help_text
        self.buckets: Tuple[float, ...] = tuple(buckets or DEFAULT_BUCKETS)
        self._registry = registry
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    # All mutation goes through the registry lock: one lock for the whole
    # registry keeps the fast path to a single acquire and makes snapshot
    # a consistent cut across metrics.
    def _get_series(self, labels: Dict[str, str]):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self._registry.max_series_per_metric:
                self._registry._dropped += 1
                return None
            s = (_HistSeries(len(self.buckets)) if self.kind == "histogram"
                 else _Series())
            self._series[key] = s
        return s

    def inc(self, amount: float = 1.0, **labels) -> None:
        if self.kind != "counter":
            raise TypeError(f"{self.name} is a {self.kind}, not a counter")
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        with self._registry._lock:
            s = self._get_series(labels)
            if s is not None:
                s.value += float(amount)

    def set(self, value: float, **labels) -> None:
        if self.kind != "gauge":
            raise TypeError(f"{self.name} is a {self.kind}, not a gauge")
        with self._registry._lock:
            s = self._get_series(labels)
            if s is not None:
                s.value = float(value)

    def observe(self, value: float, **labels) -> None:
        if self.kind != "histogram":
            raise TypeError(f"{self.name} is a {self.kind}, not a histogram")
        v = float(value)
        with self._registry._lock:
            s = self._get_series(labels)
            if s is None:
                return
            s.counts[bisect.bisect_left(self.buckets, v)] += 1
            s.sum += v
            s.count += 1

    def value(self, **labels) -> float:
        """Current value of one counter/gauge series (0.0 if never touched)."""
        with self._registry._lock:
            s = self._series.get(_label_key(labels))
            return float(s.value) if isinstance(s, _Series) else 0.0


class MetricsRegistry:
    """Thread-safe registry; see module docstring for the contract."""

    def __init__(self, max_series_per_metric: int = DEFAULT_MAX_SERIES):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self.max_series_per_metric = int(max_series_per_metric)
        # label combos refused by the series bound
        self._dropped = 0

    def _declare(self, name: str, kind: str, help_text: str,
                 buckets: Optional[Iterable[float]] = None) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise TypeError(
                        f"metric {name} already registered as {m.kind}")
                return m
            m = _Metric(name, kind, help_text, self,
                        tuple(buckets) if buckets else None)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_text: str = "") -> _Metric:
        return self._declare(name, "counter", help_text)

    def gauge(self, name: str, help_text: str = "") -> _Metric:
        return self._declare(name, "gauge", help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Optional[Iterable[float]] = None) -> _Metric:
        return self._declare(name, "histogram", help_text, buckets)

    def snapshot(self) -> Dict[str, Any]:
        """Consistent point-in-time copy: plain dicts/floats only.

        Shape::

            {"metric_name": {"kind": ..., "help": ...,
                             "series": [{"labels": {...}, "value": f} |
                                        {"labels": {...}, "sum": f,
                                         "count": n, "buckets": [[le, n], ...]}]},
             ...,
             "_dropped_series": n}
        """
        out: Dict[str, Any] = {}
        with self._lock:
            for name, m in self._metrics.items():
                series: List[Dict[str, Any]] = []
                for key, s in m._series.items():
                    labels = dict(key)
                    if m.kind == "histogram":
                        cum, rows = 0, []
                        for le, c in zip(m.buckets, s.counts):
                            cum += c
                            rows.append([le, cum])
                        rows.append(["+Inf", cum + s.counts[-1]])
                        series.append({"labels": labels, "sum": s.sum,
                                       "count": s.count, "buckets": rows})
                    else:
                        series.append({"labels": labels, "value": s.value})
                out[name] = {"kind": m.kind, "help": m.help, "series": series}
            out["_dropped_series"] = self._dropped
        return out

    def sum_series(self, name: str, **labels) -> float:
        """Sum a counter/gauge across every series whose labels include
        ``labels`` (subset match; no labels = all series). The chaos
        harness asserts totals like "all injected faults fired" without
        enumerating label combinations."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m.kind == "histogram":
                return 0.0
            want = {(k, str(v)) for k, v in labels.items()}
            total = 0.0
            for key, s in m._series.items():
                if want <= set(key):
                    total += s.value
            return total

    def flat(self) -> Dict[str, float]:
        """Label-flattened scalar view for the stats WebSocket hub: gauges
        and counters only, keys ``name`` or ``name{k=v,...}``."""
        snap = self.snapshot()
        flat: Dict[str, float] = {}
        for name, m in snap.items():
            if name.startswith("_") or m["kind"] == "histogram":
                continue
            for s in m["series"]:
                if s["labels"]:
                    inner = ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
                    flat[f"{name}{{{inner}}}"] = s["value"]
                else:
                    flat[name] = s["value"]
        return flat
