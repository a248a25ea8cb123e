"""Typed metrics registry — Counter / Gauge / Histogram instruments;
a copy of ``paddle_tpu/observability/metrics.py`` (the port imports
nothing of the JAX package).

The one metrics plane the port reports into (the STAT_* registry in
``paddle_tpu_torch.monitor`` is a shim over this module). Design points,
all in service of "scrape-able at any moment, zero unbounded state":

- instruments are label-capable: ``histogram("serving_ttft_seconds")
  .labels(engine="0")`` binds one *series* per label set, the
  Prometheus data model;
- histograms use FIXED log-scale buckets (default 4 per decade from
  1e-6 to 1e4), so p50/p95/p99 are derivable by interpolation without
  ever storing samples;
- everything is thread-safe behind one registry lock (engine threads,
  router dispatch workers and readers all touch it). The reference's
  lock joins its concurrency sanitizer under ``FLAGS_sanitize_locks``;
  the sanitizer is not ported, so this one is a plain ``RLock``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

# 4 buckets per decade, 1e-6 .. 1e4: spans ns-scale host timings to
# multi-hour totals whether callers observe seconds or milliseconds
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    10.0 ** (-6 + 0.25 * i) for i in range(41))

LabelsKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    """State of one (instrument, label-set) pair."""

    __slots__ = ("value", "count", "sum", "min", "max", "buckets")

    def __init__(self, n_buckets: int = 0):
        self.value = 0          # counter / gauge
        self.count = 0          # histogram observations
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: List[int] = [0] * n_buckets  # + overflow slot


class _Bound:
    """An instrument bound to one label set; exposes the same mutation
    and read methods the unlabeled instrument exposes."""

    def __init__(self, inst: "Instrument", key: LabelsKey):
        self._inst = inst
        self._key = key

    def add(self, value=1):
        return self._inst.add(value, _key=self._key)

    def inc(self):
        return self.add(1)

    def set(self, value):
        return self._inst.set(value, _key=self._key)

    def observe(self, value: float):
        return self._inst.observe(value, _key=self._key)

    @property
    def value(self):
        return self._inst.value_of(self._key)

    @property
    def count(self) -> int:
        return self._inst.count_of(self._key)

    @property
    def sum(self) -> float:
        return self._inst.sum_of(self._key)

    def quantile(self, q: float) -> Optional[float]:
        return self._inst.quantile(q, _key=self._key)


class Instrument:
    """Base: a named metric with zero or more label-bound series."""

    kind = "untyped"

    def __init__(self, name: str, help_str: str, lock: threading.RLock,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help_str
        self._lock = lock
        self.buckets_bounds: Tuple[float, ...] = tuple(buckets or ())
        self._series: Dict[LabelsKey, _Series] = {}

    # -- series plumbing --------------------------------------------------
    def labels(self, **labels) -> _Bound:
        return _Bound(self, _labels_key(labels))

    def _get(self, key: LabelsKey) -> _Series:
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _Series(
                len(self.buckets_bounds) + 1 if self.buckets_bounds else 0)
        return s

    def series(self) -> List[Tuple[LabelsKey, _Series]]:
        with self._lock:
            return list(self._series.items())

    # -- mutations (subclass-appropriate subset) --------------------------
    def add(self, value=1, _key: LabelsKey = ()):
        with self._lock:
            self._get(_key).value += value

    def inc(self, _key: LabelsKey = ()):
        self.add(1, _key=_key)

    def set(self, value, _key: LabelsKey = ()):
        with self._lock:
            self._get(_key).value = value

    def observe(self, value: float, _key: LabelsKey = ()):
        if not self.buckets_bounds:
            raise TypeError(f"{self.kind} {self.name!r} is not a histogram")
        v = float(value)
        with self._lock:
            s = self._get(_key)
            s.count += 1
            s.sum += v
            s.min = v if s.min is None else min(s.min, v)
            s.max = v if s.max is None else max(s.max, v)
            for i, bound in enumerate(self.buckets_bounds):
                if v <= bound:
                    s.buckets[i] += 1
                    break
            else:
                s.buckets[-1] += 1  # overflow

    # -- reads ------------------------------------------------------------
    def value_of(self, key: LabelsKey = ()):
        with self._lock:
            s = self._series.get(key)
            return 0 if s is None else s.value

    @property
    def value(self):
        return self.value_of(())

    def count_of(self, key: LabelsKey = ()) -> int:
        with self._lock:
            s = self._series.get(key)
            return 0 if s is None else s.count

    @property
    def count(self) -> int:
        return self.count_of(())

    def sum_of(self, key: LabelsKey = ()) -> float:
        with self._lock:
            s = self._series.get(key)
            return 0.0 if s is None else s.sum

    @property
    def sum(self) -> float:
        return self.sum_of(())

    def quantile(self, q: float, _key: LabelsKey = ()) -> Optional[float]:
        """Estimate the q-quantile (0 <= q <= 1) from the bucket counts
        by linear interpolation inside the crossing bucket, clamped to
        the observed [min, max] — exact enough for p50/p95/p99 ops
        dashboards, O(buckets) time, O(1) memory."""
        if not self.buckets_bounds:
            raise TypeError(f"{self.kind} {self.name!r} is not a histogram")
        with self._lock:
            s = self._series.get(_key)
            if s is None or s.count == 0:
                return None
            target = max(q, 0.0) * s.count
            cum = 0
            lo = 0.0
            est = s.max
            for bound, c in zip(self.buckets_bounds, s.buckets):
                if c and cum + c >= target:
                    frac = (target - cum) / c
                    est = lo + (bound - lo) * frac
                    break
                cum += c
                lo = bound
            return min(max(est, s.min), s.max)


class Counter(Instrument):
    """Monotonically increasing value (``set`` exists only so the
    monitor ``stat_set`` shim can keep its overwrite semantics)."""

    kind = "counter"


class Gauge(Instrument):
    """A value that goes up and down."""

    kind = "gauge"


class Histogram(Instrument):
    """Fixed log-scale-bucket distribution; see module docstring."""

    kind = "histogram"

    def percentiles(self, _key: LabelsKey = ()) -> Dict[str, Optional[float]]:
        return {"p50": self.quantile(0.50, _key),
                "p95": self.quantile(0.95, _key),
                "p99": self.quantile(0.99, _key)}


class MetricsRegistry:
    """Name -> instrument map with get-or-create constructors. A name
    registers with exactly one kind; a kind mismatch is a bug at the
    call site and raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._instruments: Dict[str, Instrument] = {}

    def _get_or_create(self, cls, name: str, help_str: str,
                       buckets=None) -> Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help_str, self._lock, buckets=buckets)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}")
            return inst

    def counter(self, name: str, help_str: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_str)

    def gauge(self, name: str, help_str: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_str)

    def histogram(self, name: str, help_str: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help_str,
                                   buckets=tuple(buckets or DEFAULT_BUCKETS))

    def get(self, name: str) -> Optional[Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def unregister(self, name: str):
        with self._lock:
            self._instruments.pop(name, None)

    def instruments(self) -> Dict[str, Instrument]:
        with self._lock:
            return dict(self._instruments)

    def reset(self):
        with self._lock:
            self._instruments.clear()


#: the process-wide registry every tier reports into
DEFAULT = MetricsRegistry()
