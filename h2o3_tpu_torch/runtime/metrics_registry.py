"""Central metrics registry — the one store every subsystem's counters,
gauges and histograms register in.

A copy of the parts of `h2o3_tpu/runtime/metrics_registry.py` that the
port's serving path reaches: the three metric kinds (read per metric:
`Counter.value`, `Histogram.percentile`), get-or-create registration and
the REST-field bindings. The reference's Prometheus text exposition, JSON
snapshot with its collect hooks, lossless export and ring-buffer rates
belong to its REST surface (ROADMAP queue A, item 11).

Semantics follow Prometheus: registry counters are MONOTONE for the life of
the process (module-level ``reset()`` helpers of other modules reset their
own snapshot state, never the registry). Cost discipline: one
``threading.Lock`` per metric child and a handful of adds per record.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from . import env_int

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "get", "bind_rest_field", "rest_bindings", "bucket_percentile",
           "LATENCY_MS_BOUNDS"]

# shared fixed latency buckets (ms)
LATENCY_MS_BOUNDS = (0.5, 1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
                     5000, 10000, 30000)

# label cardinality bound per family: series are monotone for the life of
# the process, so an unbounded label (uuid-suffixed model keys) would grow
# without limit — past the cap, new label tuples collapse into one
# "_overflow" series (totals stay correct)
_MAX_SERIES = env_int("H2O3_METRICS_MAX_SERIES", 256)
_OVERFLOW = "_overflow"


def bucket_percentile(bounds, counts, n, q, vmin=None, vmax=None):
    """Bucket-interpolated q-quantile (q in [0,1]) over raw (bounds,
    counts): linear interpolation within the owning bucket, min/max
    clamping the open-ended buckets."""
    if not n:
        return None
    rank = q * (n - 1)
    cum = 0
    for i, cnt in enumerate(counts):
        if cnt == 0:
            continue
        if rank < cum + cnt:
            lo = bounds[i - 1] if i > 0 else (
                vmin if vmin is not None else 0.0)
            hi = bounds[i] if i < len(bounds) else (
                vmax if vmax is not None else lo)
            lo = max(lo, vmin) if vmin is not None else lo
            hi = min(hi, vmax) if vmax is not None else hi
            if hi <= lo:
                return float(lo)
            frac = (rank - cum + 1) / cnt if cnt > 1 else 0.5
            frac = min(max(frac, 0.0), 1.0)
            return float(lo + (hi - lo) * frac)
        cum += cnt
    return vmax


def _sanitize_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        ok = ch.isascii() and (ch.isalpha() or ch == "_"
                               or (ch.isdigit() and i > 0))
        out.append(ch if ok else "_")
    return "".join(out)


class _Child:
    """One labeled series of a family: the actual mutation target. Every
    update takes this child's own lock and nothing else."""

    __slots__ = ("labels", "_lock", "_v")

    def __init__(self, labels: Tuple[str, ...]):
        self.labels = labels
        self._lock = threading.Lock()
        self._v = 0.0

    def _add(self, by: float) -> None:
        with self._lock:
            self._v += by

    def _set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def value(self) -> float:
        with self._lock:
            return self._v


class _Metric:
    """One metric family: name + help + fixed label names + children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = _sanitize_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}

    def _child(self, labelvalues: Tuple[str, ...]) -> _Child:
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{labelvalues}")
        c = self._children.get(labelvalues)
        if c is None:
            with self._lock:
                c = self._children.get(labelvalues)
                if c is None:
                    if self.labelnames and len(self._children) >= _MAX_SERIES:
                        labelvalues = (_OVERFLOW,) * len(self.labelnames)
                        c = self._children.get(labelvalues)
                        if c is None:
                            c = self._children[labelvalues] = \
                                self._make_child(labelvalues)
                    else:
                        c = self._children[labelvalues] = self._make_child(
                            labelvalues)
        return c

    def _make_child(self, labelvalues: Tuple[str, ...]) -> _Child:
        return _Child(labelvalues)

    def children(self) -> Dict[Tuple[str, ...], _Child]:
        with self._lock:
            return dict(self._children)


class Counter(_Metric):
    """Monotone counter (optionally labeled)."""

    kind = "counter"

    def inc(self, by: float = 1.0, *labelvalues) -> None:
        if by < 0:
            raise ValueError(f"{self.name}: counters only go up (by={by})")
        self._child(tuple(str(v) for v in labelvalues))._add(by)

    def value(self, *labelvalues) -> float:
        key = tuple(str(v) for v in labelvalues)
        if key not in self._children:
            return 0.0
        return self._child(key).value()

    def total(self) -> float:
        return sum(c.value() for c in self.children().values())


class Gauge(_Metric):
    """Settable value."""

    kind = "gauge"

    def set(self, v: float, *labelvalues) -> None:
        self._child(tuple(str(x) for x in labelvalues))._set(v)

    def value(self, *labelvalues) -> float:
        key = tuple(str(v) for v in labelvalues)
        if key not in self._children:
            return 0.0
        return self._child(key).value()


class _HistChild(_Child):
    __slots__ = ("counts", "n", "total", "vmin", "vmax")

    def __init__(self, labels: Tuple[str, ...], nbuckets: int):
        super().__init__(labels)
        self.counts = [0] * nbuckets
        self.n = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None


class Histogram(_Metric):
    """Fixed-bound histogram: counts per bucket + running sum/min/max. The
    state is O(len(bounds)) whatever the observation count; the last bucket
    is +Inf overflow."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 bounds: Sequence[float] = LATENCY_MS_BOUNDS,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        b = tuple(float(x) for x in bounds)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"{name}: bounds must be strictly increasing")
        self.bounds = b

    def _make_child(self, labelvalues: Tuple[str, ...]) -> _HistChild:
        return _HistChild(labelvalues, len(self.bounds) + 1)

    def observe(self, v: float, *labelvalues) -> None:
        c = self._child(tuple(str(x) for x in labelvalues))
        i = len(self.bounds)
        for j, b in enumerate(self.bounds):
            if v <= b:
                i = j
                break
        with c._lock:
            c.counts[i] += 1
            c.n += 1
            c.total += v
            c.vmin = v if c.vmin is None else min(c.vmin, v)
            c.vmax = v if c.vmax is None else max(c.vmax, v)

    def _counts(self, *labelvalues) -> Tuple[List[int], int, float,
                                             Optional[float],
                                             Optional[float]]:
        # the read path must not materialize a series for an unknown label
        key = tuple(str(x) for x in labelvalues)
        c = self._children.get(key)
        if c is None:
            return [0] * (len(self.bounds) + 1), 0, 0.0, None, None
        with c._lock:
            return list(c.counts), c.n, c.total, c.vmin, c.vmax

    def percentile(self, q: float, *labelvalues) -> Optional[float]:
        """Estimate the q-quantile (q in [0,1]) by linear interpolation
        within the owning bucket; min/max clamp the open-ended buckets."""
        counts, n, _total, vmin, vmax = self._counts(*labelvalues)
        return bucket_percentile(self.bounds, counts, n, q, vmin, vmax)

    def summary(self, *labelvalues) -> Dict:
        counts, n, total, vmin, vmax = self._counts(*labelvalues)
        return dict(
            bounds=list(self.bounds), counts=counts, count=n,
            mean=round(total / n, 4) if n else None,
            min=vmin, max=vmax,
            p50=self.percentile(0.50, *labelvalues),
            p95=self.percentile(0.95, *labelvalues),
            p99=self.percentile(0.99, *labelvalues),
        )


# -- the registry -------------------------------------------------------------

_LOCK = threading.Lock()
_METRICS: Dict[str, _Metric] = {}
# endpoint → {field_path: metric_name}: which registry metric backs each
# snapshot field
_REST_BINDINGS: Dict[str, Dict[str, str]] = {}


def _register(cls, name: str, help: str, **kw) -> _Metric:
    name = _sanitize_name(name)
    with _LOCK:
        m = _METRICS.get(name)
        if m is not None:
            if type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m
        m = _METRICS[name] = cls(name, help, **kw)
        return m


def counter(name: str, help: str = "",
            labelnames: Sequence[str] = ()) -> Counter:
    """Get-or-create a counter family (idempotent by name)."""
    return _register(Counter, name, help, labelnames=labelnames)


def gauge(name: str, help: str = "",
          labelnames: Sequence[str] = ()) -> Gauge:
    return _register(Gauge, name, help, labelnames=labelnames)


def histogram(name: str, help: str = "",
              bounds: Sequence[float] = LATENCY_MS_BOUNDS,
              labelnames: Sequence[str] = ()) -> Histogram:
    return _register(Histogram, name, help, bounds=bounds,
                     labelnames=labelnames)


def get(name: str) -> Optional[_Metric]:
    with _LOCK:
        return _METRICS.get(_sanitize_name(name))


def bind_rest_field(endpoint: str, field_path: str, metric_name: str) -> None:
    """Declare that `field_path` of the `{endpoint}` metrics document is
    backed by registry metric `metric_name`."""
    with _LOCK:
        _REST_BINDINGS.setdefault(endpoint, {})[field_path] = \
            _sanitize_name(metric_name)


def rest_bindings() -> Dict[str, Dict[str, str]]:
    with _LOCK:
        return {k: dict(v) for k, v in _REST_BINDINGS.items()}
