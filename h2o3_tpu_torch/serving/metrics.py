"""Serving metrics — per-model counters + latency histograms.

A copy of `h2o3_tpu/serving/metrics.py`: the observability face of the
scoring subsystem (`ScoringEngine.snapshot()`; the reference also serves it
at `GET /3/Serving/metrics`, which the port has not yet: ROADMAP queue A,
item 11). Counter semantics:

- ``requests`` / ``rejections`` / ``errors``: admission-level accounting —
  every `/3/Predictions` call lands in exactly one of admitted (requests),
  shed (rejections), or admitted-but-failed (errors counts the failures
  among admitted requests).
- ``batches`` / ``batched_requests`` / ``batched_rows``: micro-batcher
  output — how many device dispatches served how much work.
- ``expired``: requests retired unscored at batch-pop time because their
  caller's wait had already timed out (the admission slot was released at
  expiry; scoring abandoned work would spend device time on nobody).
- ``compiles`` / ``cache_hits``: scorer cache — a compile is a scorer
  build OR the first batch of a padded row bucket (where the reference
  traced a program); a cache hit is a batch served by a warm bucket. The
  warm-path invariant the tests pin: a repeat request moves only
  ``cache_hits``.

Histograms are fixed-bound (log-spaced) so a snapshot is O(bounds), never
O(requests) — the histogram state is a counts vector, not a sample list.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

# log-ish spaced upper bounds; the last bucket is +inf (overflow)
WAIT_MS_BOUNDS = (0.5, 1, 2, 5, 10, 25, 50, 100, 250, 1000, 5000)
DEVICE_MS_BOUNDS = (1, 2, 5, 10, 25, 50, 100, 250, 1000, 5000, 30000)
BATCH_SIZE_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 512)

_COUNTERS = ("requests", "rejections", "errors", "batches",
             "batched_requests", "batched_rows", "compiles", "cache_hits",
             "expired", "scorer_faults", "quarantines", "scorer_rebuilds",
             "breaker_opens", "fallback_scores")

_REGISTRY = None


def _registry():
    """Central-registry families backing the serving counters/histograms.
    The per-engine ServingMetrics object stays the resettable snapshot
    state; the registry is the monotone process-wide view — both are
    written on every record. Model-key label
    cardinality is bounded by the registry itself (H2O3_METRICS_MAX_SERIES
    → `_overflow` series), so uuid-keyed model churn on a long-lived
    fleet cannot grow the scrape surface without limit."""
    global _REGISTRY
    if _REGISTRY is None:
        from ..runtime import metrics_registry as reg

        counters = {c: reg.counter(f"h2o3_serving_{c}",
                                   f"serving {c.replace('_', ' ')}",
                                   labelnames=("model",))
                    for c in _COUNTERS}
        for c in _COUNTERS:
            reg.bind_rest_field("serving", f"totals.{c}",
                                f"h2o3_serving_{c}")
        _REGISTRY = dict(
            counters=counters,
            queue_wait_ms=reg.histogram(
                "h2o3_serving_queue_wait_ms",
                "request dwell in the micro-batch queue (ms)",
                bounds=WAIT_MS_BOUNDS, labelnames=("model",)),
            device_ms=reg.histogram(
                "h2o3_serving_device_ms",
                "scoring-call wall time per batch (ms)",
                bounds=DEVICE_MS_BOUNDS, labelnames=("model",)),
            batch_size=reg.histogram(
                "h2o3_serving_batch_size",
                "requests coalesced per device batch",
                bounds=BATCH_SIZE_BOUNDS, labelnames=("model",)),
        )
    return _REGISTRY


class LatencyHistogram:
    """Fixed-bound histogram: counts per bucket + running sum/min/max."""

    __slots__ = ("bounds", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, bounds: Sequence[float]):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.n = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def record(self, v: float) -> None:
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.n += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def snapshot(self) -> Dict:
        return dict(
            bounds=list(self.bounds), counts=list(self.counts), count=self.n,
            mean=round(self.total / self.n, 4) if self.n else None,
            min=self.vmin, max=self.vmax,
        )


class _ModelStats:
    __slots__ = ("counters", "queue_wait_ms", "device_ms", "batch_size")

    def __init__(self):
        self.counters = {c: 0 for c in _COUNTERS}
        self.queue_wait_ms = LatencyHistogram(WAIT_MS_BOUNDS)
        self.device_ms = LatencyHistogram(DEVICE_MS_BOUNDS)
        self.batch_size = LatencyHistogram(BATCH_SIZE_BOUNDS)

    def snapshot(self) -> Dict:
        return dict(
            counters=dict(self.counters),
            histograms=dict(queue_wait_ms=self.queue_wait_ms.snapshot(),
                            device_ms=self.device_ms.snapshot(),
                            batch_size=self.batch_size.snapshot()),
        )


class ServingMetrics:
    """Thread-safe per-model stats registry (one per ScoringEngine)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[str, _ModelStats] = {}

    def _stats(self, model_key: str) -> _ModelStats:
        # callers hold self._lock
        s = self._models.get(model_key)
        if s is None:
            s = self._models[model_key] = _ModelStats()
        return s

    def _bump(self, model_key: str, counter: str, by: int = 1) -> None:
        with self._lock:
            self._stats(model_key).counters[counter] += by
        _registry()["counters"][counter].inc(by, model_key)

    # -- admission-level ----------------------------------------------------
    def record_request(self, model_key: str) -> None:
        self._bump(model_key, "requests")

    def record_rejection(self, model_key: str) -> None:
        self._bump(model_key, "rejections")

    def record_error(self, model_key: str) -> None:
        self._bump(model_key, "errors")

    def record_expired(self, model_key: str, n: int = 1) -> None:
        """Queued requests retired at pop time because their caller's wait
        already timed out — abandoned work that never reaches the device."""
        self._bump(model_key, "expired", by=n)

    # -- failover (serving/model_cache.FailoverState + batcher) -------------
    def record_scorer_fault(self, model_key: str) -> None:
        """A compiled scorer raised a device runtime error."""
        self._bump(model_key, "scorer_faults")

    def record_quarantine(self, model_key: str) -> None:
        """The poisoned scorer entry was evicted from the scorer cache."""
        self._bump(model_key, "quarantines")

    def record_rebuild(self, model_key: str) -> None:
        """A quarantined scorer was rebuilt and scored successfully."""
        self._bump(model_key, "scorer_rebuilds")

    def record_breaker_open(self, model_key: str) -> None:
        """The rebuild also failed — circuit breaker opened (CPU fallback
        serves until the half-open probe succeeds)."""
        self._bump(model_key, "breaker_opens")

    # -- batcher / cache level ---------------------------------------------
    def record_queue_wait(self, model_key: str, wait_s: float) -> None:
        with self._lock:
            self._stats(model_key).queue_wait_ms.record(wait_s * 1e3)
        _registry()["queue_wait_ms"].observe(wait_s * 1e3, model_key)

    def record_batch(self, model_key: str, n_requests: int, n_rows: int,
                     device_s: float, compiled: Optional[bool]) -> None:
        """`compiled` is True for a cold bucket, False for a warm-bucket
        hit, None when the batch was served by the CPU-fallback
        path (quarantine/breaker) — fallback batches must not inflate the
        compile/warm-hit accounting the cache tests pin."""
        with self._lock:
            s = self._stats(model_key)
            s.counters["batches"] += 1
            s.counters["batched_requests"] += n_requests
            s.counters["batched_rows"] += n_rows
            if compiled is None:
                s.counters["fallback_scores"] += 1
            else:
                s.counters["compiles" if compiled else "cache_hits"] += 1
            s.device_ms.record(device_s * 1e3)
            s.batch_size.record(float(n_requests))
        r = _registry()
        r["counters"]["batches"].inc(1, model_key)
        r["counters"]["batched_requests"].inc(n_requests, model_key)
        r["counters"]["batched_rows"].inc(n_rows, model_key)
        if compiled is None:
            r["counters"]["fallback_scores"].inc(1, model_key)
        else:
            r["counters"]["compiles" if compiled
                          else "cache_hits"].inc(1, model_key)
        r["device_ms"].observe(device_s * 1e3, model_key)
        r["batch_size"].observe(float(n_requests), model_key)

    # -- read side ----------------------------------------------------------
    def counter(self, model_key: str, name: str) -> int:
        with self._lock:
            s = self._models.get(model_key)
            return s.counters.get(name, 0) if s else 0

    def snapshot(self) -> Dict:
        with self._lock:
            models = {k: s.snapshot() for k, s in self._models.items()}
        totals = {c: sum(m["counters"][c] for m in models.values())
                  for c in _COUNTERS}
        return dict(models=models, totals=totals)

    def reset(self) -> None:
        with self._lock:
            self._models.clear()
