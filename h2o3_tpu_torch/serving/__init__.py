"""Serving — the scoring subsystem (inference counterpart of the training
stack), a copy of `h2o3_tpu/serving/`.

Four cooperating pieces behind one `ScoringEngine` facade:

- `model_cache.ScorerCache` — LRU of scorer entries with padded-row-bucket
  warm sets.
- `batcher.MicroBatcher` — concurrent requests for one (model,
  output_kind) coalesce into a single padded device batch; results scatter
  back per request; a bad request fails alone.
- `admission.AdmissionController` — bounded in-flight counts; overload
  sheds with `RejectedError` (the reference's 429 + Retry-After) instead of
  exhausting the host.
- `metrics.ServingMetrics` — per-model counters + latency histograms.

A model scores on the device it was fit on (a tree model through the
hand-written forest kernel, `ops/score_cuda.py`, on the card; a GLM by its
design expansion and matvec on the device); the failover
layer degrades to the numpy MOJO scorer only on device errors, and counts
every batch it serves so. The reference's serving fleet (`registry.py`,
`router.py`) and its REST routes are not ported yet (ROADMAP queue A,
item 11).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .admission import AdmissionController, RejectedError  # noqa: F401
from .batcher import MicroBatcher
from .config import ServingConfig
from .metrics import ServingMetrics
from .model_cache import FailoverState, ScorerCache


class ScoringEngine:
    """Facade: admission → micro-batcher → scorer cache."""

    def __init__(self, config: Optional[ServingConfig] = None):
        self.config = config or ServingConfig.from_env()
        self.metrics = ServingMetrics()
        self.cache = ScorerCache(self.config.cache_capacity)
        # quarantine + circuit-breaker + numpy-fallback state (the failover
        # layer the batcher drives on device scorer errors)
        self.failover = FailoverState(self.config)
        self.batcher = MicroBatcher(self.cache, self.metrics, self.config,
                                    failover=self.failover)
        self.admission = AdmissionController(self.config, self.metrics)

    def score(self, model_key: str, model, frame,
              output_kind: str = "predict"):
        """Score `frame` with `model` through the serving path. Raises
        RejectedError under overload; re-raises the request's own scoring
        error otherwise."""
        self.admission.admit(model_key)
        try:
            self.metrics.record_request(model_key)
            try:
                return self.batcher.submit(model_key, model, frame,
                                           output_kind)
            except RejectedError:
                raise
            except BaseException:
                self.metrics.record_error(model_key)
                raise
        finally:
            self.admission.release(model_key)

    def snapshot(self) -> Dict:
        """Full observability document (the reference's /3/Serving/metrics
        body)."""
        out = self.metrics.snapshot()
        out["cache"] = self.cache.stats()
        out["admission"] = self.admission.stats()
        out["failover"] = self.failover.stats()
        out["config"] = dict(
            max_batch_rows=self.config.max_batch_rows,
            max_wait_ms=self.config.max_wait_ms,
            max_queue=self.config.max_queue,
            model_inflight=self.config.model_inflight,
            shed_pressure=self.config.shed_pressure,
            cache_capacity=self.config.cache_capacity,
            breaker_reset_s=self.config.breaker_reset_s,
            cpu_fallback=self.config.cpu_fallback,
        )
        return out

    def shutdown(self) -> None:
        self.batcher.shutdown()


_engine: Optional[ScoringEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> ScoringEngine:
    """The process-wide engine (lazily built from env config)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = ScoringEngine()
        return _engine


def peek_engine() -> Optional[ScoringEngine]:
    """The engine if one exists — metrics readers must not instantiate a
    serving stack just to report that there isn't one."""
    return _engine


def reset_engine(config: Optional[ServingConfig] = None) -> ScoringEngine:
    """Swap in a fresh engine (tests / config reload). The old engine's
    workers drain and expire on their own."""
    global _engine
    with _engine_lock:
        old, _engine = _engine, ScoringEngine(config)
        if old is not None:
            old.shutdown()
        return _engine
