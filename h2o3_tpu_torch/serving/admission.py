"""Admission control — bounded queues + backpressure for the scoring path.

A copy of `h2o3_tpu/serving/admission.py`.

Upstream H2O accepts every `/3/Predictions` request and lets the JVM heap
absorb the burst; under load that means OOM-killing the cloud. Here the
serving layer sheds load *at the door*: a global bound on
queued+in-flight requests plus a per-model in-flight bound. Overload
degrades to HTTP 429 + `Retry-After` — a signal load balancers and client
retry loops understand — instead of an unbounded host queue.

The controller is a counter, not a queue: the actual queueing lives in the
micro-batcher; admission only decides whether a request may join it.
"""

from __future__ import annotations

import threading
from typing import Dict

from .config import ServingConfig
from .metrics import ServingMetrics


class RejectedError(Exception):
    """Request shed by admission control → HTTP 429 + Retry-After."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class AdmissionController:
    def __init__(self, config: ServingConfig, metrics: ServingMetrics):
        self.config = config
        self.metrics = metrics
        self._lock = threading.Lock()
        self._total = 0
        self._per_model: Dict[str, int] = {}

    def admit(self, model_key: str) -> None:
        """Claim a slot or raise RejectedError. Pair with release()."""
        cfg = self.config
        # byte-side backpressure: past the ledger's shed threshold the
        # host/device budget is nearly exhausted — shedding at the door
        # (cheap cached read between refresh intervals) beats OOMing the
        # process mid-batch. Same 429 + Retry-After contract as the
        # queue bounds. (The reference reads it through its QoS gate's
        # shared snapshot, which the port has not: it has no training
        # artifact cache to shed beside it.)
        if cfg.shed_pressure > 0:
            from ..runtime import memory_ledger

            pr = memory_ledger.pressure()
            if pr >= cfg.shed_pressure:
                self.metrics.record_rejection(model_key)
                raise RejectedError(
                    f"memory pressure {pr:.2f} >= shed threshold "
                    f"{cfg.shed_pressure:.2f}; retry later",
                    cfg.retry_after_s)
        with self._lock:
            if self._total >= cfg.max_queue:
                self.metrics.record_rejection(model_key)
                raise RejectedError(
                    f"serving queue full ({self._total}/{cfg.max_queue} "
                    "in flight); retry later", cfg.retry_after_s)
            if self._per_model.get(model_key, 0) >= cfg.model_inflight:
                self.metrics.record_rejection(model_key)
                raise RejectedError(
                    f"model {model_key!r} at its in-flight limit "
                    f"({cfg.model_inflight}); retry later",
                    cfg.retry_after_s)
            self._total += 1
            self._per_model[model_key] = self._per_model.get(model_key,
                                                             0) + 1

    def release(self, model_key: str) -> None:
        with self._lock:
            self._total = max(self._total - 1, 0)
            n = self._per_model.get(model_key, 0) - 1
            if n > 0:
                self._per_model[model_key] = n
            else:
                self._per_model.pop(model_key, None)

    def stats(self) -> Dict:
        with self._lock:
            return dict(in_flight=self._total,
                        max_queue=self.config.max_queue,
                        model_inflight_limit=self.config.model_inflight,
                        per_model=dict(self._per_model))
