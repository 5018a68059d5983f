"""Serving configuration — every knob of the scoring subsystem in one place.

A copy of `h2o3_tpu/serving/config.py`. All knobs are env-overridable
(`H2O3_SERVING_*`) so a deployment can tune the batcher/admission behavior
without code changes. The defaults are the reference's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


from ..runtime import env_float as _env_float
from ..runtime import env_int as _env_int


@dataclass(frozen=True)
class ServingConfig:
    """Knobs of the four serving pieces."""

    # -- batcher (serving/batcher.py) --------------------------------------
    max_batch_rows: int = 8192     # coalesce up to this many rows per batch
    max_wait_ms: float = 2.0       # first request's max queue dwell
    request_timeout_s: float = 300.0   # caller-side wait bound (500 beyond)
    idle_worker_s: float = 30.0    # per-model worker thread expiry

    # -- admission control (serving/admission.py) --------------------------
    max_queue: int = 256           # global queued+in-flight request bound
    model_inflight: int = 64       # per-model admitted request bound
    retry_after_s: float = 1.0     # Retry-After hint on 429
    shed_pressure: float = 0.97    # memory-ledger pressure at which new
    #                                requests shed with 429 (0 disables)

    # -- compiled-scorer cache (serving/model_cache.py) --------------------
    cache_capacity: int = 32       # LRU entries (model × output_kind)

    # -- failover (serving/model_cache.FailoverState + batcher) ------------
    breaker_reset_s: float = 30.0  # open-breaker dwell before a half-open
    #                                probe retries the primary scorer
    cpu_fallback: bool = True      # degrade to the numpy artifact scorer
    #                                when the device scorer is quarantined

    @staticmethod
    def from_env() -> "ServingConfig":
        return ServingConfig(
            max_batch_rows=_env_int("H2O3_SERVING_MAX_BATCH_ROWS", 8192),
            max_wait_ms=_env_float("H2O3_SERVING_MAX_WAIT_MS", 2.0),
            request_timeout_s=_env_float("H2O3_SERVING_TIMEOUT_S", 300.0),
            idle_worker_s=_env_float("H2O3_SERVING_IDLE_WORKER_S", 30.0),
            max_queue=_env_int("H2O3_SERVING_MAX_QUEUE", 256),
            model_inflight=_env_int("H2O3_SERVING_MODEL_INFLIGHT", 64),
            retry_after_s=_env_float("H2O3_SERVING_RETRY_AFTER_S", 1.0),
            shed_pressure=_env_float("H2O3_SERVING_SHED_PRESSURE", 0.97),
            cache_capacity=_env_int("H2O3_SERVING_CACHE_CAPACITY", 32),
            breaker_reset_s=_env_float("H2O3_SERVING_BREAKER_RESET_S", 30.0),
            cpu_fallback=os.environ.get(
                "H2O3_SERVING_CPU_FALLBACK", "1") not in ("0", "false", ""),
        )
