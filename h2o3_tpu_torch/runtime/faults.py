"""Fault injection — deterministic, seedable failure points in the runtime.

A copy of `h2o3_tpu/runtime/faults.py` (JAX-free). The serving failover
path (quarantine, circuit breaker, numpy fallback) is only trustworthy if
its failure paths are exercised, not just written; this registry lets tests
and operators arm specific failure points without touching product code.
Every wired call site costs one dict lookup when nothing is armed (the
`_ACTIVE` fast path).

The port wires these points: ``serving.scorer`` raises inside the
compiled scorer's call (`serving/model_cache.CompiledScorer.score`),
``trainpool.candidate`` before each attempt at a train-pool candidate
(`runtime/trainpool.TrainPool`, the candidate's name as the detail), and
``persist.open``, ``persist.read`` and ``persist.list`` in the local-file
persist backend (`runtime/persist.py`, the path as the detail), which the
block store's disk tier reads its spill files through. The reference's
other points (client, mesh, qos, supervisor) arrive with their modules
(ROADMAP queue A, item 11).

Arming — programmatic or env:

* ``faults.arm("serving.scorer", error="device", rate=0.01, seed=7)``
* ``H2O3_FAULT_SERVING_SCORER="error=device,rate=0.01,seed=7"`` (the
  subsystem dot maps to the FIRST underscore, upper-cased — later
  underscores stay)

Determinism: ``count=N`` fires the FIRST N checks of a point; ``rate=p``
draws from a dedicated ``numpy.random.default_rng(seed)`` per point, so the
same seed produces the same fire sequence. Fault points are DEFAULT-OFF;
`reset()` disarms all.

``latency_ms`` injects sleep without (or in addition to) an error.
``match=substr`` scopes a point to checks whose detail string contains the
substring (one model's traffic). The reference's ``lane=`` and ``after=``
scoping serve its mesh fault points, which the port has not yet.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = ["FaultInjected", "InjectedIOError", "InjectedConnectionError",
           "InjectedDeviceError", "InjectedCrash", "arm", "disarm", "reset",
           "check", "snapshot", "active"]


class FaultInjected(Exception):
    """Marker base: every injected error is recognizable as synthetic."""


class InjectedIOError(FaultInjected, IOError):
    """Injected persist/storage I/O failure (transient)."""


class InjectedConnectionError(FaultInjected, ConnectionError):
    """Injected HTTP/connection drop (transient)."""


class InjectedDeviceError(FaultInjected, RuntimeError):
    """Injected device runtime failure (transient, quarantine-class)."""


class InjectedCrash(FaultInjected, RuntimeError):
    """Injected permanent failure — retry must NOT mask it."""


ERROR_KINDS = {
    "io": InjectedIOError,
    "conn": InjectedConnectionError,
    "device": InjectedDeviceError,
    "crash": InjectedCrash,
    "none": None,          # latency-only point
}


class _Point:
    __slots__ = ("name", "kind", "rate", "count", "latency_ms", "seed",
                 "match", "checks", "fires", "_rng")

    def __init__(self, name: str, kind: str, rate: float,
                 count: Optional[int], latency_ms: float, seed: int,
                 match: Optional[str] = None):
        if kind not in ERROR_KINDS:
            raise ValueError(f"unknown fault error kind {kind!r} "
                             f"(one of {sorted(ERROR_KINDS)})")
        self.name = name
        self.kind = kind
        self.rate = float(rate)
        self.count = None if count in (None, "") else int(count)
        self.latency_ms = float(latency_ms)
        self.seed = int(seed)
        # detail-scoped points: only checks whose detail string contains
        # `match` fire — e.g. arm("serving.scorer", match="m@v2") fails
        # exactly one model version's traffic
        self.match = match or None
        self.checks = 0
        self.fires = 0
        self._rng = None    # built lazily; numpy import stays off hot path

    def should_fire(self) -> bool:
        if self.kind == "none":
            return False
        if self.count is not None:
            return self.fires < self.count
        if self.rate >= 1.0:
            return True
        if self.rate <= 0.0:
            return False
        if self._rng is None:
            import numpy as np

            self._rng = np.random.default_rng(self.seed)
        return bool(self._rng.random() < self.rate)

    def describe(self) -> Dict:
        return dict(point=self.name, error=self.kind, rate=self.rate,
                    count=self.count, latency_ms=self.latency_ms,
                    seed=self.seed, match=self.match, checks=self.checks,
                    fires=self.fires)


_LOCK = threading.Lock()
_POINTS: Dict[str, _Point] = {}
_ACTIVE = False           # fast-path flag: no armed points → check() is free
_TOTAL_FIRES = 0


def _env_parse() -> None:
    """Arm points from H2O3_FAULT_* env vars (once, at import)."""
    for k, v in os.environ.items():
        if not k.startswith("H2O3_FAULT_") or not v:
            continue
        # point names are <subsystem>.<name> where <name> may itself
        # carry underscores: only the first maps to a dot
        point = k[len("H2O3_FAULT_"):].lower().replace("_", ".", 1)
        if v in ("1", "true", "on"):
            arm(point)
            continue
        kw: Dict[str, str] = {}
        try:
            for part in v.split(","):
                key, _, val = part.partition("=")
                kw[key.strip()] = val.strip()
            arm(point,
                error=kw.get("error", "io"),
                rate=float(kw.get("rate", 1.0)),
                count=int(kw["count"]) if kw.get("count") else None,
                latency_ms=float(kw.get("latency_ms", 0.0)),
                seed=int(kw.get("seed", 0)),
                match=kw.get("match") or None)
        except (ValueError, TypeError) as e:
            raise ValueError(f"bad {k}={v!r}: {e}") from None


def arm(point: str, error: str = "io", rate: float = 1.0,
        count: Optional[int] = None, latency_ms: float = 0.0,
        seed: int = 0, match: Optional[str] = None) -> Dict:
    """Arm one fault point; returns its description. `match` scopes the
    point to checks whose detail contains the substring."""
    global _ACTIVE
    p = _Point(point, error, rate, count, latency_ms, seed, match=match)
    with _LOCK:
        _POINTS[point] = p
        _ACTIVE = True
    return p.describe()


def disarm(point: str) -> bool:
    global _ACTIVE
    with _LOCK:
        existed = _POINTS.pop(point, None) is not None
        _ACTIVE = bool(_POINTS)
    return existed


def reset() -> None:
    global _ACTIVE, _TOTAL_FIRES
    with _LOCK:
        _POINTS.clear()
        _ACTIVE = False
        _TOTAL_FIRES = 0


def active() -> bool:
    return _ACTIVE


def check(point: str, detail: str = "") -> None:
    """The wired call sites' hook: no-op unless `point` is armed; sleeps
    the configured latency, then raises the configured error class when
    the deterministic schedule says so."""
    if not _ACTIVE:             # unlocked fast path: default-off is free
        return
    global _TOTAL_FIRES
    with _LOCK:
        p = _POINTS.get(point)
        if p is None:
            return
        if p.match is not None and p.match not in (detail or ""):
            return
        p.checks += 1
        fire = p.should_fire()
        if fire:
            p.fires += 1
            _TOTAL_FIRES += 1
        latency = p.latency_ms
        kind = ERROR_KINDS[p.kind]
    if fire:
        # observability spine: fired injections are scrapable and annotate
        # the owning span (only on fire — the disarmed fast path above and
        # the armed-but-quiet path stay allocation-free)
        from . import metrics_registry as _reg
        from . import tracing as _tracing

        _fired_counter(_reg).inc(1, point)
        _tracing.event("fault_fired", point=point, kind=p.kind,
                       **(dict(detail=detail) if detail else {}))
    if latency:
        time.sleep(latency / 1e3)
    if fire and kind is not None:
        raise kind(f"injected fault at {point}"
                   + (f" ({detail})" if detail else ""))


_FIRED = None


def _fired_counter(reg):
    global _FIRED
    if _FIRED is None:
        _FIRED = reg.counter("h2o3_fault_fires",
                             "injected faults fired, per armed point",
                             labelnames=("point",))
    return _FIRED


def snapshot() -> Dict:
    """Armed points + fire counts (GET /3/Faults, /3/Profiler fold)."""
    with _LOCK:
        pts = [p.describe() for p in _POINTS.values()]
        return dict(active=bool(pts), points=pts, total_fires=_TOTAL_FIRES)


_env_parse()
