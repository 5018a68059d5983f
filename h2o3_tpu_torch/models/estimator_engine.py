"""Iteration engine for the non-tree estimators — the single-device spine.

Port of the parts of `h2o3_tpu/models/estimator_engine.py` a one-device fit
reaches:

- **`legacy()`** — ``H2O3_EST_LEGACY=1`` selects the host per-iteration
  loops (for GLM: the f64 host solve after each Gram, and the host IRLS
  loop over the λ path) as the comparator of the fused device loops.
- **Shard plan** — `shard_plan()` is the one mode decision. On one device
  it is "off": plain full-row reductions. The reference's "blocks" lane
  (``H2O3_EST_SHARD=1``, S ordered blocks forced on one device) and its
  "mesh" lane (several devices or processes) are not ported; asking for
  either raises (ROADMAP queue A, item 9).
- **Cached matrices** — through the dataset cache's ``std`` layer
  (`dataset_cache.std_artifact`, keyed by `_std_key`), so every fit, CV
  fold and sweep candidate that shares a (frame, x, parameters) triple
  reuses one extraction and one upload (``H2O3_DATASET_CACHE=0`` or the
  legacy switch builds them per fit, the same bits):
  `host_matrix`, the standardized f32 host matrix of
  `DataInfo.fit_transform` (K-Means draws its initial centres from it);
  `device_matrix`, that matrix uploaded once to the fit's device (K-Means,
  PCA); `design_matrix`, the compact-upload, device-expanded design of
  `DataInfo.device_design` (GLM, DeepLearning). `use_all_factor_levels`
  is normalized out of the key for all-numeric frames, so GLM and K-Means
  on one numeric frame share an entry, and K-Means and PCA one artifact.
  One device, unpadded: the reference's padded layouts for its blocked
  and mesh lanes are item 9.
- **Observability** — per-fit plans (`record_fit`: algo, path, iterations,
  converged on the device) in a bounded ring read by `est_stats`, and the
  `h2o3_est_dispatch{algo,path}` / `h2o3_est_iterations{algo}` families of
  the port's metrics registry.

The reference's QoS segments, carry snapshots and program cache
(`segment_stops`, `segment_carry_*`, `cached_program`) are not ported: the
QoS gate is ROADMAP queue A, item 11, checkpoints item 5, and the port runs
eagerly, so there is no program to cache.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as devlib

_ITEM9 = "(ROADMAP queue A, item 9)"


def legacy() -> bool:
    """``H2O3_EST_LEGACY=1`` restores the host per-iteration estimator
    paths as the parity comparator (for GLM lambda search that is the host
    IRLS loop — the pre-device-program shape)."""
    return os.environ.get("H2O3_EST_LEGACY", "").lower() in ("1", "true",
                                                            "yes")


def shard_plan(ndev: int, multiproc: bool) -> Tuple[str, int]:
    """(shard_mode, n_shards) for one estimator fit — the ONE place the
    decision is made. "off" (plain full-row reductions) on one device, for
    the legacy comparator and for ``H2O3_EST_SHARD=0``; the blocked lanes
    raise."""
    env = os.environ.get("H2O3_EST_SHARD", "").strip()
    if legacy() or env == "0":
        return "off", 0
    if multiproc or ndev > 1:
        raise NotImplementedError(
            f"the estimator engine's mesh lane over {ndev} devices is not "
            f"ported {_ITEM9}")
    if env == "1":
        raise NotImplementedError(
            "the estimator engine's forced-block lane (H2O3_EST_SHARD=1) is "
            f"not ported {_ITEM9}")
    return "off", 0


def pad_rows(n: int, n_shards: int) -> int:
    """Rows padded to the canonical block grid (zero-filled, zero-weight
    rows — exact no-ops in every weighted reduction)."""
    if n_shards <= 0:
        return n
    return -(-n // n_shards) * n_shards


def cache_enabled() -> bool:
    from . import dataset_cache

    return dataset_cache.enabled() and not legacy()


def _use_all_key(frame, x, use_all: bool) -> bool:
    """`use_all_factor_levels` only changes the design when a categorical
    column exists; the reference normalizes it out of its cache key for
    all-numeric frames, and so of the `DataInfo` it builds."""
    return bool(use_all) and any(frame.vec(c).type == "enum" for c in x)


def _std_artifact(frame, x, skey: tuple, build):
    """`build()` → ((value), nbytes, space), through the std layer when the
    cache is on."""
    if not cache_enabled():
        return build()[0]
    from . import dataset_cache

    return dataset_cache.std_artifact(frame, x, skey, build)


# the host-clock split `DataInfo.device_design` books; a cached design
# books nothing, so its fit records zeros
_DESIGN_TIMINGS = ("pack_s", "h2d_s", "expand_s")


def design_matrix(frame, x, *, standardize: bool, use_all: bool = False,
                  add_intercept: bool = False, device=None, timings=None):
    """(DataInfo, device design matrix) via `DataInfo.device_design` — the
    compact upload with the expansion on the device (small-range integer
    columns travel at 1-2 bytes/value; the dense one-hot never crosses the
    link), cached per (frame, x, standardize, expansion, intercept,
    device). `timings` receives the build's split, zeros on a hit."""
    from .model_base import DataInfo

    ua = _use_all_key(frame, x, use_all)
    dev = devlib.resolve(device)
    built = {}

    def build():
        dinfo = DataInfo(frame, x, standardize=standardize,
                         use_all_factor_levels=ua, impute_missing=True)
        Xd = dinfo.device_design(frame, fit=True, add_intercept=add_intercept,
                                 device=dev, timings=built)
        nbytes = Xd.numel() * Xd.element_size()
        return (dinfo, Xd), nbytes, "device" if dev.type == "cuda" else "host"

    out = _std_artifact(frame, x, ("design", bool(standardize), ua,
                                   bool(add_intercept), str(dev)), build)
    if timings is not None:
        timings.update({k: built.get(k, 0.0) for k in _DESIGN_TIMINGS})
    return out


def host_matrix(frame, x, *, standardize: bool, use_all: bool = False,
                impute: bool = True):
    """(DataInfo, standardized float32 host matrix) for (frame, x): the
    reference's `host_matrix`, `DataInfo(...).fit_transform` byte for byte,
    cached. K-Means draws its initial centres from it."""
    from .model_base import DataInfo

    ua = _use_all_key(frame, x, use_all)

    def build():
        dinfo = DataInfo(frame, x, standardize=standardize,
                         use_all_factor_levels=ua, impute_missing=impute)
        X = dinfo.fit_transform(frame)
        return (dinfo, X), int(X.nbytes), "host"

    return _std_artifact(frame, x, ("host", bool(standardize), ua,
                                    bool(impute)), build)


def device_matrix(frame, x, *, standardize: bool, use_all: bool = False,
                  impute: bool = True, device=None):
    """(DataInfo, the `host_matrix` on `device`): one cached upload that
    K-Means and PCA iterate on, bitwise the `fit_transform` values."""
    ua = _use_all_key(frame, x, use_all)
    dev = devlib.resolve(device)
    # the host layer resolves outside the device layer's build: both live
    # on one cache entry, whose lock is held around a build
    dinfo, X = host_matrix(frame, x, standardize=standardize, use_all=ua,
                           impute=impute)

    def build():
        Xd = torch.from_numpy(np.ascontiguousarray(X)).to(dev)
        return (dinfo, Xd), int(X.nbytes), \
            "device" if dev.type == "cuda" else "host"

    return _std_artifact(frame, x, ("dev", bool(standardize), ua,
                                    bool(impute), str(dev)), build)


# -- observability ------------------------------------------------------------

_PLAN_LOCK = threading.Lock()
_PLANS: "deque" = deque(maxlen=16)
_REG: dict = {}


def _registry() -> dict:
    """Memoized registry families (recording a fit must not take the
    registry's registration lock)."""
    if not _REG:
        from ..runtime import metrics_registry as _reg

        _REG["dispatch"] = _reg.counter(
            "h2o3_est_dispatch",
            "estimator-engine fit dispatches by algo and resolved path "
            "(fused/fused_path/host_fallback/legacy)",
            labelnames=("algo", "path"))
        _REG["iterations"] = _reg.counter(
            "h2o3_est_iterations",
            "estimator iterations executed inside fused device loops",
            labelnames=("algo",))
    return _REG


def record_fit(algo: str, path: str, *, iterations: Optional[int] = None,
               converged: Optional[bool] = None, n_shards: int = 0,
               **extra) -> dict:
    """Record one estimator fit's plan: how it dispatched (fused vs
    legacy), how many device iterations it ran and whether the device-side
    convergence test fired. Ring + counters."""
    plan = dict(algo=algo, ts=time.time(), path=path,
                n_shards=int(n_shards), n_devices=1)
    if iterations is not None:
        plan["iterations"] = int(iterations)
    if converged is not None:
        plan["converged"] = bool(converged)
    plan.update(extra)
    with _PLAN_LOCK:
        _PLANS.append(plan)
    reg = _registry()
    reg["dispatch"].inc(1, algo, path)
    if iterations:
        reg["iterations"].inc(int(iterations), algo)
    from ..runtime import tracing as _tracing

    _tracing.event("est_fit", algo=algo, path=path, iterations=iterations,
                   n_shards=n_shards)
    return plan


def est_stats() -> dict:
    """Per-fit plans + cumulative dispatch/iteration counters. Pure
    counter read — never fits anything."""
    with _PLAN_LOCK:
        plans = list(_PLANS)
    reg = _registry()
    return dict(
        plans=plans,
        dispatch={"/".join(lv): c.value()
                  for lv, c in reg["dispatch"].children().items()},
        iterations={lv[0]: c.value()
                    for lv, c in reg["iterations"].children().items()})


def reset_plans() -> None:
    """Drop the plan ring (tests). Registry counters are monotone and stay."""
    with _PLAN_LOCK:
        _PLANS.clear()
