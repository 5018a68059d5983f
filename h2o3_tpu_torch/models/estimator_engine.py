"""Iteration engine for the non-tree estimators — the shared spine.

Port of `h2o3_tpu/models/estimator_engine.py`:

- **`legacy()`** — ``H2O3_EST_LEGACY=1`` selects the host per-iteration
  loops (for GLM: the f64 host solve after each Gram, and the host IRLS
  loop over the λ path) as the comparator of the fused device loops.
- **Shard plan** — `shard_plan()` is the one mode decision, the
  reference's: "off" (plain full-row reductions) on one rank by default;
  "blocks" under ``H2O3_EST_SHARD=1`` on one rank, every row reduction S
  = ``H2O3_EST_SHARD_BLOCKS`` (default 8) ordered block partials folded
  left to right (`fold_blocks`, the tree path's `ordered_axis_fold`);
  "mesh" on a pod (a cloud of several ranks), S = lcm(S, ranks), each rank
  holding S/N whole blocks of the canonical row layout
  (`parallel.distdata.to_canonical`: every real row in global ingest
  order, all pad at the global tail), its partials gathered in rank order
  and folded, so a pod fit equals the one-rank blocks-lane fit that shares
  S bit for bit. ``H2O3_EST_SHARD=0`` and the legacy switch give "off".
  `local_plan` (blocks a rank computes, the gather axis), `block_slices`
  (the one block grid) and `row_blocks` (each block its own contiguous
  tensor, so a block's kernels see the same shape and the same fresh
  allocation in both lanes) are what the estimators' loops share.
- **Cached matrices** — through the dataset cache's ``std`` layer
  (`dataset_cache.std_artifact`), so every fit, CV fold and sweep
  candidate that shares a (frame, x, parameters) triple reuses one
  extraction and one upload (``H2O3_DATASET_CACHE=0`` or the legacy
  switch builds them per fit, the same bits): `host_matrix`, the
  standardized f32 host matrix of `DataInfo.fit_transform` (K-Means draws
  its initial centres from it); `device_matrix`, that matrix padded to the
  block grid and uploaded once (K-Means, PCA); `design_matrix`, the
  compact-upload, device-expanded design of `DataInfo.device_design`
  (GLM, DeepLearning). `use_all_factor_levels` is normalized out of the
  key for all-numeric frames. The device keys carry the padded row count
  and the fit's layout. On a pod the global statistics and the canonical
  exchange are collectives, so they run eagerly in every fit, before any
  cache build: the host matrix is never cached there, and the device
  layers' layout is the cloud size, the rank and a `dataset_cache.digest`
  of the per-rank row counts, the statistics and this rank's canonical
  slice, so a hit on one rank and a miss on another never strand a rank
  inside a collective.
- **Observability** — per-fit plans (`record_fit`: algo, path — "fused",
  "fused_blocks", "fused_mesh", "host_fallback", "legacy" —, iterations,
  converged on the device, `n_shards`, `n_devices`) in a bounded ring read
  by `est_stats`, and the `h2o3_est_dispatch{algo,path}` /
  `h2o3_est_iterations{algo}` families of the port's metrics registry.

The reference's QoS segments, carry snapshots and program cache
(`segment_stops`, `segment_carry_*`, `cached_program`) are not ported: the
QoS gate is ROADMAP queue A, item 11, checkpoints item 5, and the port runs
eagerly, so there is no program to cache.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as devlib

def legacy() -> bool:
    """``H2O3_EST_LEGACY=1`` restores the host per-iteration estimator
    paths as the parity comparator (for GLM lambda search that is the host
    IRLS loop — the pre-device-program shape)."""
    return os.environ.get("H2O3_EST_LEGACY", "").lower() in ("1", "true",
                                                            "yes")


def shard_blocks() -> int:
    return max(int(os.environ.get("H2O3_EST_SHARD_BLOCKS", "8") or 8), 1)


def shard_plan(ndev: int, multiproc: bool) -> Tuple[str, int]:
    """(shard_mode, n_shards) for one estimator fit — the ONE place the
    decision is made, the reference's: "mesh" with S = lcm(S, ndev) on a
    cloud of several ranks (`ndev`, one device a rank) or processes,
    "blocks" with S under ``H2O3_EST_SHARD=1`` on one, "off" otherwise,
    and always under ``H2O3_EST_SHARD=0`` or the legacy switch."""
    env = os.environ.get("H2O3_EST_SHARD", "").strip()
    if legacy() or env == "0":
        return "off", 0
    base = shard_blocks()
    if multiproc or ndev > 1:
        return "mesh", base * ndev // math.gcd(base, ndev)
    if env == "1":
        return "blocks", base
    return "off", 0


def pod_switch_off() -> Optional[str]:
    """Why the engine's switches keep a pod fit off the mesh lane (the
    legacy comparator, ``H2O3_EST_SHARD=0``), or None."""
    if legacy():
        return "H2O3_EST_LEGACY=1 runs the one-rank host loops"
    if os.environ.get("H2O3_EST_SHARD", "").strip() == "0":
        return "H2O3_EST_SHARD=0 turns the mesh lane off"
    return None


def pad_rows(n: int, n_shards: int) -> int:
    """Rows padded to the canonical block grid (zero-filled, zero-weight
    rows — exact no-ops in every weighted reduction)."""
    if n_shards <= 0:
        return n
    return -(-n // n_shards) * n_shards


def local_plan(cloud, shard_mode: str, n_shards: int):
    """(local_blocks, axis_name) of one fit under the shard plan: the
    blocks THIS rank computes (mesh: its S/N; blocks: all S; off: 0, plain
    full-row reductions) and the axis its partials gather over (a pod's
    rows axis, else None)."""
    from ..parallel.mesh import ROWS_AXIS

    mesh = shard_mode == "mesh"
    local_blocks = n_shards // cloud.size if mesh else n_shards
    axis = ROWS_AXIS if mesh and cloud.size > 1 else None
    return local_blocks, axis


def block_slices(nrows: int, local_blocks: int):
    """The canonical per-block row slices of one rank's rows — every
    estimator's blocked partials cut this grid, or two fits sharing S
    would not be bit-comparable."""
    rows = nrows // local_blocks
    return [slice(i * rows, (i + 1) * rows) for i in range(local_blocks)]


def row_blocks(t: torch.Tensor, local_blocks: int):
    """`t`'s rows as `local_blocks` tensors of their own, each a fresh
    contiguous copy: a block then has the same shape, strides and
    allocation alignment in the blocks lane and on a pod, so BLAS, cuBLAS
    and torch's vector loops (whose SIMD tail is per tensor) compute it
    alike."""
    return [t[s].clone() for s in block_slices(t.shape[0], local_blocks)]


def fold_blocks(parts: torch.Tensor, axis_name: Optional[str]):
    """Deterministic ordered merge of per-block partials — the blocked-fold
    contract, `ops.histogram.ordered_axis_fold` itself, so the estimator
    loops and the tree path can never drift apart."""
    from ..ops.histogram import ordered_axis_fold

    return ordered_axis_fold(parts, axis_name)


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


def _space(dev: torch.device) -> str:
    return "device" if dev.type == "cuda" else "host"


def pod_rows(n_local: int, n_shards: int):
    """(per-rank row counts, npad) of a pod fit: one gather of the counts,
    and the GLOBAL row count padded to the block grid with the one-rank
    formula, so the pod cuts the blocks-lane fit's grid."""
    from ..parallel import distdata

    counts = distdata.row_counts(n_local)
    return counts, pad_rows(int(counts.sum()), n_shards)


def row_mask(n_local: int, n_shards: int):
    """(f32 mask of this rank's padded rows — 1 a real row, 0 a pad row —,
    the global row count): the weights of the matrices `device_matrix`
    pads, on one rank `pad_rows(n, n_shards)` rows, on a pod this rank's
    canonical slice."""
    from ..parallel import distdata

    ones = np.ones(n_local, np.float32)
    if distdata.multiprocess():
        counts, npad = pod_rows(n_local, n_shards)
        return distdata.to_canonical(ones, npad, counts=counts), \
            int(counts.sum())
    npad = pad_rows(n_local, n_shards)
    return np.concatenate([ones, np.zeros(npad - n_local, np.float32)]), \
        n_local


def _pod_layout(*facts) -> tuple:
    """A pod artifact's layout key: the cloud size, the rank and a digest
    of the global facts and this rank's canonical slice."""
    from ..parallel import mesh
    from . import dataset_cache

    c = mesh.cloud()
    return ("pod", c.size, c.self_idx, dataset_cache.digest(*facts))


# the host-clock split `DataInfo.device_design` books; a cached design
# books nothing, so its fit records zeros
_DESIGN_TIMINGS = ("pack_s", "h2d_s", "expand_s")


def design_matrix(frame, x, *, standardize: bool, use_all: bool = False,
                  add_intercept: bool = False, n_shards: int = 0,
                  device=None, timings=None):
    """(DataInfo, device design matrix) via `DataInfo.device_design` — the
    compact upload with the expansion on the device (small-range integer
    columns travel at 1-2 bytes/value; the dense one-hot never crosses the
    link), cached per (frame, x, standardize, expansion, intercept, padded
    rows, layout, device). Rows pad to `pad_rows(n, n_shards)` with
    zero-filled pack rows (the caller gives them zero weight). On a pod the
    statistics are global and the design is this rank's canonical slice of
    the padded global rows. `timings` receives the build's split, zeros on
    a hit."""
    from ..parallel import distdata, mesh
    from .model_base import DataInfo

    ua = _use_all_key(frame, x, use_all)
    dev = devlib.resolve(device)
    built = {}
    dinfo = DataInfo(frame, x, standardize=standardize,
                     use_all_factor_levels=ua, impute_missing=True)
    if distdata.multiprocess():
        t0 = time.perf_counter()
        counts, npad = pod_rows(frame.nrow, n_shards)
        # the collectives (statistics, transfer groups, the canonical
        # exchange) run here, on every rank, before any cache build
        packs = dinfo.design_packs(frame, fit=True, cloud=mesh.cloud(),
                                   quota=npad, counts=counts)
        built["pack_s"] = time.perf_counter() - t0
        layout = _pod_layout(counts, list(packs[1]), dinfo.means,
                             dinfo.stds)

        def build():
            Xd = dinfo.expand_packs(packs, add_intercept, dev, built)
            return (dinfo, Xd), Xd.numel() * 4, _space(dev)
    else:
        npad, layout = pad_rows(frame.nrow, n_shards), None

        def build():
            Xd = dinfo.device_design(frame, fit=True,
                                     add_intercept=add_intercept,
                                     row_bucket=n_shards, device=dev,
                                     timings=built)
            return (dinfo, Xd), Xd.numel() * 4, _space(dev)

    out = _std_artifact(frame, x, ("design", bool(standardize), ua,
                                   bool(add_intercept), int(npad), layout,
                                   str(dev)), build)
    if timings is not None:
        timings.update({k: built.get(k, 0.0) for k in _DESIGN_TIMINGS})
    return out


def host_matrix(frame, x, *, standardize: bool, use_all: bool = False,
                impute: bool = True):
    """(DataInfo, standardized float32 host matrix) for (frame, x): the
    reference's `host_matrix`, `DataInfo(...).fit_transform` byte for byte,
    cached. K-Means draws its initial centres from it. On a pod it is this
    rank's rows with the global moments, built in every fit (its
    statistics are collectives)."""
    from ..parallel import distdata
    from .model_base import DataInfo

    ua = _use_all_key(frame, x, use_all)

    def build():
        dinfo = DataInfo(frame, x, standardize=standardize,
                         use_all_factor_levels=ua, impute_missing=impute)
        X = dinfo.fit_transform(frame)
        return (dinfo, X), int(X.nbytes), "host"

    if distdata.multiprocess():
        return build()[0]
    return _std_artifact(frame, x, ("host", bool(standardize), ua,
                                    bool(impute)), build)


def device_matrix(frame, x, *, standardize: bool, use_all: bool = False,
                  impute: bool = True, n_shards: int = 0, device=None):
    """(DataInfo, host matrix, the matrix on `device`): the `host_matrix`
    padded to `pad_rows(n, n_shards)` with zero rows and uploaded once —
    bitwise the `fit_transform` values — that K-Means and PCA iterate on.
    On a pod the device matrix is this rank's canonical slice of the
    padded global rows (the host matrix stays this rank's own rows)."""
    from ..parallel import distdata

    ua = _use_all_key(frame, x, use_all)
    dev = devlib.resolve(device)
    # the host layer resolves outside the device layer's build: both live
    # on one cache entry, whose lock is held around a build
    dinfo, X = host_matrix(frame, x, standardize=standardize, use_all=ua,
                           impute=impute)
    layout = Xp = None
    if distdata.multiprocess():
        counts, npad = pod_rows(X.shape[0], n_shards)
        Xp = distdata.to_canonical(X, npad, counts=counts)
        layout = _pod_layout(counts, Xp, dinfo.means, dinfo.stds)
    else:
        npad = pad_rows(X.shape[0], n_shards)

    def build():
        Xh = Xp
        if Xh is None:
            Xh = X if npad == X.shape[0] else np.concatenate(
                [X, np.zeros((npad - X.shape[0], X.shape[1]), X.dtype)])
        Xd = torch.from_numpy(np.ascontiguousarray(Xh)).to(dev)
        return (dinfo, Xd), int(Xh.nbytes), _space(dev)

    _, Xd = _std_artifact(frame, x, ("dev", bool(standardize), ua,
                                     bool(impute), int(npad), layout,
                                     str(dev)), build)
    return dinfo, X, Xd


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
            "(fused/fused_blocks/fused_mesh/fused_path/host_fallback/"
            "legacy)",
            labelnames=("algo", "path"))
        _REG["iterations"] = _reg.counter(
            "h2o3_est_iterations",
            "estimator iterations executed inside fused device loops",
            labelnames=("algo",))
    return _REG


def record_fit(algo: str, path: str, *, iterations: Optional[int] = None,
               converged: Optional[bool] = None, n_shards: int = 0,
               n_devices: int = 1, **extra) -> dict:
    """Record one estimator fit's plan: how it dispatched (fused, blocked
    or meshed, vs legacy), its shards and ranks, how many device
    iterations it ran and whether the device-side convergence test fired.
    Ring + counters."""
    plan = dict(algo=algo, ts=time.time(), path=path,
                n_shards=int(n_shards), n_devices=int(n_devices))
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


def fused_path(shard_mode: str) -> str:
    """The recorded path of a fused fit under `shard_mode` (the
    reference's names)."""
    return {"mesh": "fused_mesh", "blocks": "fused_blocks"}.get(shard_mode,
                                                                "fused")
