"""Train pool — bounded scheduler for multi-model training sweeps.

A copy of `h2o3_tpu/runtime/trainpool.py`, rewired to the port. Grid
search (`models/grid.py`) and AutoML (`automl/automl.py`) submit candidate
builds here. With ``parallelism=N`` up to N candidates are in flight at
once, each on a thread of its own: the card runs their kernels in the
order the threads enqueue them, while each candidate's host work (frame
to matrix, binning, packing, metrics) overlaps its siblings' device work.
Results come back in SUBMISSION order, so ``parallelism=2`` gives the same
model list, and therefore the same leaderboard, as ``parallelism=1``;
every fit is seed-deterministic (the trees' histograms and leaf totals on
the card are fixed-point sums, exact in any order).

One card, one process: where the reference asks its mesh whether training
must be serialized (multi-device XLA:CPU thunk pools, multi-process
clouds), the port has neither, so the requested parallelism stands and
``parallelism=1`` is the sequential walk. Two threads never build or
load one kernel library at once: each library's build runs under its own
lock (`hist_cuda.build`, `score_cuda.build`, `shap_cuda.build`), and the
threads that come later wait for it and load the built library.

Error isolation and hardening, as in the reference:

* one candidate's exception is captured on its record (the sweep
  continues); `JobCancelled` marks the record cancelled;
* TRANSIENT failures (device runtime errors,
  `runtime/retry.is_device_error`) are retried up to
  ``H2O3_TRAIN_CAND_RETRIES`` times (default 1) against the process's
  retry budget (`runtime/retry.RetryBudget`); every other error (bad
  parameters, a kernel that fails to build) fails on the first attempt;
* an optional per-candidate WATCHDOG deadline
  (``H2O3_TRAIN_CAND_DEADLINE_S``, or ``TrainPool(candidate_deadline_s=)``)
  cancels a runaway candidate at its next safe point and records it
  failed;
* a failed or cancelled candidate's partial model is removed from the DKV
  if its job registered one;
* `SweepCheckpoint` persists per-candidate completion records so a killed
  sweep re-submitted with the same identity skips the candidates it
  finished (grid recovery and AutoML's ``checkpoint_dir`` ride it).

Each candidate gets a child `Job` whose cancel check also consults the
sweep's parent job, so cancelling the sweep stops in-flight candidates at
their next safe point and skips the ones not started.

Observability: per-candidate wall seconds and the phase split booked
through `runtime/phases.candidate_sink` (host_prep / h2d / compute /
metrics), pool occupancy (busy worker-seconds ÷ wall·parallelism), and the
hardening counters (retried / watchdog_cancelled / resumed), and the
CV fold counters (`record_cv_fold`: folds that slice the parent's
binned codes vs folds that re-bin, `h2o3_train_cv_folds{mode}`), read by
`snapshot()`.

Not ported: the QoS admission gate the reference passes each candidate
through (`qos.admission_gate`) is ROADMAP queue A, item 11 (QoS, both
halves); the retry of a watchdog-cancelled candidate from its fit-level
checkpoints needs the supervisor (items 5 and 9), so a watchdog kill here
always records the candidate failed; the reference's
``H2O3_TRAIN_LEGACY`` switch, a sequential walk outside the pool for its
benchmark's comparator, waits for the port's first benchmark (item A5e).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import faults as _faults
from . import phases as _phases
from . import retry as _retry
from . import tracing as _tracing

# candidate phase keys surfaced per record (the phases the port's fits book)
_CAND_PHASES = ("host_prep", "h2d", "compute", "metrics")

_LOCK = threading.Lock()
_TOTALS = dict(pools=0, submitted=0, completed=0, failed=0, cancelled=0,
               skipped=0, retried=0, watchdog_cancelled=0, resumed=0,
               busy_s=0.0, wall_s=0.0)
_CV = dict(reuse_folds=0, rebin_folds=0)
_CANDIDATES: deque = deque(maxlen=64)   # the most recent candidates
_LAST_POOL: Dict = {}
# the process's retry budget that candidate retries spend from
_RETRY_BUDGET = _retry.RetryBudget()


_TOTAL_FIELDS = ("pools", "submitted", "completed", "failed", "cancelled",
                 "skipped", "retried", "watchdog_cancelled", "resumed")

_REGISTRY = None


def _registry():
    """Central-registry counters backing the pool totals. Memoized."""
    global _REGISTRY
    if _REGISTRY is not None:
        return _REGISTRY
    from . import metrics_registry as reg

    c = {f: reg.counter(f"h2o3_train_{f}",
                        f"train pool {f.replace('_', ' ')}")
         for f in _TOTAL_FIELDS}
    c["busy_s"] = reg.counter("h2o3_train_busy_seconds",
                              "busy worker-seconds across pool candidates")
    c["wall_s"] = reg.counter("h2o3_train_wall_seconds",
                              "pool wall-seconds")
    c["cv"] = reg.counter("h2o3_train_cv_folds",
                          "CV folds by preparation mode",
                          labelnames=("mode",))
    _REGISTRY = c
    return c


def record_cv_fold(reused: bool) -> None:
    """One CV fold fit: `reused` when it slices the parent fit's binned
    codes, else a fold that re-bins its own rows."""
    with _LOCK:
        _CV["reuse_folds" if reused else "rebin_folds"] += 1
    _registry()["cv"].inc(1, "reuse" if reused else "rebin")


def record_resumed(n: int = 1) -> None:
    """Sweep candidates satisfied from a checkpoint instead of retrained
    (grid recovery_dir auto-resume + AutoML checkpoint_dir)."""
    with _LOCK:
        _TOTALS["resumed"] += n
    _registry()["resumed"].inc(n)


@dataclass
class JobRecord:
    """Outcome of one submitted candidate, in submission order."""

    name: str
    status: str = "pending"   # pending/done/failed/cancelled/skipped/resumed
    result: object = None
    error: Optional[str] = None
    exception: Optional[BaseException] = None
    wall_s: float = 0.0
    retries: int = 0
    phases: Dict[str, float] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status in ("done", "resumed")


class SweepCheckpoint:
    """Per-candidate completion records of one sweep, persisted as JSON.

    ``mark(key, payload)`` is atomic (tmp + os.replace) after every
    completion, so a sweep killed mid-flight leaves a readable record; a
    re-submitted sweep with the same id skips `completed()` candidates.
    The payload shape is the CALLER's (grid stores combo params + artifact
    file, AutoML stores leaderboard metrics + artifact file).

    ``fingerprint`` (a JSON-safe dict of the sweep's identity — response,
    features, seed, data shape, ...) guards against restoring someone
    else's records: candidate names like ``GBM_1`` are constants, so a
    stored file whose fingerprint differs is treated as "no records".

    A reference run also records the candidates it started, with where
    their fit-level checkpoints live (``inflight``), and ``mark`` clears a
    key's. The port's fits keep no fit-level checkpoints yet (ROADMAP queue
    A, items 5 and 9), so it writes no such pointer; it reads a reference
    run's and keeps them on rewrite."""

    def __init__(self, directory: str, sweep_id: str,
                 fingerprint: Optional[Dict] = None):
        self.directory = directory
        self.sweep_id = sweep_id
        self.fingerprint = fingerprint
        self.path = os.path.join(directory, f"{sweep_id}.sweep.json")
        self._lock = threading.Lock()
        self._records: Dict[str, Dict] = {}
        self._inflight: Dict[str, Dict] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if data.get("sweep_id") != sweep_id:
                    pass
                elif (fingerprint is not None
                        and data.get("fingerprint") != fingerprint):
                    from .log import Log

                    Log.warn(
                        f"sweep checkpoint {self.path}: stored fingerprint "
                        "does not match this run (different data/response/"
                        "seed?); ignoring its records")
                else:
                    self._records = dict(data.get("candidates") or {})
                    self._inflight = dict(data.get("inflight") or {})
            except (ValueError, OSError):
                # a torn/corrupt checkpoint means "no records", not a crash
                self._records = {}

    def completed(self, key: str) -> Optional[Dict]:
        with self._lock:
            return self._records.get(key)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._records)

    def inflight(self, key: Optional[str] = None):
        """The interrupted-candidate pointers a prior run left behind
        (all of them, or one key's)."""
        with self._lock:
            if key is not None:
                return self._inflight.get(key)
            return dict(self._inflight)

    def _write_locked(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(sweep_id=self.sweep_id,
                           fingerprint=self.fingerprint,
                           candidates=self._records,
                           inflight=self._inflight), f)
        os.replace(tmp, self.path)

    def mark(self, key: str, payload: Dict) -> None:
        with self._lock:
            self._records[key] = payload
            self._inflight.pop(key, None)
            self._write_locked()

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


def _child_job(dest: str, parent=None):
    """Per-candidate Job whose cancel check also consults the sweep's
    parent job (a cancel of the sweep reaches running candidates)."""
    from ..models.model_base import Job

    class _J(Job):
        def check_cancelled(self):
            if parent is not None and parent.cancel_requested:
                self.cancel_requested = True
            Job.check_cancelled(self)

    return _J(dest=dest, description="train-pool candidate").start()


def _cleanup_partial(job) -> int:
    """Remove a failed/cancelled candidate's partial model from the DKV:
    the model key its job recorded (job.result, set by model_base.train
    once the model is built) and the job's own dest key if a model landed
    under it. Only H2OModel values are touched. The port's `train`
    registers no model in the DKV (ROADMAP queue A, item 11), so this
    finds one only where the caller put it there; the reference's
    memory-ledger leak canary (`job_end`) arrives with the job-leak owners
    of item 11."""
    from ..models.model_base import H2OModel
    from .dkv import DKV

    removed = 0
    for k in {getattr(job, "result", None), getattr(job, "dest", None)}:
        if k and isinstance(DKV.get(k), H2OModel):
            DKV.remove(k)
            removed += 1
    return removed


class TrainPool:
    """Run candidate build functions with bounded parallelism.

    ``items`` are ``(name, fn)`` where ``fn(job)`` builds and returns one
    model/estimator; ``job`` is the pool-created child Job (wire it in as
    the estimator's ``_external_job`` so cancellation — a cancel of the
    sweep AND the watchdog deadline — reaches the fit loop's safe points).
    """

    def __init__(self, parallelism: int = 1, label: str = "train",
                 parent_job=None, candidate_retries: Optional[int] = None,
                 candidate_deadline_s: Optional[float] = None):
        self.parallelism = max(int(parallelism or 1), 1)
        self.label = label
        self.parent_job = parent_job
        from . import env_float, env_int

        self.candidate_retries = max(
            candidate_retries if candidate_retries is not None
            else env_int("H2O3_TRAIN_CAND_RETRIES", 1), 0)
        self.candidate_deadline_s = (
            candidate_deadline_s if candidate_deadline_s is not None
            else env_float("H2O3_TRAIN_CAND_DEADLINE_S", 0.0))

    def _run_candidate(self, rec: JobRecord, name: str,
                       fn: Callable) -> None:
        """One candidate: up to 1+retries attempts, each under a fresh
        child job and (when configured) a watchdog timer."""
        from ..models.model_base import JobCancelled

        deadline = self.candidate_deadline_s
        max_tries = 1 + self.candidate_retries
        attempt = 0
        while True:
            attempt += 1
            job = _child_job(f"{self.label}_{name}", parent=self.parent_job)
            watchdog = None
            if deadline > 0:
                def _fire(j=job):
                    j._watchdog_fired = True
                    j.cancel()

                watchdog = threading.Timer(deadline, _fire)
                watchdog.daemon = True
                watchdog.start()
            try:
                _faults.check("trainpool.candidate", name)
                rec.result = fn(job)
                rec.status = "done"
                return
            except JobCancelled:
                _cleanup_partial(job)
                if getattr(job, "_watchdog_fired", False):
                    with _LOCK:
                        _TOTALS["watchdog_cancelled"] += 1
                    _registry()["watchdog_cancelled"].inc()
                    _tracing.event("watchdog_cancelled",
                                   deadline_s=deadline)
                    rec.status = "failed"
                    rec.error = (f"candidate exceeded its {deadline:g}s "
                                 "watchdog deadline and was cancelled")
                    return
                rec.status = "cancelled"
                return
            except Exception as e:  # error isolation: sweep continues
                _cleanup_partial(job)
                if (attempt < max_tries and _retry.is_device_error(e)
                        and _RETRY_BUDGET.try_spend()):
                    rec.retries += 1
                    with _LOCK:
                        _TOTALS["retried"] += 1
                    _registry()["retried"].inc()
                    _tracing.event("retry", attempt=attempt,
                                   error=f"{type(e).__name__}: {e}")
                    continue
                rec.status = "failed"
                rec.error = str(e)
                rec.exception = e
                return
            finally:
                if watchdog is not None:
                    watchdog.cancel()

    def run(self, items: Sequence[Tuple[str, Callable]],
            stop_when: Optional[Callable[[], bool]] = None
            ) -> List[JobRecord]:
        records = [JobRecord(name=name) for name, _ in items]
        par = self.parallelism   # one card: nothing forces a serial walk
        t0 = time.perf_counter()
        # candidates run on pool worker threads, so the submitting thread's
        # span is captured here and re-attached per candidate
        parent_span = _tracing.current()
        trace_id = (parent_span.trace_id if parent_span is not None
                    else getattr(self.parent_job, "trace_id", None))
        parent_id = (parent_span.span_id if parent_span is not None
                     else None)

        def _one(i: int) -> None:
            rec = records[i]
            name, fn = items[i]
            if self.parent_job is not None \
                    and self.parent_job.cancel_requested:
                rec.status = "cancelled"
                return
            if stop_when is not None and stop_when():
                rec.status = "skipped"
                return
            # the reference holds each candidate at the QoS admission gate
            # here; the port has no QoS layer yet (ROADMAP queue A, item 11)
            t1 = time.perf_counter()
            with _tracing.span(f"candidate:{name}", kind="candidate",
                               trace_id=trace_id, parent_id=parent_id,
                               label=self.label) as sp, \
                    _phases.candidate_sink() as sink:
                self._run_candidate(rec, name, fn)
                sp.attrs["status"] = rec.status
            rec.wall_s = time.perf_counter() - t1
            secs = sink
            rec.phases = {k: round(secs[k], 4) for k in _CAND_PHASES
                          if k in secs}
            _record_candidate(self.label, rec, par)

        if par <= 1:
            for i in range(len(records)):
                _one(i)
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                    max_workers=par,
                    thread_name_prefix=f"h2o3torch-train-{self.label}") as ex:
                list(ex.map(_one, range(len(records))))

        wall = time.perf_counter() - t0
        busy = sum(r.wall_s for r in records)
        entry = dict(
            label=self.label, parallelism=par,
            requested_parallelism=self.parallelism,
            n_jobs=len(records),
            done=sum(r.status == "done" for r in records),
            failed=sum(r.status == "failed" for r in records),
            cancelled=sum(r.status == "cancelled" for r in records),
            skipped=sum(r.status == "skipped" for r in records),
            retried=sum(r.retries for r in records),
            wall_s=round(wall, 4), busy_s=round(busy, 4),
            occupancy=round(busy / max(wall * par, 1e-9), 4),
        )
        with _LOCK:
            _TOTALS["pools"] += 1
            _TOTALS["submitted"] += len(records)
            _TOTALS["completed"] += entry["done"]
            _TOTALS["failed"] += entry["failed"]
            _TOTALS["cancelled"] += entry["cancelled"]
            _TOTALS["skipped"] += entry["skipped"]
            _TOTALS["busy_s"] += busy
            _TOTALS["wall_s"] += wall
            _LAST_POOL.clear()
            _LAST_POOL.update(entry)
        reg = _registry()
        reg["pools"].inc()
        reg["submitted"].inc(len(records))
        reg["completed"].inc(entry["done"])
        reg["failed"].inc(entry["failed"])
        reg["cancelled"].inc(entry["cancelled"])
        reg["skipped"].inc(entry["skipped"])
        reg["busy_s"].inc(busy)
        reg["wall_s"].inc(wall)
        return records


def _record_candidate(label: str, rec: JobRecord, parallelism: int) -> None:
    entry = dict(label=label, name=rec.name, status=rec.status,
                 wall_s=round(rec.wall_s, 4), parallelism=parallelism,
                 phases=rec.phases)
    if rec.retries:
        entry["retries"] = rec.retries
    if rec.error:
        entry["error"] = rec.error
    with _LOCK:
        _CANDIDATES.append(entry)


def snapshot() -> Dict:
    """The pool's totals, the CV fold counters, its recent candidates and
    the last pool's entry."""
    with _LOCK:
        totals = dict(_TOTALS)
        cv = dict(_CV)
        cands = list(_CANDIDATES)
        last = dict(_LAST_POOL) if _LAST_POOL else None
    busy, wall = totals.pop("busy_s"), totals.pop("wall_s")
    totals["busy_s"] = round(busy, 4)
    totals["wall_s"] = round(wall, 4)
    return dict(totals=totals, cv=cv, candidates=cands, last_pool=last,
                active=totals["submitted"] > 0)


def reset() -> None:
    with _LOCK:
        _TOTALS.update(pools=0, submitted=0, completed=0, failed=0,
                       cancelled=0, skipped=0, retried=0,
                       watchdog_cancelled=0, resumed=0,
                       busy_s=0.0, wall_s=0.0)
        _CV.update(reuse_folds=0, rebin_folds=0)
        _CANDIDATES.clear()
        _LAST_POOL.clear()
