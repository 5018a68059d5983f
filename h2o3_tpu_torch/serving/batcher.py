"""Micro-batching queue — coalesce concurrent requests into device batches.

A copy of `h2o3_tpu/serving/batcher.py`. The serving analog of XGBoost's
GPU batch scoring (arxiv 1806.11248): the device executes one padded batch
far cheaper than N tiny dispatches, so concurrent requests for the same
(model, output_kind) are coalesced into one scored frame and scattered back
per request.

Batching policy (the standard max-size/max-wait window):

- the first queued request opens a window of `max_wait_ms`;
- the window closes early once `max_batch_rows` rows have accumulated;
- only schema-compatible frames coalesce (same column names/types) — a
  mismatched request simply waits for its own batch, it is never rbind-ed
  into someone else's.

Error isolation: a batch that fails is re-scored request-by-request, so one
request's bad rows surface as *that* request's 4xx while its batch-mates
still get their predictions. One worker thread per (model_key, output_kind)
queue, started lazily and expired after `idle_worker_s` of quiet — a
serving host with 500 registered models does not carry 500 idle threads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import ServingConfig
from .metrics import ServingMetrics
from .model_cache import ScorerCache


class _Pending:
    """One enqueued request: input + rendezvous for the caller thread."""

    __slots__ = ("frame", "nrow", "sig", "model", "event", "result", "error",
                 "t_enqueue", "trace_id", "parent_span_id")

    def __init__(self, frame, model):
        from ..runtime import tracing

        self.frame = frame
        self.nrow = frame.nrow
        # trace correlation: the submitting thread (the REST handler with
        # its root request span) hands its ids over so the batch span the
        # worker thread records lands in the request's trace
        cur = tracing.current()
        self.trace_id = cur.trace_id if cur is not None else None
        self.parent_span_id = cur.span_id if cur is not None else None
        # coalescing compatibility: exact column names + types, in order,
        # AND the live model object's identity — a model re-put under the
        # same DKV key mid-flight must not have its requests scored by its
        # batch-mates' (older or newer) model. id() is stable here because
        # every pending holds a strong reference to its model.
        self.sig = (id(model),
                    tuple((n, frame.vec(n).type) for n in frame.names))
        self.model = model
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.monotonic()


class _Worker:
    """Owns one (model_key, output_kind) queue + its scoring thread."""

    def __init__(self, batcher: "MicroBatcher", model_key: str,
                 output_kind: str):
        self.batcher = batcher
        self.model_key = model_key
        self.output_kind = output_kind
        self.cond = threading.Condition()
        self.q: "deque[_Pending]" = deque()
        self.closed = False
        self.thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"h2o3tpu-serve-{model_key}-{output_kind}")
        self.thread.start()

    # lock order everywhere: batcher._lock → worker.cond (never reversed)
    def _run(self):
        cfg = self.batcher.config
        while True:
            with self.cond:
                while not self.q and not self.closed:
                    if not self.cond.wait(timeout=cfg.idle_worker_s) \
                            and not self.q:
                        break
                if not self.q:
                    break   # idle-expired (or closed while empty)
                # batching window: first request's dwell bounds the wait
                deadline = self.q[0].t_enqueue + cfg.max_wait_ms / 1e3
                while (sum(p.nrow for p in self.q) < cfg.max_batch_rows
                       and not self.closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self.cond.wait(remaining)
                batch = self._pop_batch(cfg.max_batch_rows)
            if batch:   # the window's requests may all have expired
                self._score(batch)
        self.batcher._retire(self)

    def _pop_batch(self, max_rows: int) -> List[_Pending]:
        """Pop the schema-compatible head prefix (callers hold self.cond).

        Expired requests — whose caller's `event.wait` already timed out
        (and released its admission slot) — are retired HERE, unscored:
        under sustained overload the abandoned work would otherwise keep
        consuming device time and the deque could grow without bound
        past `max_queue` (only live requests hold admission slots)."""
        timeout_s = self.batcher.config.request_timeout_s
        cutoff = time.monotonic() - timeout_s
        expired = [p for p in self.q if p.t_enqueue < cutoff]
        if expired:
            dead = set(map(id, expired))
            self.q = deque(p for p in self.q if id(p) not in dead)
            for p in expired:
                p.error = TimeoutError(
                    f"request expired unscored after {timeout_s:.0f}s "
                    "in the batch queue")
                p.event.set()   # caller is already gone; unblock stragglers
            self.batcher.metrics.record_expired(self.model_key,
                                                len(expired))
        if not self.q:
            return []
        sig = self.q[0].sig
        batch, rows = [], 0
        while self.q and self.q[0].sig == sig:
            if batch and rows + self.q[0].nrow > max_rows:
                break
            p = self.q.popleft()
            batch.append(p)
            rows += p.nrow
        return batch

    def _score(self, batch: List[_Pending]) -> None:
        from ..runtime import tracing

        # the batch span adopts the first request's trace (one batch can
        # serve several traces — the rest ride along as an attribute)
        lead = next((p for p in batch if p.trace_id), None)
        extra = sorted({p.trace_id for p in batch
                        if p.trace_id} - {lead.trace_id if lead else None})
        with tracing.span(f"batch:{self.model_key}", kind="batch",
                          trace_id=lead.trace_id if lead else None,
                          parent_id=lead.parent_span_id if lead else None,
                          output_kind=self.output_kind,
                          n_requests=len(batch),
                          n_rows=sum(p.nrow for p in batch),
                          **(dict(other_trace_ids=extra) if extra else {})):
            self._score_inner(batch)

    def _score_inner(self, batch: List[_Pending]) -> None:
        from ..frame.frame import Frame

        t_start = time.monotonic()
        metrics = self.batcher.metrics
        for p in batch:
            metrics.record_queue_wait(self.model_key, t_start - p.t_enqueue)
        try:
            # every batch member shares one model object (identity is part
            # of the coalescing signature), so batch[0].model is THE model
            frame = (batch[0].frame if len(batch) == 1
                     else Frame.rbind_all([p.frame for p in batch]))
            out, compiled, device_s = self._score_frame(batch[0].model,
                                                        frame)
            metrics.record_batch(self.model_key, len(batch), frame.nrow,
                                 device_s, compiled)
            off = 0
            for p in batch:
                p.result = (out if len(batch) == 1 else
                            out.take(np.arange(off, off + p.nrow)))
                off += p.nrow
        except BaseException as e:
            if len(batch) == 1:
                batch[0].error = e
            else:
                # error isolation: re-score one by one so only the poisoned
                # request fails; batch-mates still get answers
                for p in batch:
                    try:
                        out, compiled, device_s = self._score_frame(p.model,
                                                                    p.frame)
                        metrics.record_batch(self.model_key, 1, p.nrow,
                                             device_s, compiled)
                        p.result = out
                    except BaseException as pe:
                        p.error = pe
        finally:
            for p in batch:
                p.event.set()

    def _score_frame(self, model, frame) -> Tuple[object, Optional[bool],
                                                  float]:
        """Primary scoring with failover:

        device error (`retry.is_device_error`) → quarantine the scorer + rebuild
        once → a second device error opens the circuit breaker and this
        (and every subsequent) request degrades to the CPU-fallback scorer
        until a half-open probe closes it. Non-device errors (bad rows)
        propagate unchanged — they are the REQUEST's fault, not the
        scorer's."""
        from ..runtime import retry as _retrylib

        b = self.batcher
        fo = b.failover
        key = (self.model_key, self.output_kind)
        if b.config.cpu_fallback and fo.use_fallback(key):
            return fo.score_fallback(self.model_key, model,
                                     self.output_kind, frame)
        try:
            entry, _hit = b.cache.get_or_build(self.model_key, model,
                                               self.output_kind)
            out = entry.score(frame)
            fo.record_success(key)
            return out
        except Exception as e:
            if not _retrylib.is_device_error(e):
                fo.abort_probe(key)     # a half-open probe must not wedge
                raise
            b.metrics.record_scorer_fault(self.model_key)
            # quarantine the poisoned scorer entry, rebuild once — the
            # rebuild (build AND its first score) stays inside the
            # handler so a failure there still resolves the probe slot
            b.cache.invalidate(self.model_key)
            b.metrics.record_quarantine(self.model_key)
            try:
                entry2, _ = b.cache.get_or_build(self.model_key, model,
                                                 self.output_kind)
                out = entry2.score(frame)
                b.metrics.record_rebuild(self.model_key)
                fo.record_success(key)
                return out
            except Exception as e2:
                if not _retrylib.is_device_error(e2):
                    fo.abort_probe(key)
                    raise
                b.metrics.record_scorer_fault(self.model_key)
                fo.open_breaker(key)
                b.metrics.record_breaker_open(self.model_key)
                if not b.config.cpu_fallback:
                    raise
                return fo.score_fallback(self.model_key, model,
                                         self.output_kind, frame)


class MicroBatcher:
    """submit() facade + the per-(model, kind) worker registry."""

    def __init__(self, cache: ScorerCache, metrics: ServingMetrics,
                 config: ServingConfig,
                 failover: Optional["FailoverState"] = None):
        from .model_cache import FailoverState

        self.cache = cache
        self.metrics = metrics
        self.config = config
        # quarantine/breaker state shared with the engine's snapshot; a
        # directly-constructed batcher (tests) gets its own
        self.failover = failover if failover is not None \
            else FailoverState(config)
        self._lock = threading.Lock()
        self._workers: Dict[Tuple[str, str], _Worker] = {}

    def submit(self, model_key: str, model, frame,
               output_kind: str = "predict"):
        """Enqueue one request and block until its slice of the batch
        result is ready. Re-raises the request's own scoring error."""
        p = _Pending(frame, model)
        key = (model_key, output_kind)
        with self._lock:
            w = self._workers.get(key)
            if w is None or w.closed:
                w = self._workers[key] = _Worker(self, model_key,
                                                 output_kind)
            with w.cond:
                w.q.append(p)
                w.cond.notify_all()
        if not p.event.wait(timeout=self.config.request_timeout_s):
            raise TimeoutError(
                f"scoring {model_key!r} did not complete within "
                f"{self.config.request_timeout_s:.0f}s")
        if p.error is not None:
            raise p.error
        return p.result

    def _retire(self, worker: _Worker) -> None:
        """Idle worker exit — re-check emptiness under both locks so a
        submit racing the expiry either lands before (worker stays) or
        after (fresh worker spawns); requests are never stranded."""
        key = (worker.model_key, worker.output_kind)
        with self._lock:
            with worker.cond:
                if worker.q:
                    # raced: requests arrived between expiry and retire —
                    # hand the queue to a fresh worker
                    pending = list(worker.q)
                    worker.q.clear()
                    worker.closed = True
                    if self._workers.get(key) is worker:
                        del self._workers[key]
                    nw = self._workers[key] = _Worker(
                        self, worker.model_key, worker.output_kind)
                    with nw.cond:
                        nw.q.extend(pending)
                        nw.cond.notify_all()
                    return
                worker.closed = True
                if self._workers.get(key) is worker:
                    del self._workers[key]

    def shutdown(self) -> None:
        """Close every worker (tests / engine reset). Queued requests are
        drained by their worker's final loop turn before it exits."""
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            with w.cond:
                w.closed = True
                w.cond.notify_all()
