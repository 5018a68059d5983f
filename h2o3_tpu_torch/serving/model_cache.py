"""Compiled-scorer cache — warm scorers for the serving hot path.

A copy of `h2o3_tpu/serving/model_cache.py`, rewired to the port's models
and MOJO. Under XLA, every new (program, shape) pair paid a trace and a
compile, so the reference keeps both the scorer closure and its padded
batch shapes resident. The port scores eagerly: a cold bucket costs no
trace, but the cache keeps the same keys, buckets and counters, so the
serving metrics read the same and the padded shapes stay few.

Two layers of reuse:

1. **Entry cache** (LRU): keyed on `(model_key, n_features, dtype,
   output_kind)`. The key carries the scoring signature, not just the model
   key, so re-training a model under the same DKV key (different feature
   count) can never serve a stale scorer; identity of the live model object
   is checked on every hit for the same reason.
2. **Row-bucket warm set**: batch rows pad up to a small set of bucket
   sizes (64/128/256, then multiples of `SCORE_ROW_BUCKET`). The first visit
   to a bucket counts as a compile; later visits are cache hits. Tree
   `_margins` pads to `SCORE_ROW_BUCKET` itself, so the sub-512 buckets
   share one device shape.

Output kinds: "predict" is served for every port model (GBM, DRF, GLM,
whose `predict` pads its own design to `SCORE_ROW_BUCKET` rows, XGBoost and
DeepLearning, whose `predict` scores the padded batch on the device);
"contributions" (TreeSHAP) and "leaves" (leaf node assignment) for GBM and
DRF. A model without the method (GLM, DeepLearning) raises the reference's
`ValueError`. A predict fallback scores with the model's MOJO scorer. A contributions fallback scores with the MOJO scorer's
`predict_contributions`; a leaves fallback with the model's own method.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from ..runtime import memory_ledger as _memory

# sub-SCORE_ROW_BUCKET buckets: REST predict traffic is dominated by small
# frames (single rows to a few hundred); padding a 3-row request straight to
# 512 wastes device work, but 3→64→128→256 keeps the program count bounded
_SMALL_BUCKETS = (64, 128, 256)

# output_kind → model method (the three /3/Predictions scoring surfaces)
OUTPUT_KINDS = {
    "predict": "predict",
    "contributions": "predict_contributions",
    "leaves": "predict_leaf_node_assignment",
}


def bucket_rows(n: int) -> int:
    """Padded row count for an n-row batch (see module docstring)."""
    from ..models.model_base import SCORE_ROW_BUCKET

    for b in _SMALL_BUCKETS:
        if n <= b:
            return b
    return -(-n // SCORE_ROW_BUCKET) * SCORE_ROW_BUCKET


def scoring_signature(model) -> Tuple[int, str]:
    """(n_features, dtype) of a model's compiled scoring-program family —
    the shape-bearing parts of the cache key."""
    sig = getattr(model, "scoring_signature", None)
    if callable(sig):
        return sig()
    x = getattr(model, "x", None)
    nf = len(x) if isinstance(x, (list, tuple)) else (1 if x else 0)
    return (nf, "float32")


class CompiledScorer:
    """One cache entry: a bound scoring callable + its warm bucket set."""

    def __init__(self, model_key: str, model, output_kind: str):
        method = OUTPUT_KINDS.get(output_kind)
        if method is None:
            raise ValueError(f"unknown output kind {output_kind!r}")
        fn = getattr(model, method, None)
        if fn is None:
            what = {"contributions": "contributions",
                    "leaves": "leaf assignment"}.get(output_kind, output_kind)
            raise ValueError(f"{model_key!r} does not support {what}")
        self.model_key = model_key
        self.model = model          # identity-checked on cache hits
        self.output_kind = output_kind
        self._fn = fn
        self.warm_buckets: set = set()
        self.built_at = time.time()
        self._lock = threading.Lock()

    def score(self, frame) -> Tuple[object, bool, float]:
        """Score one (possibly coalesced) batch.

        Returns (result_frame, compiled, device_s): `compiled` is True when
        this call is the first in its padded row bucket (a cold bucket,
        where the reference traced a new program)."""
        n = frame.nrow
        pad = bucket_rows(n) if n else 0
        if n and pad != n:
            # repeat row 0 as padding — always in-domain for enum columns,
            # unlike zeros, and sliced off below
            idx = np.concatenate([np.arange(n, dtype=np.int64),
                                  np.zeros(pad - n, np.int64)])
            scored = frame.take(idx)
        else:
            scored = frame
        with self._lock:
            compiled = pad not in self.warm_buckets
            self.warm_buckets.add(pad)
        t0 = time.perf_counter()
        from ..runtime import faults as _faults

        # the serving.scorer fault point stands in for a device runtime
        # failure of THIS scorer — the quarantine/fallback tests arm it
        # (default off: one dict lookup)
        _faults.check("serving.scorer", self.model_key)
        out = self._fn(scored)
        device_s = time.perf_counter() - t0
        if n and pad != n:
            out = out.take(np.arange(n))
        return out, compiled, device_s


class ScorerCache:
    """LRU of CompiledScorer entries, keyed on the full scoring signature."""

    def __init__(self, capacity: int = 32):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, CompiledScorer]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def _key(model_key: str, model, output_kind: str) -> Tuple:
        nf, dtype = scoring_signature(model)
        return (model_key, nf, dtype, output_kind)

    @staticmethod
    def _owner(key: Tuple) -> str:
        return f"scorer:{key[0]}:{key[3]}"

    @staticmethod
    def _register_ledger(key: Tuple, entry: "CompiledScorer") -> None:
        """Memory-ledger owner for one cache entry. The bytes attributed
        are the wrapped model's — but ONLY while the scorer is what pins
        it (the model no longer lives in the DKV under its key); while the
        DKV holds the same object, the `dkv:` owner accounts it and the
        scorer reports 0 instead of double-counting."""
        wr = weakref.ref(entry)

        def _bytes():
            e = wr()
            if e is None:
                return (0, 0)
            from ..runtime.dkv import DKV

            if DKV.get(e.model_key) is e.model:
                return (0, 0)
            return _memory.measure(e.model)

        _memory.register(ScorerCache._owner(key), kind="scorer",
                         bytes_fn=_bytes, referent=entry,
                         type_name=type(entry.model).__name__)

    def get_or_build(self, model_key: str, model,
                     output_kind: str = "predict"
                     ) -> Tuple[CompiledScorer, bool]:
        """(entry, was_hit). Builds (and LRU-inserts) on miss; a hit whose
        entry wraps a *different* live object (model re-trained / re-loaded
        under the same key) rebuilds — a stale scorer must never score."""
        key = self._key(model_key, model, output_kind)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.model is model:
                self._entries.move_to_end(key)
                self.hits += 1
                return entry, True
            # miss or stale: build under the lock — scorer construction is
            # cheap, and one build per key beats a thundering herd
            entry = CompiledScorer(model_key, model, output_kind)
            self._entries[key] = entry
            self._entries.move_to_end(key)
            self.misses += 1
            self._register_ledger(key, entry)
            while len(self._entries) > self.capacity:
                old_key, _old = self._entries.popitem(last=False)
                self.evictions += 1
                _memory.unregister(self._owner(old_key), event="evict",
                                   trigger="cap")
            return entry, False

    def invalidate(self, model_key: Optional[str] = None) -> int:
        """Drop entries for one model key (or all). Returns drop count."""
        with self._lock:
            if model_key is None:
                doomed = list(self._entries)
                self._entries.clear()
            else:
                doomed = [k for k in self._entries if k[0] == model_key]
                for k in doomed:
                    del self._entries[k]
        for k in doomed:
            _memory.unregister(self._owner(k), event="evict",
                               trigger="invalidate")
        return len(doomed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict:
        with self._lock:
            entries = [dict(model=k[0], n_features=k[1], dtype=k[2],
                            output_kind=k[3],
                            warm_buckets=sorted(e.warm_buckets))
                       for k, e in self._entries.items()]
            return dict(capacity=self.capacity, size=len(entries),
                        hits=self.hits, misses=self.misses,
                        evictions=self.evictions, entries=entries)


# -- failover: quarantine + circuit breaker + CPU fallback -------------------

def build_fallback_scorer(model, output_kind: str):
    """A device-independent scorer for a quarantined model.

    Round-trips the model through its mojo artifact: `MojoScorer` scores
    with numpy only — the degrade path (Out-of-Core GPU GBM's
    fall-back-to-the-slower-path stance, arXiv:2005.09148) that cannot be
    poisoned by a sick accelerator. When the artifact format doesn't cover
    the algo (TypeError from the exporter) the model's own bound method is
    the last resort — still isolated from the quarantined scorer
    cache. Returns (callable, kind_label)."""
    method = OUTPUT_KINDS[output_kind]
    try:
        import tempfile

        from .. import mojo as mojolib

        with tempfile.TemporaryDirectory(prefix="h2o3_fallback_") as d:
            path = mojolib.save_model(model, d, force=True)
            scorer = mojolib.load_model(path)   # arrays load eagerly
        fn = getattr(scorer, method, None)
        if fn is not None:
            return fn, "mojo-cpu"
    except Exception:
        pass
    return getattr(model, method), "direct"


class FailoverState:
    """Per-(model_key, output_kind) circuit breaker + fallback scorers.

    Lifecycle the batcher drives: a device error quarantines the
    scorer entries (cache invalidate) and rebuilds ONCE; a second device
    error opens the breaker — requests are served by the numpy fallback
    scorer for ``config.breaker_reset_s`` seconds, after which exactly one
    half-open probe retries the primary (success closes the breaker,
    failure re-opens it). The 5xx storm a crashing scorer would produce
    becomes a latency degradation."""

    def __init__(self, config):
        self.config = config
        self._lock = threading.Lock()
        self._breakers: Dict[Tuple[str, str], Dict] = {}
        # LRU like the ScorerCache it mirrors: fallback scorers hold the
        # model AND its eagerly-loaded artifact arrays alive, so they must
        # not accumulate across model keys forever
        self._fallbacks: "OrderedDict[Tuple[str, str, int], Tuple]" = \
            OrderedDict()
        self.fallback_builds = 0

    # -- breaker ------------------------------------------------------------
    def use_fallback(self, key: Tuple[str, str]) -> bool:
        """True when this request must take the fallback path. After the
        reset dwell, ONE caller is elected half-open prober (gets False)
        while its peers keep falling back."""
        with self._lock:
            b = self._breakers.get(key)
            if b is None or b["state"] == "closed":
                return False
            now = time.monotonic()
            if now >= b["open_until"] and not b["probing"]:
                b["probing"] = True
                b["state"] = "half-open"
                return False
            return True

    def open_breaker(self, key: Tuple[str, str]) -> None:
        with self._lock:
            b = self._breakers.setdefault(
                key, dict(state="open", open_until=0.0, opens=0,
                          probing=False))
            b["state"] = "open"
            b["open_until"] = time.monotonic() + self.config.breaker_reset_s
            b["opens"] += 1
            b["probing"] = False

    def record_success(self, key: Tuple[str, str]) -> None:
        """A primary-path score succeeded: close the breaker (half-open
        probe passed, or the scorer was healthy all along)."""
        with self._lock:
            b = self._breakers.get(key)
            if b is not None and b["state"] != "closed":
                b["state"] = "closed"
                b["probing"] = False

    def abort_probe(self, key: Tuple[str, str]) -> None:
        """The elected half-open probe exited without a device verdict
        (e.g. the REQUEST's own rows were bad): give the probe slot back,
        else `probing=True` would pin every later request to the fallback
        forever even after the device recovers."""
        with self._lock:
            b = self._breakers.get(key)
            if b is not None and b["state"] == "half-open":
                b["state"] = "open"     # open_until already in the past:
                b["probing"] = False    # the next request re-probes

    # -- fallback scorers ---------------------------------------------------
    def fallback_fn(self, model_key: str, model, output_kind: str):
        """The cached CPU-fallback callable for (key, kind, live model) —
        keyed on object identity like the scorer cache, so a re-trained
        model under the same key gets a fresh fallback. The artifact
        round-trip runs OUTSIDE the lock (use_fallback/record_success take
        it on every batch — a multi-second export must not stall healthy
        models); a lost insert race simply adopts the winner's scorer."""
        ck = (model_key, output_kind, id(model))
        with self._lock:
            hit = self._fallbacks.get(ck)
            if hit is not None and hit[0] is model:
                self._fallbacks.move_to_end(ck)
                return hit[1]
        fn, kind = build_fallback_scorer(model, output_kind)
        with self._lock:
            cur = self._fallbacks.get(ck)
            if cur is not None and cur[0] is model:
                return cur[1]       # raced: another thread built it first
            self._fallbacks[ck] = (model, fn, kind)
            self.fallback_builds += 1
            # drop stale identities for this (key, kind), then bound the
            # cache like the compiled-scorer LRU
            for k in [k for k in self._fallbacks
                      if k[:2] == ck[:2] and k != ck]:
                del self._fallbacks[k]
            while len(self._fallbacks) > max(self.config.cache_capacity, 1):
                self._fallbacks.popitem(last=False)
        return fn

    def score_fallback(self, model_key: str, model, output_kind: str,
                       frame) -> Tuple[object, None, float]:
        """Score via the CPU fallback; the None `compiled` slot marks the
        batch as fallback-served for metrics.record_batch."""
        fn = self.fallback_fn(model_key, model, output_kind)
        t0 = time.perf_counter()
        out = fn(frame)
        return out, None, time.perf_counter() - t0

    def stats(self) -> Dict:
        with self._lock:
            now = time.monotonic()
            breakers = [
                dict(model=k[0], output_kind=k[1], state=b["state"],
                     opens=b["opens"],
                     reopens_in_s=(round(max(b["open_until"] - now, 0.0), 3)
                                   if b["state"] == "open" else None))
                for k, b in self._breakers.items()]
            fallbacks = [dict(model=k[0], output_kind=k[1], kind=v[2])
                         for k, v in self._fallbacks.items()]
        return dict(breakers=breakers, fallback_scorers=fallbacks,
                    fallback_builds=self.fallback_builds,
                    breaker_reset_s=self.config.breaker_reset_s,
                    cpu_fallback_enabled=self.config.cpu_fallback)
