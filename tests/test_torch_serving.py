"""The port's serving engine (`h2o3_tpu_torch.serving`) and its runtime
closure, on the CPU: the in-process cases of `tests/test_serving.py`
(scorer cache, metrics, admission, micro-batcher) with their stub model and
timings, the scorer-failover cases of `tests/test_faults.py` through the
port's `runtime.faults`, the fault registry's own semantics, a real port
GBM and a real port GLM served through `ScoringEngine`, and the
device-error classification of
torch's CUDA errors. The reference's REST cases wait for the port's REST
layer (ROADMAP queue A, item 11).
"""

import gc
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.estimators import (H2OGeneralizedLinearEstimator,
                                       H2OGradientBoostingEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.tree import Tree
from h2o3_tpu_torch.ops import hist_cuda, score_cuda
from h2o3_tpu_torch.runtime import faults, memory_ledger, retry
from h2o3_tpu_torch.runtime.dkv import DKV
from h2o3_tpu_torch.serving import (RejectedError, ScoringEngine, get_engine,
                                    peek_engine, reset_engine)
from h2o3_tpu_torch.serving.admission import AdmissionController
from h2o3_tpu_torch.serving.batcher import MicroBatcher, _Pending
from h2o3_tpu_torch.serving.config import ServingConfig
from h2o3_tpu_torch.serving.metrics import LatencyHistogram, ServingMetrics
from h2o3_tpu_torch.serving.model_cache import (CompiledScorer, ScorerCache,
                                                build_fallback_scorer,
                                                bucket_rows)

from test_torch_gbm import make_higgs_like
from test_torch_glm import X_COLS, glm_frame


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    yield
    faults.reset()


class StubModel:
    """Deterministic numpy 'model': predict = row sum. `fail_above`
    poisons rows whose first column exceeds it (error-isolation tests);
    `delay_s` simulates device time (batching-window tests)."""

    def __init__(self, n_features=3, fail_above=None, delay_s=0.0,
                 gate=None):
        self.x = [f"f{i}" for i in range(n_features)]
        self.fail_above = fail_above
        self.delay_s = delay_s
        self.gate = gate            # threading.Event: block until set
        self.calls = 0

    def predict(self, fr):
        self.calls += 1
        if self.gate is not None:
            assert self.gate.wait(timeout=30)
        if self.delay_s:
            time.sleep(self.delay_s)
        X = np.column_stack([fr.vec(n).numeric_np() for n in self.x])
        if self.fail_above is not None and np.any(X[:, 0] > self.fail_above):
            raise ValueError("poisoned rows in batch")
        return Frame.from_dict({"predict": X.sum(axis=1)})


def _frame(n_rows, n_features=3, base=0.0):
    rng = np.random.default_rng(int(base * 1000) % 2**31)
    return Frame.from_dict(
        {f"f{i}": base + rng.random(n_rows) for i in range(n_features)})


def _cfg(**kw):
    return ServingConfig(**{**dict(
        max_batch_rows=4096, max_wait_ms=5.0, request_timeout_s=30.0,
        idle_worker_s=2.0, max_queue=64, model_inflight=64,
        retry_after_s=1.0, cache_capacity=8), **kw})


# -- model_cache ------------------------------------------------------------
def test_bucket_rows_padding_ladder():
    assert bucket_rows(1) == 64
    assert bucket_rows(64) == 64
    assert bucket_rows(65) == 128
    assert bucket_rows(200) == 256
    assert bucket_rows(300) == 512
    assert bucket_rows(513) == 1024
    assert bucket_rows(1025) == 1536


def test_cache_hit_miss_eviction():
    cache = ScorerCache(capacity=2)
    m1, m2, m3 = StubModel(), StubModel(), StubModel()
    e1, hit = cache.get_or_build("m1", m1)
    assert not hit and cache.misses == 1
    e1b, hit = cache.get_or_build("m1", m1)
    assert hit and e1b is e1 and cache.hits == 1
    cache.get_or_build("m2", m2)
    cache.get_or_build("m3", m3)          # capacity 2 → m1 evicted
    assert cache.evictions == 1
    _, hit = cache.get_or_build("m1", m1)
    assert not hit                         # rebuilt after eviction
    assert len(cache) == 2


def test_cache_stale_model_identity_rebuilds():
    """Re-training under the same DKV key must not serve the old model's
    scorer."""
    cache = ScorerCache(capacity=4)
    old, new = StubModel(), StubModel()
    e_old, _ = cache.get_or_build("m", old)
    e_new, hit = cache.get_or_build("m", new)
    assert not hit and e_new is not e_old and e_new.model is new


def test_compiled_scorer_pads_and_slices():
    entry = CompiledScorer("m", StubModel(), "predict")
    fr = _frame(10)
    out, compiled, _ = entry.score(fr)
    assert compiled                        # cold bucket 64
    assert out.nrow == 10                  # pad rows sliced off
    expect = sum(fr.vec(n).numeric_np() for n in fr.names)
    np.testing.assert_allclose(out.vec("predict").numeric_np(), expect,
                               rtol=1e-6)
    _, compiled, _ = entry.score(_frame(37))
    assert not compiled                    # 37 → same 64 bucket: warm
    _, compiled, _ = entry.score(_frame(100))
    assert compiled                        # 100 → new 128 bucket
    assert entry.warm_buckets == {64, 128}


def test_unsupported_output_kind_raises_value_error():
    with pytest.raises(ValueError, match="does not support contributions"):
        CompiledScorer("m", StubModel(), "contributions")


# -- metrics ----------------------------------------------------------------
def test_latency_histogram_buckets_and_stats():
    h = LatencyHistogram((1, 10, 100))
    for v in (0.5, 5, 50, 500):
        h.record(v)
    assert h.counts == [1, 1, 1, 1]        # one per bucket incl. overflow
    s = h.snapshot()
    assert s["count"] == 4 and s["min"] == 0.5 and s["max"] == 500


def test_metrics_snapshot_totals():
    m = ServingMetrics()
    m.record_request("a")
    m.record_request("b")
    m.record_rejection("b")
    m.record_batch("a", n_requests=3, n_rows=24, device_s=0.01,
                   compiled=True)
    m.record_batch("a", n_requests=1, n_rows=8, device_s=0.001,
                   compiled=False)
    snap = m.snapshot()
    assert snap["totals"]["requests"] == 2
    assert snap["totals"]["rejections"] == 1
    a = snap["models"]["a"]["counters"]
    assert a["batches"] == 2 and a["batched_requests"] == 4
    assert a["compiles"] == 1 and a["cache_hits"] == 1


# -- admission control ------------------------------------------------------
def test_admission_global_and_per_model_bounds():
    metrics = ServingMetrics()
    adm = AdmissionController(_cfg(max_queue=3, model_inflight=2), metrics)
    adm.admit("a")
    adm.admit("a")
    with pytest.raises(RejectedError):     # per-model bound
        adm.admit("a")
    adm.admit("b")
    with pytest.raises(RejectedError) as ei:   # global bound
        adm.admit("c")
    assert ei.value.retry_after_s == 1.0
    adm.release("a")
    adm.admit("c")                         # slot freed
    assert metrics.counter("a", "rejections") == 1
    assert metrics.counter("c", "rejections") == 1
    assert adm.stats()["in_flight"] == 3


def test_engine_backpressure_sheds_excess_concurrency():
    gate = threading.Event()
    model = StubModel(gate=gate)
    eng = ScoringEngine(_cfg(max_queue=2, max_wait_ms=1.0))
    results, rejects = [], []

    def call(i):
        try:
            results.append(eng.score("m", model, _frame(4)))
        except RejectedError:
            rejects.append(i)

    ts = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    time.sleep(0.3)          # let all six hit admission while gate is shut
    gate.set()
    for t in ts:
        t.join(timeout=30)
    assert len(rejects) == 4 and len(results) == 2
    assert eng.metrics.counter("m", "rejections") == 4
    eng.shutdown()


# -- micro-batcher ----------------------------------------------------------
def test_batcher_coalesces_16_concurrent_into_few_batches():
    """16 concurrent requests for one model → ≤ 4 device batches (and every
    caller gets exactly its own rows back)."""
    model = StubModel(delay_s=0.02)
    eng = ScoringEngine(_cfg(max_wait_ms=60.0, max_batch_rows=4096))
    # warm the scorer so the first batch's window isn't spent building
    eng.score("m", model, _frame(8, base=0.5))
    before = eng.metrics.counter("m", "batches")

    def call(i):
        fr = _frame(8, base=float(i + 1))
        out = eng.score("m", model, fr)
        expect = sum(fr.vec(n).numeric_np() for n in fr.names)
        np.testing.assert_allclose(out.vec("predict").numeric_np(),
                                   expect, rtol=1e-6)
        return out.nrow

    with ThreadPoolExecutor(max_workers=16) as ex:
        rows = list(ex.map(call, range(16)))
    assert rows == [8] * 16
    snap = eng.metrics.snapshot()["models"]["m"]["counters"]
    n_batches = snap["batches"] - before
    assert n_batches <= 4, f"16 concurrent requests took {n_batches} batches"
    assert snap["batched_rows"] == 8 + 16 * 8
    eng.shutdown()


def test_batch_error_isolation():
    """A poisoned request fails alone; coalesced batch-mates still get
    their predictions (per-request rescore fallback)."""
    model = StubModel(fail_above=100.0, delay_s=0.02)
    eng = ScoringEngine(_cfg(max_wait_ms=80.0))
    eng.score("m", model, _frame(4, base=0.5))     # warm → fast batches

    oks, errs = [], []

    def good(i):
        out = eng.score("m", model, _frame(4, base=float(i + 1)))
        oks.append(out.nrow)

    def bad():
        try:
            eng.score("m", model, Frame.from_dict(
                {"f0": [1e6, 2.0], "f1": [0.1, 0.2], "f2": [0.1, 0.2]}))
        except ValueError as e:
            errs.append(str(e))

    threads = ([threading.Thread(target=good, args=(i,)) for i in range(6)]
               + [threading.Thread(target=bad)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert oks == [4] * 6                  # every good request answered
    assert errs and "poisoned" in errs[0]  # the bad one got ITS error
    assert eng.metrics.counter("m", "errors") == 1
    eng.shutdown()


def test_batcher_retires_expired_pendings_unscored():
    """Requests whose caller already timed out (admission slot released)
    are retired at pop time instead of scored: abandoned work must not
    consume device time, and the deque cannot grow past the live set
    under sustained overload."""
    model = StubModel()
    gate = threading.Event()
    blocker = StubModel(gate=gate)
    metrics = ServingMetrics()
    cfg = _cfg(request_timeout_s=0.15, max_wait_ms=1.0)
    batcher = MicroBatcher(ScorerCache(4), metrics, cfg)

    # a caller that will give up (its model blocks past the timeout)
    def abandoned():
        with pytest.raises(TimeoutError):
            batcher.submit("m", blocker, _frame(4, base=1.0))

    t = threading.Thread(target=abandoned)
    t.start()
    time.sleep(0.05)
    # pile queued requests behind the blocked batch; their callers all
    # time out before the worker ever gets to them
    stale = [_Pending(_frame(2, base=float(i + 2)), blocker)
             for i in range(5)]
    with batcher._lock:
        w = batcher._workers[("m", "predict")]
        with w.cond:
            w.q.extend(stale)
            w.cond.notify_all()
    t.join(timeout=10)
    time.sleep(0.3)            # let every stale entry pass its timeout
    gate.set()                 # unblock the in-flight batch
    # a FRESH live request is still served promptly...
    out = batcher.submit("m", model, _frame(3, base=9.0))
    assert out.nrow == 3
    # ...and the stale ones were retired unscored (blocker scored only its
    # first batch — the expired queue never reached the device)
    deadline = time.time() + 5
    while time.time() < deadline \
            and metrics.counter("m", "expired") < len(stale):
        time.sleep(0.02)
    assert metrics.counter("m", "expired") == len(stale)
    assert blocker.calls == 1
    for p in stale:
        assert p.result is None and isinstance(p.error, TimeoutError)
    batcher.shutdown()


def test_batcher_schema_mismatch_never_coalesced():
    """Frames with different schemas must not rbind into one batch."""
    class TwoColModel(StubModel):
        def predict(self, fr):
            self.calls += 1
            cols = [fr.vec(n).numeric_np() for n in fr.names]
            return Frame.from_dict({"predict": np.sum(cols, axis=0)})

    model = TwoColModel()
    cfg = _cfg(max_wait_ms=50.0)
    metrics = ServingMetrics()
    batcher = MicroBatcher(ScorerCache(4), metrics, cfg)
    outs = {}

    def call(name, frame):
        outs[name] = batcher.submit("m", model, frame)

    t1 = threading.Thread(target=call, args=("a", _frame(4, n_features=3)))
    t2 = threading.Thread(target=call, args=("b", _frame(4, n_features=2)))
    t1.start()
    t2.start()
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert outs["a"].nrow == 4 and outs["b"].nrow == 4
    assert metrics.counter("m", "batches") == 2   # one per schema
    batcher.shutdown()


def test_idle_worker_expires_and_resurrects():
    model = StubModel()
    eng = ScoringEngine(_cfg(idle_worker_s=0.2, max_wait_ms=1.0))
    assert eng.score("m", model, _frame(4)).nrow == 4
    assert len(eng.batcher._workers) == 1
    deadline = time.time() + 10
    while eng.batcher._workers and time.time() < deadline:
        time.sleep(0.05)
    assert not eng.batcher._workers        # expired after quiet period
    assert eng.score("m", model, _frame(4)).nrow == 4   # fresh worker
    eng.shutdown()


def test_process_engine_reset_and_peek():
    old = get_engine()
    assert peek_engine() is old
    new = reset_engine(_cfg())
    assert new is not old and get_engine() is new
    assert new.score("m", StubModel(), _frame(4)).nrow == 4
    reset_engine()


# -- a real port model through the engine -------------------------------------

NAMES = [f"f{i}" for i in range(8)] + ["label"]


@pytest.fixture(scope="module")
def gbm():
    X, y = make_higgs_like(4000)
    fr = Frame.from_numpy(np.column_stack([X, y]), names=NAMES).asfactor("label")
    est = H2OGradientBoostingEstimator(ntrees=5, max_depth=4, seed=42,
                                       histogram_type="UniformAdaptive",
                                       device="cpu")
    est.train(y="label", training_frame=fr)
    return est.model


def test_engine_serves_a_port_gbm_like_predict(gbm):
    """Concurrent requests of 1-300 rows (coalesced into batches, padded to
    row buckets) each get what `model.predict` gives on their rows."""
    eng = ScoringEngine(_cfg(max_wait_ms=20.0))
    rng = np.random.default_rng(5)
    reqs = []
    for i, n in enumerate(rng.integers(1, 301, size=12)):
        X, y = make_higgs_like(int(n), seed=100 + i)
        X[::7, 3] = np.nan
        reqs.append(Frame.from_numpy(np.column_stack([X, y]), names=NAMES))
    with ThreadPoolExecutor(max_workers=6) as ex:
        outs = list(ex.map(lambda fr: eng.score("gbm", gbm, fr), reqs))
    for fr, out in zip(reqs, outs):
        want = gbm.predict(fr)
        assert out.names == want.names == ["predict", "0", "1"]
        assert out.nrow == fr.nrow
        np.testing.assert_allclose(np.asarray(out.vec("1").data),
                                   np.asarray(want.vec("1").data),
                                   rtol=0, atol=1e-6)
    snap = eng.snapshot()
    assert snap["cache"]["misses"] == 1
    assert snap["totals"]["fallback_scores"] == 0
    assert snap["failover"]["fallback_builds"] == 0
    assert all(b in (64, 128, 256) or b % 512 == 0
               for e in snap["cache"]["entries"] for b in e["warm_buckets"])
    eng.shutdown()


def _explain_requests(rng, k):
    reqs = []
    for i, n in enumerate(rng.integers(1, 301, size=k)):
        X, y = make_higgs_like(int(n), seed=200 + i)
        X[::7, 3] = np.nan
        reqs.append(Frame.from_numpy(np.column_stack([X, y]), names=NAMES))
    return reqs


def _labels(fr, n):
    v = fr.vec(n)
    if v.type == "enum":
        return np.asarray(v.domain, dtype=object)[np.asarray(v.data)]
    return np.asarray(v.data)


@pytest.mark.parametrize("kind,method", [
    ("contributions", "predict_contributions"),
    ("leaves", "predict_leaf_node_assignment")])
def test_engine_serves_explanations_like_the_model(gbm, kind, method):
    """"contributions" and "leaves" served from 6 threads (coalesced into
    batches, padded to row buckets) equal the model's own method on each
    request's rows exactly: a row's result does not depend on its batch."""
    eng = ScoringEngine(_cfg(max_wait_ms=20.0))
    reqs = _explain_requests(np.random.default_rng(6), 10)
    with ThreadPoolExecutor(max_workers=6) as ex:
        outs = list(ex.map(lambda fr: eng.score("gbm", gbm, fr,
                                                output_kind=kind), reqs))
    for fr, out in zip(reqs, outs):
        want = getattr(gbm, method)(fr)
        assert out.names == want.names and out.nrow == fr.nrow
        for n in want.names:
            np.testing.assert_array_equal(_labels(out, n), _labels(want, n))
    snap = eng.snapshot()
    assert snap["cache"]["misses"] == 1
    assert snap["totals"]["fallback_scores"] == 0
    eng.shutdown()


def test_contributions_failover_is_the_mojo_scorer(gbm):
    """A quarantined contributions scorer degrades to the MOJO scorer's
    `predict_contributions`; served under a device fault it answers what
    the model does."""
    fn, kind = build_fallback_scorer(gbm, "contributions")
    assert kind == "mojo-cpu"
    reqs = _explain_requests(np.random.default_rng(8), 3)
    for fr in reqs:
        got, want = fn(fr), gbm.predict_contributions(fr)
        assert got.names == want.names
        for n in want.names:
            np.testing.assert_allclose(np.asarray(got.vec(n).data),
                                       np.asarray(want.vec(n).data),
                                       rtol=0, atol=1e-10)
    eng = ScoringEngine(ServingConfig(max_wait_ms=1.0, breaker_reset_s=30.0))
    faults.arm("serving.scorer", error="device", rate=1.0)
    for fr in reqs:
        out = eng.score("g", gbm, fr, output_kind="contributions")
        want = gbm.predict_contributions(fr)
        np.testing.assert_allclose(np.asarray(out.vec("BiasTerm").data),
                                   np.asarray(want.vec("BiasTerm").data),
                                   rtol=0, atol=1e-10)
    t = eng.snapshot()["totals"]
    assert t["errors"] == 0 and t["fallback_scores"] >= 2
    assert eng.snapshot()["failover"]["fallback_scorers"][0]["kind"] == "mojo-cpu"
    eng.shutdown()


def test_scorer_cache_ledger_owner_measures_the_model(gbm):
    """The scorer cache accounts the model it wraps while the DKV does
    not hold it, and reports 0 while the DKV's owner does. An earlier
    test's engine that served the same model sits in a reference cycle
    until the collector runs, and its cache's owner would claim the model's
    bytes first; collect it before the ledger pass."""
    gc.collect()
    cache = ScorerCache(4)
    cache.get_or_build("ledger_m", gbm)
    owner = "scorer:ledger_m:predict"
    host, dev = memory_ledger.measure(gbm)
    assert host > 0 and dev == 0          # a CPU model: host tensors
    memory_ledger.refresh(force=True)
    row = next(o for o in memory_ledger.owners(owner))
    assert row["host_bytes"] == host
    DKV.put("ledger_m", gbm)
    try:
        memory_ledger.refresh(force=True)
        assert memory_ledger.owners(owner)[0]["host_bytes"] == 0
        assert memory_ledger.owners("dkv:ledger_m")[0]["host_bytes"] == host
    finally:
        DKV.remove("ledger_m")
        cache.invalidate()


def test_measure_splits_tensors_by_device():
    t = torch.zeros(10, dtype=torch.float32)
    assert memory_ledger.measure({"a": t, "b": np.zeros(4, np.int64)}) == (72, 0)


# -- scorer failover (tests/test_faults.py) -----------------------------------

def test_engine_serves_a_multinomial_model_like_predict():
    """A 4-class GBM served from 4 threads: each response has the
    reference's output columns (`predict` and one probability per class)
    and equals `model.predict` on its rows."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(1200, 5))
    y = np.argmax(2 * X[:, :4] + 0.5 * rng.normal(size=(1200, 4)), axis=1)
    names = [f"x{i}" for i in range(5)] + ["y"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("y")
    est = H2OGradientBoostingEstimator(ntrees=3, max_depth=3, seed=1,
                                       device="cpu")
    model = est.train(y="y", training_frame=fr).model
    eng = ScoringEngine(_cfg(max_wait_ms=10.0))
    reqs = [Frame.from_numpy(rng.normal(size=(int(n), 5)), names=names[:5])
            for n in rng.integers(1, 200, size=8)]
    with ThreadPoolExecutor(max_workers=4) as ex:
        outs = list(ex.map(lambda r: eng.score("multi", model, r), reqs))
    cols = ["predict", "0", "1", "2", "3"]
    for r, out in zip(reqs, outs):
        want = model.predict(r)
        assert out.names == want.names == cols and out.nrow == r.nrow
        labels = [[v.domain[c] for c in v.data]
                  for v in (out.vec("predict"), want.vec("predict"))]
        assert labels[0] == labels[1]
        for c in cols[1:]:
            np.testing.assert_allclose(np.asarray(out.vec(c).data),
                                       np.asarray(want.vec(c).data),
                                       rtol=0, atol=1e-6)
    snap = eng.snapshot()
    assert snap["cache"]["misses"] == 1 and snap["totals"]["errors"] == 0
    assert snap["totals"]["fallback_scores"] == 0
    eng.shutdown()


@pytest.fixture(scope="module")
def glm_model():
    d, types = glm_frame(3000, 0, "binomial")
    fr = Frame.from_dict(d, column_types=types)
    est = H2OGeneralizedLinearEstimator(family="binomial", lambda_=0.0,
                                        device="cpu")
    return est.train(x=X_COLS, y="y", training_frame=fr).model


def _glm_requests(rng, k):
    """k requests of 1-300 rows of the GLM's columns; some carry a level
    the fit never saw and NaNs (the design maps both as at fit)."""
    reqs = []
    for i in range(k):
        n = int(rng.integers(1, 301))
        d, types = glm_frame(n, 50 + i, "binomial")
        d.pop("y")
        types.pop("y", None)
        if i % 3 == 0:
            d["c1"] = d["c1"].copy()
            d["c1"][::2] = "BOS"
            d["b"] = d["b"].copy()
            d["b"][::5] = np.nan
        reqs.append(Frame.from_dict(d, column_types=types))
    return reqs


def test_engine_serves_a_glm_like_predict(glm_model):
    """A binomial GLM served from 6 threads: coalesced batches (their enum
    domains merged), padded to row buckets; each response equals
    `model.predict` on its rows, and no batch took the fallback."""
    eng = ScoringEngine(_cfg(max_wait_ms=20.0))
    reqs = _glm_requests(np.random.default_rng(6), 12)
    with ThreadPoolExecutor(max_workers=6) as ex:
        outs = list(ex.map(lambda fr: eng.score("glm", glm_model, fr), reqs))
    for fr, out in zip(reqs, outs):
        want = glm_model.predict(fr)
        assert out.names == want.names == ["predict", "no", "yes"]
        assert out.nrow == fr.nrow
        for c in ("no", "yes"):
            np.testing.assert_allclose(np.asarray(out.vec(c).data),
                                       np.asarray(want.vec(c).data),
                                       rtol=0, atol=1e-6)
        labels = [[v.domain[c] for c in v.data]
                  for v in (out.vec("predict"), want.vec("predict"))]
        assert labels[0] == labels[1]
    snap = eng.snapshot()
    assert snap["cache"]["misses"] == 1 and snap["totals"]["errors"] == 0
    assert snap["totals"]["fallback_scores"] == 0
    assert snap["failover"]["fallback_builds"] == 0
    eng.shutdown()


def test_glm_fallback_scorer_is_its_mojo(glm_model):
    """A quarantined GLM degrades to its numpy MOJO scorer (f64 expansion
    and matvec), which predicts what the model does within 1e-6."""
    fn, kind = build_fallback_scorer(glm_model, "predict")
    assert kind == "mojo-cpu"
    for fr in _glm_requests(np.random.default_rng(7), 3):
        got, want = fn(fr), glm_model.predict(fr)
        assert got.names == want.names
        np.testing.assert_allclose(np.asarray(got.vec("yes").data),
                                   np.asarray(want.vec("yes").data),
                                   rtol=0, atol=1e-6)


def _serving_model(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0)
    fr = Frame.from_numpy(np.column_stack([X, y]),
                          names=[f"x{i}" for i in range(4)] + ["y"]).asfactor("y")
    est = H2OGradientBoostingEstimator(ntrees=3, max_depth=2, seed=1,
                                       device="cpu")
    est.train(y="y", training_frame=fr)
    return est.model, fr


def test_scorer_quarantine_rebuild_and_cpu_fallback():
    model, fr = _serving_model(200, seed=11)
    eng = ScoringEngine(ServingConfig(max_wait_ms=1.0, breaker_reset_s=0.3))
    test = Frame({n: fr.vec(n) for n in fr.names if n != "y"})
    clean = eng.score("m1", model, test).vec("predict").to_numpy()

    faults.arm("serving.scorer", error="device", rate=1.0)
    # every request is served via quarantine / fallback — no unhandled
    # error reaches the caller
    for _ in range(3):
        out = eng.score("m1", model, test).vec("predict").to_numpy()
        assert (out == clean).all()
    t = eng.snapshot()["totals"]
    assert t["errors"] == 0
    assert t["scorer_faults"] >= 2
    assert t["quarantines"] == 1          # quarantined once, then breaker
    assert t["breaker_opens"] == 1
    assert t["fallback_scores"] >= 3
    st = eng.snapshot()["failover"]
    assert st["breakers"][0]["state"] == "open"
    assert st["fallback_scorers"][0]["kind"] == "mojo-cpu"

    # fault clears → the half-open probe recovers the primary path
    faults.reset()
    time.sleep(0.35)
    eng.score("m1", model, test)
    assert eng.snapshot()["failover"]["breakers"][0]["state"] == "closed"
    t2 = eng.snapshot()["totals"]
    eng.score("m1", model, test)
    t3 = eng.snapshot()["totals"]
    assert t3["fallback_scores"] == t2["fallback_scores"]   # primary again
    eng.shutdown()


def test_scorer_transient_fault_rebuild_once_no_breaker():
    """One bad score then a healthy rebuild: quarantine + rebuild, breaker
    stays closed, nothing falls back."""
    model, fr = _serving_model(150, seed=12)
    eng = ScoringEngine(ServingConfig(max_wait_ms=1.0))
    test = Frame({n: fr.vec(n) for n in fr.names if n != "y"})
    faults.arm("serving.scorer", error="device", count=1)
    out = eng.score("m2", model, test)
    assert out.nrow == test.nrow
    t = eng.snapshot()["totals"]
    assert t["quarantines"] == 1 and t["scorer_rebuilds"] == 1
    assert t["breaker_opens"] == 0 and t["fallback_scores"] == 0
    eng.shutdown()


def test_non_device_scoring_error_still_fails_the_request():
    """Failover is for SCORER faults; a bad request keeps its own error
    instead of being silently served by the fallback."""
    model, fr = _serving_model(100, seed=13)
    eng = ScoringEngine(ServingConfig(max_wait_ms=1.0))
    bad = Frame({"wrong": fr.vec("x0")})
    with pytest.raises(KeyError):
        eng.score("m3", model, bad)
    t = eng.snapshot()["totals"]
    assert t["quarantines"] == 0 and t["fallback_scores"] == 0
    assert t["errors"] == 1
    eng.shutdown()


def test_kernel_failure_reaches_the_caller_not_the_fallback(monkeypatch,
                                                            tmp_path):
    """A scoring kernel that fails to build is the kernel's fault, not the
    card's: the request fails with `KernelError`, and nothing is
    quarantined or served by the numpy fallback. The model's tensors lie on
    the meta device, so `forest_score` takes its device path (checks, then
    the build) with no card; the build runs a compiler that fails."""
    model, fr = _serving_model(100, seed=14)
    model.forest = [Tree(*[t.to("meta") for t in f]) for f in model.forest]
    model.device = torch.device("meta")
    monkeypatch.setattr(score_cuda, "_lib", None)
    monkeypatch.setattr(hist_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(hist_cuda, "_nvcc", lambda: "false")
    eng = ScoringEngine(ServingConfig(max_wait_ms=1.0))
    test = Frame({n: fr.vec(n) for n in fr.names if n != "y"})
    for _ in range(2):
        with pytest.raises(hist_cuda.KernelError, match="nvcc failed on "
                                                        "score.cu"):
            eng.score("mk", model, test)
    snap = eng.snapshot()
    t, fo = snap["totals"], snap["failover"]
    assert t["errors"] == 2 and t["scorer_faults"] == 0
    assert t["quarantines"] == 0 and t["breaker_opens"] == 0
    assert t["fallback_scores"] == 0 and fo["fallback_builds"] == 0
    assert fo["breakers"] == []
    eng.shutdown()


def test_half_open_probe_aborted_by_bad_request_does_not_wedge():
    """A half-open probe that dies on the REQUEST's own bad rows must give
    the probe slot back: the next healthy request re-probes and closes the
    breaker instead of the model being pinned to the fallback forever."""
    model, fr = _serving_model(150, seed=14)
    eng = ScoringEngine(ServingConfig(max_wait_ms=1.0, breaker_reset_s=0.2))
    test = Frame({n: fr.vec(n) for n in fr.names if n != "y"})
    faults.arm("serving.scorer", error="device", rate=1.0)
    eng.score("m4", model, test)          # opens the breaker
    faults.reset()                        # device "recovers"
    time.sleep(0.25)
    bad = Frame({"wrong": fr.vec("x0")})
    with pytest.raises(KeyError):
        eng.score("m4", model, bad)       # elected prober, dies on rows
    # a later healthy request must still be able to probe + close
    eng.score("m4", model, test)
    assert eng.snapshot()["failover"]["breakers"][0]["state"] == "closed"
    eng.shutdown()


def test_serving_metrics_expose_failover_section():
    eng = ScoringEngine(ServingConfig())
    snap = eng.snapshot()
    assert snap["failover"]["cpu_fallback_enabled"] is True
    assert snap["failover"]["fallback_builds"] == 0
    assert snap["config"]["breaker_reset_s"] == 30.0
    from h2o3_tpu_torch.runtime import metrics_registry as reg

    model = StubModel()
    eng.score("mreg", model, _frame(4))
    fam = reg.get("h2o3_serving_requests")
    assert fam is not None and fam.value("mreg") >= 1
    assert reg.rest_bindings()["serving"]["totals.requests"] == \
        "h2o3_serving_requests"
    eng.shutdown()


# -- the fault registry (tests/test_faults.py) ---------------------------------

def test_faults_default_off_and_reset():
    assert not faults.active()
    faults.check("serving.scorer")               # unarmed: a no-op
    faults.arm("serving.scorer", error="device")
    assert faults.active()
    with pytest.raises(faults.InjectedDeviceError):
        faults.check("serving.scorer")
    faults.reset()
    assert not faults.active() and faults.snapshot()["points"] == []


def test_faults_seeded_rate_is_deterministic():
    def fires(seed):
        faults.reset()
        faults.arm("serving.scorer", error="io", rate=0.3, seed=seed)
        out = []
        for _ in range(40):
            try:
                faults.check("serving.scorer")
                out.append(0)
            except faults.InjectedIOError:
                out.append(1)
        return out

    a, b, c = fires(7), fires(7), fires(8)
    assert a == b and a != c and 0 < sum(a) < 40


def test_faults_count_and_match_scope():
    faults.arm("serving.scorer", error="crash", count=2, match="m@v2")
    faults.check("serving.scorer", "m@v1")        # out of scope
    for _ in range(2):
        with pytest.raises(faults.InjectedCrash):
            faults.check("serving.scorer", "m@v2")
    faults.check("serving.scorer", "m@v2")        # count spent
    d = faults.snapshot()["points"][0]
    assert d["fires"] == 2 and d["checks"] == 3


def test_faults_env_arming(monkeypatch):
    monkeypatch.setenv("H2O3_FAULT_SERVING_SCORER",
                       "error=device,count=1,seed=3")
    faults._env_parse()
    d = faults.snapshot()["points"][0]
    assert d["point"] == "serving.scorer" and d["error"] == "device"
    assert d["count"] == 1 and d["seed"] == 3


# -- device-error classification ------------------------------------------------

@pytest.mark.parametrize("exc,device", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (hist_cuda.KernelError("forest scoring kernel launch failed: CUDA "
                           "runtime status 700"), False),
    (RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm"), True),
    (faults.InjectedDeviceError("injected fault at serving.scorer"), True),
    (RuntimeError("h2o3_tpu_torch runs on cuda, and "
                  "torch.cuda.is_available() is False"), False),
    (RuntimeError("nvcc not found"), False),
    (ValueError("CUDA error in a request field"), False),
    (TypeError("forest_score takes int32 feat"), False),
    (KeyError("f3"), False),
    (hist_cuda.KernelError("nvcc failed on score.cu (1):\nCUDA error in "
                           "line 81"), False),
])
def test_is_device_error_on_torch_errors(exc, device):
    assert retry.is_device_error(exc) is device


def test_accelerator_error_is_a_device_error():
    err_type = getattr(torch, "AcceleratorError", None)
    if err_type is None:
        pytest.skip("this torch has no AcceleratorError")
    assert retry.is_device_error(err_type("CUDA error: unspecified launch "
                                          "failure"))


def test_kernel_launch_status_raises_kernel_error():
    hist_cuda.check_launch(0, "forest scoring kernel")
    with pytest.raises(hist_cuda.KernelError) as err:
        hist_cuda.check_launch(1, "forest scoring kernel")
    assert "launch failed" in str(err.value)
    assert not retry.is_device_error(err.value)


def test_missing_nvcc_is_a_kernel_error(monkeypatch, tmp_path):
    monkeypatch.setattr(hist_cuda.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(hist_cuda.KernelError, match="nvcc not found") as err:
        hist_cuda._nvcc()
    assert not retry.is_device_error(err.value)
