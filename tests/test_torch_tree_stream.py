"""The out-of-core tree path of the port: the block store with its disk
tier, the streamed GBM/DRF step and GOSS (`h2o3_tpu_torch/models/
block_store.py`, `tree_stream.py`, `shared_tree._ooc_plan`), on the CPU.

Port against itself, on the reference's 1,500 x 8 fixture
(`tests/test_tree_stream.py`) with at most 10 trees:

- a streamed GBM with a firing early stop and a streamed DRF with row
  sampling, mtries and out-of-bag metrics, both at S = 4, equal the
  blocks-lane fit (``H2O3_TREE_SHARD=1``, S = 4) bit for bit: forest,
  varimp, scoring history, tree count and predictions; so do the same
  fits through the disk tier, a spilled fit after an injected
  ``persist.read`` fault, and a 2-fold CV with fold reuse;
- ``H2O3_TREE_OOC=0`` under a tiny budget equals a plain fit bit for bit,
  and ``auto`` streams only a matrix over the budget;
- GOSS is deterministic, streams fewer bytes than the unsampled fit,
  samples exactly its top fraction on tied gradients and validates as the
  reference does;
- the block store's LRU order, its pressure shed, spill/restore byte
  identity (also under a read fault) and the spill owner's leak;
- `pack_host_range` is byte-identical to a slice of `pack_host`.

Port against the JAX package (the reference on a one-device cloud on the
CPU, the same frame, seed and knobs): a streamed GBM, a streamed DRF and a
GOSS fit have the same split feature, bin and flag at every node, leaf
values within rtol 1e-5 (atol 1e-6 for values near 0) and predictions
within 1e-6.

Every knob is set through `monkeypatch.setenv` and the dataset cache is
cleared around each test, so no state outlives its test.
"""

import gc
import os

import numpy as np
import pytest
import torch

import jax

from conftest import make_classification
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import dataset_cache as ref_cache
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import block_store as bslib
from h2o3_tpu_torch.models import dataset_cache
from h2o3_tpu_torch.ops import packing
from h2o3_tpu_torch.runtime import faults, phases
from h2o3_tpu_torch.runtime import memory_ledger as ml
from h2o3_tpu_torch.runtime.timeline import Timeline

from test_torch_deeplearning import one_torch_thread  # noqa: F401

_X, _Y = make_classification(n=1500, f=8, seed=3)
_NAMES = [f"f{i}" for i in range(8)] + ["label"]
_KNOBS = ("H2O3_TREE_OOC", "H2O3_STREAM_BLOCKS", "H2O3_STREAM_BUDGET_MB",
          "H2O3_TREE_SHARD", "H2O3_TREE_SHARD_BLOCKS",
          "H2O3_STREAM_HOST_BUDGET_MB", "H2O3_TREE_OOC_DISK",
          "H2O3_SPILL_DIR", "H2O3_MEM_BUDGET_MB", "H2O3_MEM_EVICT_PRESSURE",
          "H2O3_DATASET_CACHE")
# the streamed fit and its in-core comparator share S = 4
STREAM = {"H2O3_TREE_OOC": "1", "H2O3_STREAM_BLOCKS": "4",
          "H2O3_STREAM_BUDGET_MB": "0.02"}
BLOCKS = {"H2O3_TREE_OOC": "0", "H2O3_TREE_SHARD": "1",
          "H2O3_TREE_SHARD_BLOCKS": "4"}
# a host budget under the packed matrix: blocks live on disk mid-fit
SPILL = dict(STREAM, H2O3_STREAM_HOST_BUDGET_MB="0.005")
LEAF_RTOL, LEAF_ATOL, PRED_TOL = 1e-5, 1e-6, 1e-6


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("H2O3_SPILL_DIR", str(tmp_path))
    dataset_cache.clear()
    yield
    dataset_cache.clear()
    faults.reset()


def _frame(X=_X, y=_Y, names=_NAMES, factor=True, cls=Frame):
    fr = cls.from_numpy(np.column_stack([X, y]), names=names)
    return fr.asfactor("label") if factor else fr


def _fit(mp, env, mode="gbm", frame=None, **params):
    for k in _KNOBS:
        if k != "H2O3_SPILL_DIR":
            mp.delenv(k, raising=False)
    for k, v in env.items():
        mp.setenv(k, v)
    dataset_cache.clear()
    cls = (H2OGradientBoostingEstimator if mode == "gbm"
           else H2ORandomForestEstimator)
    est = cls(seed=42, device="cpu", **params)
    est.train(y="label", training_frame=frame if frame is not None
              else _frame())
    return est.model


def _assert_bitexact(a, b):
    assert a.ntrees_built == b.ntrees_built
    for k in range(len(a.forest)):
        for f in a.forest[k]._fields:
            assert torch.equal(getattr(a.forest[k], f),
                               getattr(b.forest[k], f)), (k, f)
    assert a.varimp_table == b.varimp_table
    keys = ("number_of_trees", "logloss", "training_deviance")
    assert [[e.get(k) for k in keys] for e in a.scoring_history] == \
        [[e.get(k) for k in keys] for e in b.scoring_history]
    fr = _frame()
    pa, pb = a.predict(fr), b.predict(fr)
    assert np.array_equal(np.asarray(pa.vec("1").data),
                          np.asarray(pb.vec("1").data))


def _assert_spilled_under_budget(st):
    assert st["spilled_blocks"] > 0 and st["restored_blocks"] > 0
    per_block = st["spilled_bytes"] // max(st["spilled_blocks"], 1)
    assert st["resident_host_peak"] <= max(int(0.005 * 1e6), 2 * per_block)


def test_pack_host_range_is_a_slice_of_the_whole_pack():
    rng = np.random.default_rng(5)
    for bits, B in ((4, 16), (5, 21), (6, 33)):
        codes = rng.integers(0, B, (256, 6)).astype(np.uint8)
        whole = packing.pack_host(codes, bits)
        group, gbytes = packing.GROUP_ROWS[bits], packing.GROUP_BYTES[bits]
        r0, r1 = 4 * group, 12 * group
        np.testing.assert_array_equal(
            packing.pack_host_range(codes, bits, r0, r1),
            whole[r0 // group * gbytes:r1 // group * gbytes])
    with pytest.raises(ValueError):
        packing.pack_host_range(codes, 5, 3, 19)


# -- the block store ----------------------------------------------------------

def _blocks(n_blocks=4, rows=64, F=4):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 16, (rows, F)).astype(np.uint8)
            for _ in range(n_blocks)]


def _cursor() -> int:
    last = Timeline.snapshot(n=1)
    return last[-1]["seq"] if last else 0


def _memory_events(cur, owner, **match):
    return [e for e in Timeline.snapshot(n=100000, since=cur)
            if e["kind"] == "memory" and e["owner"].startswith(owner)
            and all(e.get(k) == v for k, v in match.items())]


def test_block_store_lru_eviction_and_pressure_shed(monkeypatch):
    """Under a 2-block budget `get` evicts LRU first (trigger "cap"); past
    the ledger's eviction threshold it sheds every block but the double
    buffer before it uploads (trigger "pressure")."""
    blocks = _blocks()
    nb = blocks[0].nbytes
    st = bslib.BlockStore(blocks, 64, 0, budget_bytes=2 * nb, register=False)
    cur = _cursor()
    for b in range(4):
        st.get(b)
    assert st.resident_bytes() == 2 * nb
    evs = _memory_events(cur, st.owner, trigger="cap")
    assert [e["owner"] for e in evs] == [f"{st.owner}:block0",
                                         f"{st.owner}:block1"]
    assert st.counters["uploaded"] == 4 and st.counters["evicted"] == 2
    st.get(2)
    assert st.counters["reused"] == 1
    monkeypatch.setenv("H2O3_MEM_BUDGET_MB", "1")
    monkeypatch.setenv("H2O3_MEM_EVICT_PRESSURE", "0.5")
    ml.refresh(force=True)
    cur = _cursor()
    st.get(0)
    monkeypatch.delenv("H2O3_MEM_BUDGET_MB")
    ml.refresh(force=True)
    evs = _memory_events(cur, st.owner, trigger="pressure")
    # LRU order: block 2 was touched after block 3
    assert [e["owner"] for e in evs] == [f"{st.owner}:block3",
                                         f"{st.owner}:block2"]
    assert st.resident_bytes() == nb
    st.close()


@pytest.mark.parametrize("fault", [False, True])
def test_block_store_spill_and_restore_byte_identical(fault):
    """A 4-block store over a 2-block host budget spills LRU first, its
    restores are byte-identical (an armed `persist.read` fault resumes
    under the retry policy), the host watermark stays under the budget,
    and `close()` removes the files and the directory."""
    blocks = _blocks()
    ref = [b.copy() for b in blocks]
    nb = blocks[0].nbytes
    cur = _cursor()
    st = bslib.BlockStore(blocks, 64, 0, budget_bytes=2 * nb,
                          host_budget_bytes=2 * nb, register=False)
    evs = _memory_events(cur, st.owner, space="disk")
    assert [e["owner"] for e in evs] == [f"{st.owner}:block0",
                                         f"{st.owner}:block1"]
    assert st.host_bytes() == 2 * nb and st.disk_bytes() == 2 * nb
    assert sorted(os.listdir(st._spill_dir)) == ["block0.bin", "block1.bin"]
    st.peak_window_start()
    if fault:
        faults.arm("persist.read", error="io", count=1)
    got = st.fetch_host(1)
    if fault:
        assert faults.snapshot()["points"][0]["fires"] == 1
        faults.reset()
    np.testing.assert_array_equal(got, ref[1])
    assert os.path.exists(st._spill_path(1))      # the spilled copy is kept
    for b in range(4):
        np.testing.assert_array_equal(st.fetch_host(b), ref[b])
        np.testing.assert_array_equal(st.get(b).numpy(), ref[b])
    assert st.host_peak_window_bytes() <= st.host_budget_bytes()
    sd = st._spill_dir
    st.close()
    assert not os.path.exists(sd)


def test_spill_owner_reports_disk_bytes_and_its_leak():
    """Spill files are the `block_store` kind's disk bytes; a store dropped
    without `close()` leaves its dead `:spill` owner reporting them (a
    leak), which clears when the files go."""
    blocks = _blocks()
    nb = blocks[0].nbytes
    st = bslib.BlockStore(blocks, 64, 0, budget_bytes=2 * nb,
                          host_budget_bytes=2 * nb, register=False)
    owner, sd = st.owner, st._spill_dir
    snap = ml.refresh(force=True)
    assert snap["by_kind"]["block_store"]["disk_bytes"] >= 2 * nb
    del st
    gc.collect()
    snap = ml.refresh(force=True)
    leaks = [lk for lk in snap["leaks"] if lk["owner"] == f"{owner}:spill"]
    assert leaks and leaks[0]["bytes"] >= 2 * nb
    for f in os.listdir(sd):
        os.remove(os.path.join(sd, f))
    os.rmdir(sd)
    snap = ml.refresh(force=True)
    assert not any(lk["owner"] == f"{owner}:spill" for lk in snap["leaks"])


# -- streamed == the blocks lane, bit for bit -------------------------------

GBM_STOP = dict(ntrees=10, max_depth=3, learn_rate=0.3, score_tree_interval=2,
                stopping_rounds=2, stopping_tolerance=0.5)
DRF_SAMPLED = dict(ntrees=5, max_depth=3, sample_rate=0.7, mtries=3)
BITEXACT_CASES = {
    "gbm_early_stop": ("gbm", STREAM, GBM_STOP),
    "drf_sampled_mtries_oob": ("drf", STREAM, DRF_SAMPLED),
    "gbm_spilled": ("gbm", SPILL, GBM_STOP),
    "drf_spilled": ("drf", SPILL, DRF_SAMPLED),
    "gbm_spilled_read_fault": ("gbm", SPILL, dict(ntrees=3, max_depth=3)),
    "gbm_cv_reuse": ("gbm", STREAM, dict(ntrees=4, max_depth=3, nfolds=2)),
}


@pytest.mark.parametrize("case", list(BITEXACT_CASES))
def test_streamed_equals_the_blocks_lane(monkeypatch, case):
    mode, env, params = BITEXACT_CASES[case]
    if case.endswith("read_fault"):
        faults.arm("persist.read", error="io", count=1)
    a = _fit(monkeypatch, env, mode, **params)
    st = a._stream_stats
    if case.endswith("read_fault"):
        assert faults.snapshot()["points"][0]["fires"] == 1
        faults.reset()
    assert st["blocks"] == 4 and st["streamed_bytes"] > 0
    if env is SPILL:
        _assert_spilled_under_budget(st)
    b = _fit(monkeypatch, BLOCKS, mode, **params)
    assert not hasattr(b, "_stream_stats")
    _assert_bitexact(a, b)
    if case == "gbm_early_stop":
        assert a.ntrees_built < 10, "early stop never fired"
    if case == "gbm_cv_reuse":
        ma, mb = a.cross_validation_metrics, b.cross_validation_metrics
        assert ma.logloss() == mb.logloss() and ma.auc() == mb.auc()
        for fa, fb in zip(a.cross_validation_models,
                          b.cross_validation_models):
            _assert_bitexact(fa, fb)


def test_escape_hatch_and_auto(monkeypatch):
    """``H2O3_TREE_OOC=0`` under a tiny budget is a plain fit, bit for bit;
    ``auto`` streams a matrix over the budget and not one under it."""
    params = dict(ntrees=4, max_depth=3)
    a = _fit(monkeypatch, {"H2O3_TREE_OOC": "0",
                           "H2O3_STREAM_BUDGET_MB": "0.001"}, **params)
    assert not hasattr(a, "_stream_stats")
    _assert_bitexact(a, _fit(monkeypatch, {}, **params))
    small = _fit(monkeypatch, {"H2O3_STREAM_BUDGET_MB": "0.002"}, **params)
    assert small._stream_stats["blocks_uploaded"] > 0
    big = _fit(monkeypatch, {"H2O3_STREAM_BUDGET_MB": "100"}, **params)
    assert not hasattr(big, "_stream_stats")


def test_stream_counters_phases_and_totals(monkeypatch):
    """A streamed fit's bytes are a read: `_stream_stats`, the
    ``h2d_stream`` phase, the registry family and the process totals."""
    from h2o3_tpu_torch.runtime import metrics_registry as reg

    before = phases.snapshot().get("bytes_h2d_stream", 0)
    st = _fit(monkeypatch, STREAM, ntrees=3, max_depth=3)._stream_stats
    assert st["blocks"] == 4 and st["blocks_uploaded"] >= 4
    assert st["resident_block_peak"] > 0 and st["goss"] is False
    assert st["bytes_per_tree"] == st["streamed_bytes"] // 3
    assert phases.snapshot()["bytes_h2d_stream"] - before \
        == st["streamed_bytes"]
    assert reg.get("h2o3_tree_stream_bytes").value() >= st["streamed_bytes"]
    assert bslib.process_totals()["streamed_bytes"] >= st["streamed_bytes"]


# -- GOSS ---------------------------------------------------------------------

GOSS_ENV = dict(STREAM, H2O3_STREAM_BUDGET_MB="0.004")


def test_goss_streams_fewer_bytes_and_repeats(monkeypatch):
    params = dict(ntrees=6, max_depth=3, learn_rate=0.2)
    plain = _fit(monkeypatch, GOSS_ENV, **params)
    assert plain._stream_stats["blocks_evicted"] > 0
    g1 = _fit(monkeypatch, GOSS_ENV, goss=True, goss_start_tree=2, **params)
    g2 = _fit(monkeypatch, GOSS_ENV, goss=True, goss_start_tree=2, **params)
    assert g1._stream_stats["goss"] is True
    assert (g1._stream_stats["streamed_bytes"]
            < plain._stream_stats["streamed_bytes"])
    _assert_bitexact(g1, g2)


def test_goss_samples_tied_gradients_exactly(monkeypatch):
    """Quantile loss ties every row's |g|: the sample still takes exactly
    the top fraction (an exact-count `argpartition`), not every row."""
    from h2o3_tpu_torch.models import tree_stream

    rng = np.random.default_rng(13)
    X = rng.normal(size=(1200, 6))
    y = X[:, 0] * 2 + rng.normal(scale=0.2, size=1200)
    names = [f"f{i}" for i in range(6)] + ["label"]
    sizes = []
    real = tree_stream.StreamedTreeStep._gather_codes

    def spy(self, sel, F):
        sizes.append(len(sel))
        return real(self, sel, F)

    monkeypatch.setattr(tree_stream.StreamedTreeStep, "_gather_codes", spy)
    m = _fit(monkeypatch, STREAM, frame=_frame(X, y, names, factor=False),
             distribution="quantile", ntrees=4, max_depth=3, goss=True,
             goss_start_tree=1)
    assert m._stream_stats["goss"] is True and len(sizes) == 3
    # 240 top rows and a ~1/8 draw of the other 960
    assert all(240 < s < 240 + 2 * 120 for s in sizes), sizes


def test_goss_validation_and_ineligible_fallback(monkeypatch):
    with pytest.raises(ValueError, match="goss rates"):
        _fit(monkeypatch, STREAM, ntrees=2, max_depth=2, goss=True,
             goss_top_rate=0.9, goss_other_rate=0.3)
    with pytest.raises(ValueError, match="goss rates"):
        _fit(monkeypatch, STREAM, ntrees=2, max_depth=2, goss=True,
             goss_top_rate=0.0)
    with pytest.raises(ValueError, match="goss_start_tree"):
        _fit(monkeypatch, STREAM, ntrees=2, max_depth=2, goss=True,
             goss_start_tree=0)
    with pytest.raises(ValueError, match="sample_rate"):
        _fit(monkeypatch, STREAM, ntrees=2, max_depth=2, goss=True,
             sample_rate=0.5)
    # out of core turned off: the fit warns and trains unsampled
    m = _fit(monkeypatch, {"H2O3_TREE_OOC": "0"}, ntrees=3, max_depth=3,
             goss=True)
    assert not hasattr(m, "_stream_stats")
    _assert_bitexact(m, _fit(monkeypatch, {}, ntrees=3, max_depth=3))


# -- against the JAX package --------------------------------------------------

REF_CASES = {
    "gbm": (RefGBM, "gbm", GBM_STOP),
    "drf": (RefDRF, "drf", DRF_SAMPLED),
    "goss": (RefGBM, "gbm", dict(ntrees=5, max_depth=3, learn_rate=0.2,
                                 goss=True, goss_start_tree=2)),
}


@pytest.mark.parametrize("case", list(REF_CASES))
def test_streamed_fit_matches_the_reference(monkeypatch, case):
    ref_cls, mode, params = REF_CASES[case]
    port = _fit(monkeypatch, STREAM, mode, **params)
    ref_cache.clear()
    mesh.init(jax.devices()[:1])
    try:
        ref = ref_cls(seed=42, **params)
        ref.train(y="label", training_frame=_frame(cls=RefFrame))
        ref_pred = ref.model.predict(_frame(cls=RefFrame))
    finally:
        mesh.reset()
        ref_cache.clear()
    assert ref.model._stream_stats["blocks"] == port._stream_stats["blocks"]
    assert port.ntrees_built == ref.model.ntrees_built
    rf, pf = ref.model.forest[0], port.forest[0]
    for f in ("feat", "bin", "is_split"):
        np.testing.assert_array_equal(getattr(pf, f).numpy(),
                                      np.asarray(getattr(rf, f)), err_msg=f)
    np.testing.assert_allclose(pf.value.numpy(), np.asarray(rf.value),
                               rtol=LEAF_RTOL, atol=LEAF_ATOL)
    got = np.asarray(port.predict(_frame()).vec("1").data)
    np.testing.assert_allclose(got, np.asarray(ref_pred.vec("1").data),
                               rtol=0, atol=PRED_TOL)
