"""The port's dataset cache (`h2o3_tpu_torch/models/dataset_cache.py`) and
the estimator engine's std layer, on the CPU.

- A second GBM on one frame hits the matrix, bins and device layers; keys
  keep nbins, histogram types, x lists and Random seeds apart; an
  in-place column assignment (`Frame._touch`) invalidates the entry; the
  entry and byte caps evict LRU first; ``H2O3_DATASET_CACHE=0`` keeps no
  entry.
- A cache-on fit equals a cache-off fit bit for bit (GBM and DRF, the
  second candidate served from the cache).
- K-Means and PCA on one numeric frame share one std artifact, which a
  GLM on that frame's entry leaves alone; a cached design books zero
  design seconds.
- A dead frame drops its ledger owners without a leak, and the CV fold
  counters count both fold paths.
- The cache layers equal the reference's: the `BinnedMatrix` codes and
  the packed device codes a GBM fit leaves in the JAX package's cache are
  byte-identical to the port's.

Knobs are set through `monkeypatch.setenv`; the cache is cleared around
each test.
"""

import gc

import numpy as np
import pytest
import torch

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import dataset_cache as ref_cache
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.estimators import (H2OGeneralizedLinearEstimator,
                                       H2OGradientBoostingEstimator,
                                       H2OKMeansEstimator,
                                       H2OPrincipalComponentAnalysisEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import dataset_cache as dsc
from h2o3_tpu_torch.models import estimator_engine as est
from h2o3_tpu_torch.runtime import memory_ledger as ml
from h2o3_tpu_torch.runtime import trainpool

from test_torch_deeplearning import one_torch_thread  # noqa: F401

N, F = 1500, 8
NAMES = [f"f{i}" for i in range(F)] + ["label"]


def _data(seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, F))
    y = ((X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=N)) > 0)
    return np.column_stack([X, y.astype(float)])


def _frame(cls=Frame, seed=3):
    return cls.from_numpy(_data(seed), names=NAMES).asfactor("label")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("H2O3_DATASET_CACHE", "H2O3_DATASET_CACHE_ENTRIES",
              "H2O3_DATASET_CACHE_MB", "H2O3_TREE_OOC", "H2O3_TREE_SHARD",
              "H2O3_CV_REBIN", "H2O3_EST_LEGACY"):
        monkeypatch.delenv(k, raising=False)
    dsc.clear()
    dsc.reset_stats()
    yield
    dsc.clear()


def _gbm(fr, **kw):
    p = dict(ntrees=3, max_depth=3, seed=42, device="cpu")
    p.update(kw)
    e = H2OGradientBoostingEstimator(**p)
    e.train(y="label", training_frame=fr)
    return e.model


def _delta(before, after, *keys):
    return {k: after[k] - before[k] for k in keys}


def _equal_models(a, b):
    assert a.ntrees_built == b.ntrees_built
    for fa, fb in zip(a.forest, b.forest):
        for f in fa._fields:
            assert torch.equal(getattr(fa, f), getattr(fb, f)), f
    assert a.varimp_table == b.varimp_table


def test_second_candidate_hits_matrix_bins_and_device():
    fr = _frame()
    _gbm(fr)
    s0 = dsc.snapshot()
    assert (s0["matrix_misses"], s0["bins_misses"], s0["device_misses"]) \
        == (1, 1, 1)
    _gbm(fr, learn_rate=0.3, max_depth=4)
    d = _delta(s0, dsc.snapshot(), "matrix_hits", "bins_hits", "device_hits",
               "matrix_misses", "bins_misses", "device_misses")
    assert d == dict(matrix_hits=1, bins_hits=1, device_hits=1,
                     matrix_misses=0, bins_misses=0, device_misses=0)
    assert dsc.snapshot()["entries"] == 1 and dsc.snapshot()["bytes"] > 0


def test_keys_keep_artifacts_apart():
    fr = _frame()
    _gbm(fr)
    s0 = dsc.snapshot()
    _gbm(fr, nbins=40)                               # another bins key
    _gbm(fr, histogram_type="Random", seed=1)        # Random: keyed by seed
    _gbm(fr, histogram_type="Random", seed=2)
    _gbm(fr, histogram_type="UniformAdaptive", seed=9)   # the first key
    d = _delta(s0, dsc.snapshot(), "bins_hits", "bins_misses",
               "matrix_hits")
    assert d == dict(bins_hits=1, bins_misses=3, matrix_hits=4)
    e = H2OGradientBoostingEstimator(ntrees=2, max_depth=2, seed=42,
                                     device="cpu")
    e.train(x=NAMES[:4], y="label", training_frame=fr)   # another x list
    assert dsc.snapshot()["entries"] == 2


def test_in_place_assignment_invalidates():
    fr = _frame()
    first = _gbm(fr)
    fr["f0"] = np.asarray(fr.vec("f1").data)     # an in-place column change
    assert fr._version == 1
    s0 = dsc.snapshot()
    again = _gbm(fr)
    assert _delta(s0, dsc.snapshot(), "matrix_misses")["matrix_misses"] == 1
    fresh = fr.take(np.arange(N))                # a new frame, same values
    _equal_models(again, _gbm(fresh))
    assert not torch.equal(first.forest[0].value, again.forest[0].value)


def test_caps_evict_lru_first(monkeypatch):
    monkeypatch.setenv("H2O3_DATASET_CACHE_ENTRIES", "2")
    frames = [_frame(seed=s) for s in range(3)]
    for fr in frames:
        _gbm(fr, ntrees=1)
    snap = dsc.snapshot()
    assert snap["entries"] == 2 and snap["evictions"] == 1
    keys = [e.frame_ref() for e in dsc._ENTRIES.values()]
    assert keys == frames[1:]                    # the oldest went first
    monkeypatch.setenv("H2O3_DATASET_CACHE_MB", "0.000001")
    _gbm(frames[0], ntrees=1)
    assert dsc.snapshot()["entries"] == 1


def test_disabled_cache_keeps_nothing(monkeypatch):
    monkeypatch.setenv("H2O3_DATASET_CACHE", "0")
    fr = _frame()
    _gbm(fr)
    _gbm(fr)
    snap = dsc.snapshot()
    assert snap["entries"] == 0 and not snap["enabled"]
    assert snap["matrix_hits"] + snap["matrix_misses"] == 0


@pytest.mark.parametrize("algo", ["gbm", "drf"])
def test_cache_on_fit_equals_cache_off_fit(monkeypatch, algo):
    cls = (H2OGradientBoostingEstimator if algo == "gbm"
           else H2ORandomForestEstimator)
    params = dict(ntrees=4, max_depth=4, seed=42, device="cpu")
    fr = _frame()

    def fit():
        e = cls(**params)
        e.train(y="label", training_frame=fr)
        return e.model

    fit()
    cached = fit()                                # served from the cache
    assert dsc.snapshot()["device_hits"] == 1
    monkeypatch.setenv("H2O3_DATASET_CACHE", "0")
    plain = fit()
    _equal_models(cached, plain)
    np.testing.assert_array_equal(
        np.asarray(cached.predict(fr).vec("1").data),
        np.asarray(plain.predict(fr).vec("1").data))


def test_kmeans_and_pca_share_one_std_artifact():
    fr = Frame.from_numpy(_data()[:, :F], names=NAMES[:F])
    glm_t = {}
    est.design_matrix(fr, NAMES[:F], standardize=True, add_intercept=True,
                      device="cpu", timings=glm_t)
    H2OKMeansEstimator(k=3, seed=1, device="cpu").train(training_frame=fr)
    s0 = dsc.snapshot()
    pca = H2OPrincipalComponentAnalysisEstimator(k=2, transform="STANDARDIZE",
                                                 device="cpu")
    pca.train(training_frame=fr)
    d = _delta(s0, dsc.snapshot(), "std_hits", "std_misses")
    # the host matrix under PCA's device matrix, and the device matrix:
    # both K-Means's (`device_matrix` resolves the host matrix once and
    # hands it back with the upload)
    assert d == dict(std_hits=2, std_misses=0)
    assert dsc.snapshot()["entries"] == 1
    (e,) = dsc._ENTRIES.values()
    assert sorted(k[0] for k in e.std) == ["design", "dev", "host"]
    # a design served from the cache books no design time
    again = {}
    est.design_matrix(fr, NAMES[:F], standardize=True, add_intercept=True,
                      device="cpu", timings=again)
    assert set(again) == set(glm_t) and not any(again.values())
    g = H2OGeneralizedLinearEstimator(family="gaussian", lambda_=0.0,
                                      device="cpu")
    g.train(y=NAMES[0], x=NAMES[1:F],
            training_frame=fr)                     # its own x: own entry
    assert dsc.snapshot()["entries"] == 2


def test_dead_frame_drops_its_owners_without_a_leak():
    fr = _frame()
    _gbm(fr)
    (e,) = dsc._ENTRIES.values()
    base = e.owner_base
    assert len(ml.owners(base)) == 5
    del fr, e
    gc.collect()
    assert dsc.snapshot()["entries"] == 0
    assert ml.owners(base) == []
    snap = ml.refresh(force=True)
    assert not any(lk["owner"].startswith(base) for lk in snap["leaks"])


@pytest.mark.parametrize("rebin", ["0", "1"])
def test_cv_fold_counters_count(monkeypatch, rebin):
    monkeypatch.setenv("H2O3_CV_REBIN", rebin)
    trainpool.reset()
    _gbm(_frame(), ntrees=2, nfolds=3)
    cv = trainpool.snapshot()["cv"]
    assert cv == (dict(reuse_folds=3, rebin_folds=0) if rebin == "0"
                  else dict(reuse_folds=0, rebin_folds=3))


def test_cache_layers_equal_the_references():
    """The bins and the packed device codes each package's GBM leaves in
    its cache are byte-identical."""
    pfr = _frame()
    _gbm(pfr)
    (pe,) = dsc._ENTRIES.values()
    ref_cache.clear()
    mesh.init(jax.devices()[:1])
    try:
        rfr = _frame(RefFrame)
        RefGBM(ntrees=3, max_depth=3, seed=42).train(y="label",
                                                     training_frame=rfr)
        (re,) = [e for e in ref_cache._ENTRIES.values()
                 if e.frame_ref() is rfr]
        (rbm,), (pbm,) = re.bins.values(), pe.bins.values()
        np.testing.assert_array_equal(pbm.codes, rbm.codes)
        for a, b in zip(pbm.edges, rbm.edges):
            np.testing.assert_array_equal(a, b)
        (rdev,), (pdev,) = re.device.values(), pe.device.values()
        np.testing.assert_array_equal(pdev.numpy(), np.asarray(rdev))
    finally:
        mesh.reset()
        ref_cache.clear()
