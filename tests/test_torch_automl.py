"""AutoML of the port against the reference's, on the CPU.

The same numpy-seeded frames go through the JAX package on a one-device
cloud and through the port with `device="cpu"`:

- the reference's own binomial configuration (`tests/test_automl.py`:
  500 × 4, `max_models=4`, `nfolds=2`, DeepLearning excluded): the same
  candidates in the same building order, each leaderboard row's
  cross-validation metrics within its tolerance of the reference's, and
  the same leaderboard order wherever two rows' sort metrics lie farther
  apart than their tolerances; `leaderboard.as_frame()`,
  `get_best_model(algorithm=…)`, and the predictions of every row held at
  LB_TOL within PRED_TOL = 1e-5 (measured ≤ 2.9e-6);
- a regression run (GBM and GLM with both ensembles), held the same way.

The tolerances: LB_TOL = 1e-6 for a row of GLM or of trees whose fits
match the reference's (measured ≤ 5e-8: GLM_1's λ path, the regression
GBM_1 and both regression stacks). XGB_TOL = 1e-2 for the binomial run's
XGBoost rows and the stacks built on them (measured 4.6e-3 in logloss,
8.5e-3 in mean per-class error, 1.6e-3 in AUC): on 250-row folds at 256
QuantilesGlobal bins and `min_rows` 1, the logistic gradients are not
dyadic, and the two packages' trees part at a near-tied gain from the
second tree on (XGBoost_3's depth-3 trees agree through tree 39), as the
ROADMAP watch list records for non-dyadic gradients (single rows'
probabilities then part by up to 0.17, so those rows' predictions are
not compared);
- a multinomial GLM_1: the reference's step asks for `lambda_search`,
  which its multinomial fit never reads; the port's GLM_1 asks for the
  model the reference fits (α 0.5, λ = 0), its metrics and probabilities
  within MN_TOL = 1e-4 (the multinomial GLM's own tolerance,
  `tests/test_torch_glm_multinomial.py`; measured 1.4e-6 in logloss),
  and the port's GLM still raises for the request itself;
- XRT (a DRF on `histogram_type="Random"` bins, AutoML's XRT_1): the
  forest node for node on binary labels — the reference draws the random
  split points once, in the binning, and nothing per tree or level;
- `max_runtime_secs` with a patched clock (each call one second later):
  a GBM stops at the same chunk end as the reference's and grows the same
  trees, and a DeepLearning fit takes the reference's per-batch path,
  stops after the same step and predicts as the reference does.
"""

import time

import numpy as np
import pytest

import jax

from h2o3_tpu.automl import H2OAutoML as RefAutoML
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import deeplearning as refdl_mod
from h2o3_tpu.models import shared_tree as refst
from h2o3_tpu.models.deeplearning import H2ODeepLearningEstimator as RefDL
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.estimators import (H2OAutoML, H2ODeepLearningEstimator,
                                       H2OGeneralizedLinearEstimator,
                                       H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import deeplearning as dl_mod
from h2o3_tpu_torch.models import shared_tree as st

from conftest import make_classification, make_regression
from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_gbm import make_higgs_like

LB_TOL = 1e-6
XGB_TOL = 1e-2
PRED_TOL = 1e-5
MN_TOL = 1e-4
METRICS = ("auc", "logloss", "mean_per_class_error", "rmse", "mse")

# run -> (data, response kind, AutoML arguments)
RUNS = {
    "binomial": ("binomial", dict(max_models=4, max_runtime_secs=600,
                                  seed=11, nfolds=2,
                                  exclude_algos=["DeepLearning"])),
    "regression": ("regression", dict(max_models=2, seed=3, nfolds=2,
                                      include_algos=["GBM", "GLM",
                                                     "StackedEnsemble"])),
    "multinomial": ("multinomial", dict(max_models=1, seed=5, nfolds=2,
                                        include_algos=["GLM"])),
}


def _data(kind):
    if kind == "binomial":
        X, y = make_classification(500, 4, 10)
    elif kind == "regression":
        X, y = make_regression(500, 4, 2)
    else:
        rng = np.random.default_rng(4)
        X = rng.normal(size=(600, 4))
        logits = X @ rng.normal(size=(4, 3)) + rng.normal(size=(600, 3))
        y = logits.argmax(axis=1).astype(float)
    names = [f"x{i}" for i in range(X.shape[1])] + ["y"]
    d = np.column_stack([X, y])
    rf, pf = RefFrame.from_numpy(d, names=names), Frame.from_numpy(d, names=names)
    if kind != "regression":
        rf, pf = rf.asfactor("y"), pf.asfactor("y")
    return rf, pf


@pytest.fixture(scope="module")
def runs():
    """AutoML runs made once by the first test that asks, on its one-device
    cloud (`cloud1`)."""
    return {}


def _run(runs, name):
    if name not in runs:
        kind, kw = RUNS[name]
        rf, pf = _data(kind)
        ref = RefAutoML(**kw)
        ref.train(y="y", training_frame=rf)
        port = H2OAutoML(device="cpu", **kw)
        port.train(y="y", training_frame=pf)
        runs[name] = (ref, port, rf, pf)
    return runs[name]


def _names(aml):
    return [getattr(r["_est"], "_automl_name", None)
            for r in aml.leaderboard.rows]


def _built(aml):
    return [e["message"].split()[1] for e in aml.event_log.events
            if e["stage"] == "model"]


@pytest.mark.parametrize("name", ["binomial", "regression"])
def test_leaderboard_matches_the_reference(cloud1, runs, name):
    ref, port, rf, pf = _run(runs, name)
    assert _built(port) == _built(ref)
    assert not [e for e in port.event_log.events if e["stage"] == "error"]
    rrows = {n: r for n, r in zip(_names(ref), ref.leaderboard.rows)}
    prows = {n: r for n, r in zip(_names(port), port.leaderboard.rows)}
    assert set(prows) == set(rrows) and len(prows) == len(port.leaderboard)
    tol = {n: XGB_TOL if name == "binomial" and r["algo"] != "glm"
           else LB_TOL for n, r in prows.items()}
    for n in prows:
        assert prows[n]["algo"] == rrows[n]["algo"]
        for k in METRICS:
            a, b = prows[n][k], rrows[n][k]
            assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol[n], (n, k)
    # the order: rows whose sort metrics lie farther apart than their
    # tolerances keep the reference's order
    key = port.leaderboard.sort_metric
    vals = [r[key] for r in port.leaderboard.rows]
    sign = -1 if port.leaderboard.decreasing else 1
    assert all(sign * (b - a) >= 0 for a, b in zip(vals, vals[1:]))
    rank = {n: i for i, n in enumerate(_names(ref))}
    for i, a in enumerate(_names(port)):
        for b in _names(port)[i + 1:]:
            if abs(prows[a][key] - prows[b][key]) > max(tol[a], tol[b]):
                assert rank[a] < rank[b], (a, b)
    lb = port.leaderboard.as_frame()
    assert lb.nrow == len(port.leaderboard)
    assert {"model_id", "algo", key} <= set(lb.names)
    assert port.get_best_model() is port.leaderboard[0]["_est"]
    for algo in ("glm", "stackedensemble"):
        best = port.get_best_model(algorithm=algo)
        assert best is not None and best.algo == algo
    col = "1" if name == "binomial" else "predict"
    assert np.array_equal(np.asarray(port.predict(pf).vec(col).data),
                          np.asarray(port.leader.predict(pf).vec(col).data))
    for n in (n for n in prows if tol[n] == LB_TOL):
        np.testing.assert_allclose(
            np.asarray(prows[n]["_est"].predict(pf).vec(col).data),
            np.asarray(rrows[n]["_est"].predict(rf).vec(col).data),
            rtol=0, atol=PRED_TOL, err_msg=n)


def test_multinomial_glm_1_fits_the_references_model(cloud1, runs):
    ref, port, rf, pf = _run(runs, "multinomial")
    assert _names(port) == _names(ref) == ["GLM_1"]
    p, r = port.leaderboard.rows[0], ref.leaderboard.rows[0]
    assert not p["_est"].lambda_search and p["_est"].lambda_ == 0.0
    assert p["_est"].model.lambda_best == 0.0 == r["_est"].model.lambda_best
    for k in ("logloss", "mean_per_class_error", "rmse"):
        assert abs(p[k] - r[k]) <= MN_TOL, k
    for c in ("0", "1", "2"):
        np.testing.assert_allclose(
            np.asarray(port.predict(pf).vec(c).data),
            np.asarray(ref.predict(rf).vec(c).data), rtol=0, atol=MN_TOL)
    with pytest.raises(NotImplementedError, match="lambda_search"):
        H2OGeneralizedLinearEstimator(lambda_search=True, alpha=0.5,
                                      device="cpu").train(
            y="y", training_frame=pf)
    with pytest.raises(NotImplementedError, match="item 11"):
        port._remote_train(None, "y", pf)


def test_xrt_forest_matches_the_reference(cloud1):
    X, y = make_higgs_like(2000, n_feat=6, seed=3)
    names = [f"f{i}" for i in range(6)] + ["label"]
    d = np.column_stack([X, y])
    rf = RefFrame.from_numpy(d, names=names).asfactor("label")
    pf = Frame.from_numpy(d, names=names).asfactor("label")
    kw = dict(ntrees=5, max_depth=10, seed=42, histogram_type="Random")
    ref = RefDRF(**kw)
    ref.train(y="label", training_frame=rf)
    port = H2ORandomForestEstimator(device="cpu", **kw)
    port.train(y="label", training_frame=pf)
    r, p = ref.model.forest[0], port.model.forest[0]
    for f in ("feat", "bin", "is_split"):
        assert np.array_equal(getattr(p, f).numpy(), np.asarray(getattr(r, f))), f
    assert np.asarray(r.is_split).sum() > 50
    np.testing.assert_array_equal(p.thr.numpy(), np.asarray(r.thr))
    np.testing.assert_allclose(p.value.numpy(), np.asarray(r.value),
                               rtol=1e-5, atol=1e-5)
    # the random edges differ from the uniform ones the DRF bins with
    uni = H2ORandomForestEstimator(device="cpu", **dict(kw, histogram_type="AUTO"))
    uni.train(y="label", training_frame=pf)
    assert not np.array_equal(uni.model.forest[0].thr.numpy(), p.thr.numpy())
    assert abs(port.auc() - ref.auc()) <= 1e-5
    np.testing.assert_allclose(np.asarray(port.predict(pf).vec("1").data),
                               np.asarray(ref.predict(rf).vec("1").data),
                               rtol=1e-5, atol=1e-5)


class _Clock:
    """A stand-in for a module's `time`: each `time()` is one second after
    the last; everything else is the real module's."""

    def __init__(self):
        self.now = 0.0

    def time(self):
        self.now += 1.0
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.mark.parametrize("algo", ["gbm", "deeplearning"])
def test_max_runtime_secs_stops_where_the_reference_stops(cloud1, algo,
                                                          monkeypatch):
    rf, pf = _data("binomial")
    if algo == "gbm":
        # chunks of 25 trees end at 25, 50 and 60: the budget's check at
        # 50 is the first past 1.5 s
        kw = dict(ntrees=60, max_depth=3, seed=1, max_runtime_secs=1.5)
        ref_cls, port_cls, mods = RefGBM, H2OGradientBoostingEstimator, (refst, st)
    else:
        # one check a step: past 5.5 s after the sixth step
        kw = dict(hidden=[8], epochs=2, mini_batch_size=32, seed=1,
                  max_runtime_secs=5.5)
        ref_cls, port_cls, mods = RefDL, H2ODeepLearningEstimator, (refdl_mod, dl_mod)
    for m in mods:
        monkeypatch.setattr(m, "time", _Clock())
    ref = ref_cls(**kw)
    ref.train(y="y", training_frame=rf)
    port = port_cls(device="cpu", **kw)
    port.train(y="y", training_frame=pf)
    if algo == "gbm":
        assert ref.model.ntrees_built == port.model.ntrees_built == 50
        for f in ("feat", "bin", "is_split"):
            assert np.array_equal(getattr(port.model.forest[0], f).numpy(),
                                  np.asarray(getattr(ref.model.forest[0], f)))
    else:
        assert port.model.iterations == 6
        assert port.model.fit_timings["pack_s"] >= 0   # the per-batch path
    np.testing.assert_allclose(np.asarray(port.predict(pf).vec("1").data),
                               np.asarray(ref.predict(rf).vec("1").data),
                               rtol=0, atol=1e-5)
