"""n-fold cross-validation of the port against the reference's, on the CPU.

The same numpy-seeded frames (600 rows, 5 columns, binary labels or a
target on a grid of quarters, so every histogram sum is exact) go through
both packages' `train` with `nfolds` or a `fold_column`:

- the fold assignment of every `fold_assignment` mode and of a fold
  column, read through a spy estimator that records each fold's rows;
- trees on the default fold-reuse path (the folds slice the parent's
  `BinnedMatrix`; a spy on the port's `build_bins` sees one call) and on
  the per-fold re-bin path (`H2O3_CV_REBIN=1`: `nfolds + 1` calls, the
  folds padded to the parent's row count, `_npad_floor`): fold forests
  equal node for node, holdout predictions and xval AUC, logloss and RMSE
  within 1e-5; a DRF and a `sample_rate=0.7` GBM among them;
- GLM CV: holdout within 1e-5, each fold's β within 1e-4;
- `keep_cross_validation_models=False` and the reference's `train` checks.
"""

import numpy as np
import pytest

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import model_base as ref_model_base
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.models.glm import H2OGeneralizedLinearEstimator as RefGLM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.estimators import (H2OGeneralizedLinearEstimator,
                                       H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import model_base, shared_tree

N, F = 600, 5
X_NAMES = [f"c{i}" for i in range(F)]
TOL = 1e-5


def cv_data(n=N, seed=0):
    """(X, binary label, target on a grid of quarters, a fold column of 3
    values, 200 rows each) from a seed."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=n) > 0).astype(np.float32)
    yreg = (np.round(4 * (2 * X[:, 0] + np.sin(3 * X[:, 1]))) / 4).astype(np.float32)
    fold = rng.permutation(np.arange(n) % 3).astype(np.float32)
    return X, y, yreg, fold


def frames(kind, seed=0):
    """(reference frame, port frame) with columns c0..c4, y and fold."""
    X, y, yreg, fold = cv_data(seed=seed)
    d = np.column_stack([X, y if kind == "binomial" else yreg, fold])
    names = X_NAMES + ["y", "fold"]
    rf, pf = RefFrame.from_numpy(d, names=names), Frame.from_numpy(d, names=names)
    if kind == "binomial":
        rf, pf = rf.asfactor("y"), pf.asfactor("y")
    return rf, pf


# case -> (algo, kind, CV path, parameters). The reuse folds are of equal
# size (Modulo, the fold column), so the reference compiles one fold
# program per case; the re-bin folds pad to the parent's row count anyway
CASES = {
    "gbm_reuse": ("gbm", "binomial", "reuse",
                  dict(ntrees=4, max_depth=3, nfolds=3, sample_rate=0.7,
                       fold_assignment="Modulo")),
    "drf_reuse": ("drf", "binomial", "reuse",
                  dict(ntrees=4, max_depth=3, nfolds=3,
                       fold_assignment="Modulo")),
    "gbm_reuse_fold_column": ("gbm", "regression", "reuse",
                              dict(ntrees=4, max_depth=3,
                                   fold_column="fold")),
    "gbm_rebin": ("gbm", "binomial", "rebin",
                  dict(ntrees=4, max_depth=3, nfolds=3, sample_rate=0.7)),
    "drf_rebin": ("drf", "binomial", "rebin",
                  dict(ntrees=4, max_depth=3, nfolds=3)),
}
ESTIMATORS = {"gbm": (RefGBM, H2OGradientBoostingEstimator),
              "drf": (RefDRF, H2ORandomForestEstimator)}


@pytest.fixture(scope="module")
def fits():
    """Each case fit by both packages (the reference on a one-device
    cloud), with the port's `build_bins` calls counted."""
    out = {}
    calls = []
    real = shared_tree.build_bins

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    mesh.init(jax.devices()[:1])
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(shared_tree, "build_bins", counting)
            for case, (algo, kind, path, params) in CASES.items():
                mp.setenv("H2O3_CV_REBIN", "1" if path == "rebin" else "0")
                rf, pf = frames(kind)
                ref_cls, port_cls = ESTIMATORS[algo]
                ref = ref_cls(seed=7, **params)
                ref.train(y="y", training_frame=rf)
                calls.clear()
                port = port_cls(seed=7, device="cpu", **params)
                port.train(y="y", training_frame=pf)
                out[case] = dict(ref=ref.model, port=port.model, kind=kind,
                                 path=path, bins_calls=len(calls))
            mp.setenv("H2O3_CV_REBIN", "0")
            rf, pf = frames("binomial")
            for keep in (True, False):
                glm = H2OGeneralizedLinearEstimator(
                    family="binomial", lambda_=0.0, nfolds=3, seed=7,
                    keep_cross_validation_models=keep, device="cpu")
                glm.train(y="y", training_frame=pf)
                out[f"glm_keep_{keep}"] = glm.model
            ref = RefGLM(family="binomial", lambda_=0.0, nfolds=3, seed=7)
            ref.train(y="y", training_frame=rf)
            out["glm_ref"] = ref.model
    finally:
        mesh.reset()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_fold_forests_equal_node_for_node(fits, case):
    ref, port = fits[case]["ref"], fits[case]["port"]
    assert len(port.cross_validation_models) == len(ref.cross_validation_models) == 3
    for rm, pm in zip(ref.cross_validation_models, port.cross_validation_models):
        assert pm.ntrees_built == rm.ntrees_built == 4
        rt, pt = rm.forest[0], pm.forest[0]
        for f in ("feat", "bin", "is_split"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          np.asarray(getattr(rt, f)), err_msg=f)
        assert int(pt.is_split.sum()) >= 4
        np.testing.assert_allclose(pt.value.numpy(), np.asarray(rt.value),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_holdout_and_xval_metrics_match(fits, case):
    ref, port, kind = fits[case]["ref"], fits[case]["port"], fits[case]["kind"]
    assert port._cv_holdout_pred.dtype == np.float64
    assert port._cv_holdout_pred.shape == ref._cv_holdout_pred.shape == (N,)
    np.testing.assert_allclose(port._cv_holdout_pred, ref._cv_holdout_pred,
                               rtol=0, atol=TOL)
    names = ("auc", "logloss", "rmse") if kind == "binomial" else ("rmse", "mse")
    for name in names:
        assert abs(getattr(port, name)(xval=True)
                   - getattr(ref, name)(xval=True)) <= TOL, name
    assert port.cross_validation_metrics is not port.training_metrics
    for rm, pm in zip(ref.cross_validation_models, port.cross_validation_models):
        for name in names:
            assert abs(getattr(pm.validation_metrics, name)
                       - getattr(rm.validation_metrics, name)) <= TOL, name


@pytest.mark.parametrize("case", list(CASES))
def test_fold_paths_bin_and_pad_as_the_reference(fits, case):
    """The reuse path bins once (the parent) and its folds keep their own
    padded row count; the re-bin path bins the parent and every fold, each
    fold padded to the parent's row count, as the reference pads it."""
    fx = fits[case]
    ref, port = fx["ref"], fx["port"]
    folds = len(port.cross_validation_models)
    assert fx["bins_calls"] == (1 if fx["path"] == "reuse" else folds + 1)
    assert port._npad == ref._npad == N
    for rm, pm in zip(ref.cross_validation_models, port.cross_validation_models):
        assert pm._npad == rm._npad
        assert pm._npad == (N if fx["path"] == "rebin" else -(-pm.bm.codes.shape[0] // 8) * 8)
        if fx["path"] == "reuse":
            assert pm.bm.edges is port.bm.edges


def test_fold_column_is_left_out_of_x(fits):
    port, ref = fits["gbm_reuse_fold_column"]["port"], fits["gbm_reuse_fold_column"]["ref"]
    assert port.x == ref.x == X_NAMES


def test_glm_cv_matches(fits):
    ref, port = fits["glm_ref"], fits["glm_keep_True"]
    np.testing.assert_allclose(port._cv_holdout_pred, ref._cv_holdout_pred,
                               rtol=0, atol=TOL)
    assert len(port.cross_validation_models) == 3
    for rm, pm in zip(ref.cross_validation_models, port.cross_validation_models):
        np.testing.assert_allclose(np.asarray(pm.beta), np.asarray(rm.beta),
                                   rtol=0, atol=1e-4)
        assert abs(pm.validation_metrics.auc - rm.validation_metrics.auc) <= TOL
    for name in ("auc", "logloss", "rmse"):
        assert abs(getattr(port, name)(xval=True)
                   - getattr(ref, name)(xval=True)) <= TOL, name


def test_keep_cross_validation_models_false_gives_none(fits):
    kept, dropped = fits["glm_keep_True"], fits["glm_keep_False"]
    assert dropped.cross_validation_models is None
    np.testing.assert_array_equal(dropped._cv_holdout_pred,
                                  kept._cv_holdout_pred)
    assert dropped.auc(xval=True) == kept.auc(xval=True)


def test_xval_without_cv_reads_training_metrics():
    """`_m(xval=True)` of a model fit without CV falls back to the training
    metrics, as the reference's does."""
    _, pf = frames("binomial")
    est = H2OGradientBoostingEstimator(ntrees=2, max_depth=2, seed=7,
                                       device="cpu")
    est.train(y="y", training_frame=pf)
    assert est.model.cross_validation_metrics is None
    assert est.model._cv_holdout_pred is None
    assert est.auc(xval=True) == est.auc()


# -- fold assignment ---------------------------------------------------------

def _spy_estimator(base, model_cls):
    """An estimator of `base` (either package's H2OEstimator) whose fits
    record the rows they see and whose holdout predictions are zeros."""

    class Spy(base):
        algo = "spy"
        seen = []

        def _fit(self, x, y, train, valid):
            Spy.seen.append(train.vec("rid").numeric_np().astype(np.int64))
            return model_cls(self)

        def _cv_predict(self, model, frame):
            return np.zeros(frame.nrow)

    return Spy


def _assignment(pkg, frame_cls, params, y_values):
    """The fold of every row, as `train` assigned it: row r is in the
    holdout of the one fold whose fit did not see it."""
    base = ref_model_base if pkg == "ref" else model_base
    Spy = _spy_estimator(base.H2OEstimator, base.H2OModel)
    n = len(y_values)
    rng = np.random.default_rng(3)
    d = np.column_stack([np.arange(n), y_values, rng.integers(0, 4, n),
                         rng.normal(size=n)])
    fr = frame_cls.from_numpy(d, names=["rid", "y", "fold", "x0"])
    Spy.seen = []
    Spy(seed=11, keep_cross_validation_models=False, **params).train(
        x=["x0"], y="y", training_frame=fr)
    fold_fits = Spy.seen[1:]                   # the first fit is the parent
    assign = np.full(n, -1)
    for f, rows in enumerate(fold_fits):
        held = np.setdiff1d(np.arange(n), rows)
        assert (assign[held] == -1).all()
        assign[held] = f
    assert (assign >= 0).all()
    return assign, len(fold_fits)


@pytest.mark.parametrize("params", [
    dict(nfolds=3), dict(nfolds=4, fold_assignment="Random"),
    dict(nfolds=3, fold_assignment="Modulo"),
    dict(nfolds=3, fold_assignment="Stratified"), dict(fold_column="fold")],
    ids=["AUTO", "Random", "Modulo", "Stratified", "fold_column"])
def test_fold_assignment_equals_the_reference(params):
    y_values = np.random.default_rng(5).integers(0, 3, 203).astype(np.float64)
    want, k_ref = _assignment("ref", RefFrame, params, y_values)
    got, k_port = _assignment("port", Frame, params, y_values)
    assert k_port == k_ref == (4 if "fold_column" in params else params["nfolds"])
    np.testing.assert_array_equal(got, want)


# -- the train checks ----------------------------------------------------------

@pytest.mark.parametrize("params", [
    dict(nfolds=1), dict(nfolds=-2), dict(nfolds=3, fold_column="fold"),
    dict(fold_column="missing")],
    ids=["nfolds_1", "nfolds_negative", "nfolds_and_fold_column",
         "missing_fold_column"])
def test_train_checks_raise_the_reference_error(params):
    rf, pf = frames("binomial")
    with pytest.raises(ValueError) as ref_err:
        RefGBM(ntrees=1, **params).train(y="y", training_frame=rf)
    with pytest.raises(ValueError) as port_err:
        H2OGradientBoostingEstimator(ntrees=1, device="cpu", **params).train(
            y="y", training_frame=pf)
    assert str(port_err.value) == str(ref_err.value)


def test_cv_parameters_are_common_defaults():
    for cls in (H2OGradientBoostingEstimator, H2ORandomForestEstimator,
                H2OGeneralizedLinearEstimator):
        est = cls()
        for k in ("nfolds", "fold_column", "fold_assignment",
                  "keep_cross_validation_predictions",
                  "keep_cross_validation_models"):
            assert est._parms[k] == RefGBM._common_defaults[k], (cls, k)
