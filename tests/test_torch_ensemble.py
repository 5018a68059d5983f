"""StackedEnsemble of the port against the reference's, on the CPU.

Base models with 3-fold CV (Modulo folds, binary labels or a target on a
grid of quarters, so the fold forests are the reference's) are fit by both
packages: a GBM, a DRF and a binomial GLM; a GBM and a gaussian GLM for
regression (on other columns, so that the level-one columns are not
collinear). Each package stacks its own with the default metalearner (a
GLM with λ = 0 and non-negative weights), once on the holdout predictions
and once on a blending frame. The metalearner's β must lie within 1e-4 of
the reference's and be ≥ 0, the ensemble's predictions within 1e-5, its
training metrics the metalearner's and its validation metrics the
reference's. The port raises where it does not follow the reference: a
multinomial metalearner given a parameter its fit would ignore (the GLM
names item 8; the multiclass stack itself is held in
`tests/test_torch_glm_multinomial.py`), a `deeplearning` metalearner
given a parameter the reference's DeepLearning ignores (item 10; the
metalearner itself stacks as the reference's), and `metalearner_nfolds` /
`metalearner_transform`, which the reference accepts and ignores.
"""

import numpy as np
import pytest

import jax

import h2o3_tpu.estimators as ref_est
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.parallel import mesh
import h2o3_tpu_torch.estimators as port_est
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.glm import H2OGeneralizedLinearEstimator

from test_torch_cv import X_NAMES, cv_data

TOL = 1e-5
CV = dict(nfolds=3, fold_assignment="Modulo", seed=7,
          keep_cross_validation_predictions=True)


def frames(kind, seed, n):
    X, y, yreg, _ = cv_data(n=n, seed=seed)
    d = np.column_stack([X, y if kind == "binomial" else yreg])
    names = X_NAMES + ["y"]
    rf, pf = RefFrame.from_numpy(d, names=names), Frame.from_numpy(d, names=names)
    if kind == "binomial":
        rf, pf = rf.asfactor("y"), pf.asfactor("y")
    return rf, pf


def base_estimators(mod, kind, **dev):
    """(estimator, x) of each base model, from `mod` (either package's
    estimators module). The regression GBM sees c1..c4 and the GLM every
    column, so their holdout columns are nearly uncorrelated: on two
    columns correlated at 0.98 (both models on every column), the
    metalearner's 500 f32 ISTA steps stop ≈1e-2 from the optimum, and
    there the two packages' β part by up to 7e-5 (ROADMAP §C)."""
    gbm = mod.H2OGradientBoostingEstimator(ntrees=4, max_depth=3, **CV, **dev)
    if kind == "binomial":
        return [(gbm, None),
                (mod.H2ORandomForestEstimator(ntrees=4, max_depth=3, **CV,
                                              **dev), None),
                (mod.H2OGeneralizedLinearEstimator(family="binomial",
                                                   lambda_=0.0, **CV, **dev),
                 None)]
    return [(gbm, X_NAMES[1:]),
            (mod.H2OGeneralizedLinearEstimator(family="gaussian", lambda_=0.0,
                                               **CV, **dev), None)]


@pytest.fixture(scope="module")
def fits():
    """Per response kind: both packages' base models and their ensembles,
    without and with a blending frame, the first with a validation
    frame."""
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for kind in ("binomial", "regression"):
            rf, pf = frames(kind, 0, 600)
            rb, pb = frames(kind, 1, 300)
            rt, pt = frames(kind, 2, 250)
            fx = dict(ref_test=rt, port_test=pt, port_train=pf)
            for pkg, mod, fr, blend, test, dev in (
                    ("ref", ref_est, rf, rb, rt, {}),
                    ("port", port_est, pf, pb, pt, dict(device="cpu"))):
                bases = []
                for b, x in base_estimators(mod, kind, **dev):
                    b.train(x=x, y="y", training_frame=fr)
                    bases.append(b)
                se = mod.H2OStackedEnsembleEstimator(base_models=bases, **dev)
                se.train(y="y", training_frame=fr, validation_frame=test)
                seb = mod.H2OStackedEnsembleEstimator(
                    base_models=bases, blending_frame=blend, **dev)
                seb.train(y="y", training_frame=fr)
                fx[pkg] = dict(bases=bases, holdout=se, blend=seb)
            out[kind] = fx
    finally:
        mesh.reset()
    return out


VARIANTS = [(k, v) for k in ("binomial", "regression")
            for v in ("holdout", "blend")]
IDS = [f"{k}-{v}" for k, v in VARIANTS]


def _pred(frame, kind):
    return np.asarray(frame.vec("1" if kind == "binomial" else "predict").data,
                      np.float64)


@pytest.mark.parametrize("kind,variant", VARIANTS, ids=IDS)
def test_metalearner_beta_matches_and_is_non_negative(fits, kind, variant):
    ref = fits[kind]["ref"][variant].model.meta.model
    port = fits[kind]["port"][variant].model.meta.model
    assert isinstance(fits[kind]["port"][variant].model.meta,
                      H2OGeneralizedLinearEstimator)
    assert port.x == ref.x == [f"m{i}" for i in range(len(ref.x))]
    np.testing.assert_allclose(np.asarray(port.beta), np.asarray(ref.beta),
                               rtol=0, atol=1e-4)
    assert (np.asarray(port.beta)[:-1] >= 0).all()       # the intercept is last


@pytest.mark.parametrize("kind,variant", VARIANTS, ids=IDS)
def test_predictions_match(fits, kind, variant):
    fx = fits[kind]
    got = fx["port"][variant].predict(fx["port_test"])
    want = fx["ref"][variant].predict(fx["ref_test"])
    assert got.names == want.names
    np.testing.assert_allclose(_pred(got, kind), _pred(want, kind), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("kind,variant", VARIANTS, ids=IDS)
def test_training_metrics_are_the_metalearners(fits, kind, variant):
    se = fits[kind]["port"][variant].model
    assert se.training_metrics is se.meta.model.training_metrics
    ref = fits[kind]["ref"][variant].model
    assert abs(se.rmse() - ref.rmse()) <= TOL


@pytest.mark.parametrize("kind", ["binomial", "regression"])
def test_validation_metrics_match(fits, kind):
    port = fits[kind]["port"]["holdout"].model
    ref = fits[kind]["ref"]["holdout"].model
    names = ("auc", "logloss", "rmse") if kind == "binomial" else ("rmse", "mse")
    for name in names:
        assert abs(getattr(port, name)(valid=True)
                   - getattr(ref, name)(valid=True)) <= TOL, name


@pytest.mark.parametrize("kind", ["binomial", "regression"])
def test_level_one_frame_matches(fits, kind):
    fx = fits[kind]
    got = fx["port"]["holdout"].model._level_one(fx["port_test"])
    want = fx["ref"]["holdout"].model._level_one(fx["ref_test"])
    assert got.names == want.names
    for n in got.names:
        np.testing.assert_allclose(got.vec(n).numeric_np(),
                                   want.vec(n).numeric_np(), rtol=0, atol=TOL)


def test_base_model_without_cv_raises(cloud1):
    rf, pf = frames("binomial", 0, 600)
    plain = {}
    for pkg, mod, fr, dev in (("ref", ref_est, rf, {}),
                              ("port", port_est, pf, dict(device="cpu"))):
        gbm = mod.H2OGradientBoostingEstimator(ntrees=2, max_depth=2, **dev)
        gbm.train(y="y", training_frame=fr)
        se = mod.H2OStackedEnsembleEstimator(base_models=[gbm], **dev)
        with pytest.raises(ValueError, match="lacks CV holdout predictions") as e:
            se.train(y="y", training_frame=fr)
        plain[pkg] = str(e.value)
    assert plain["port"].split(" lacks")[1] == plain["ref"].split(" lacks")[1]


def test_metalearner_gbm_and_drf(fits):
    """`gbm` and `drf` stack with the port's tree estimators, fit on the
    level-one frame of the holdout predictions."""
    fx = fits["binomial"]
    bases, pf = fx["port"]["bases"], fx["port_train"]
    for algo, cls in (("gbm", port_est.H2OGradientBoostingEstimator),
                      ("drf", port_est.H2ORandomForestEstimator)):
        params = dict(ntrees=3, max_depth=2, seed=3)
        se = port_est.H2OStackedEnsembleEstimator(
            base_models=bases, metalearner_algorithm=algo,
            metalearner_params=params, device="cpu")
        se.train(y="y", training_frame=pf)
        meta = se.model.meta
        assert isinstance(meta, cls)
        lvl1 = Frame.from_dict({f"m{i}": b.model._cv_holdout_pred
                                for i, b in enumerate(bases)})
        lvl1 = Frame({**lvl1._vecs, "__y__": pf.vec("y")})
        direct = cls(device="cpu", **params)
        direct.train(y="__y__", training_frame=lvl1)
        np.testing.assert_array_equal(meta.model.forest[0].feat.numpy(),
                                      direct.model.forest[0].feat.numpy())
        p = _pred(se.predict(fx["port_test"]), "binomial")
        assert np.all((p >= 0) & (p <= 1))


def test_multinomial_ensemble_raises_item_8():
    X, _, _, _ = cv_data(n=300, seed=4)
    y = np.argmax(X[:, :3], axis=1).astype(np.float64)
    fr = Frame.from_numpy(np.column_stack([X, y]),
                          names=X_NAMES + ["y"]).asfactor("y")
    gbm = port_est.H2OGradientBoostingEstimator(
        ntrees=2, max_depth=2, nfolds=2, seed=7, device="cpu")
    gbm.train(y="y", training_frame=fr)
    assert gbm.model._cv_holdout_pred.shape == (300, 3)
    se = port_est.H2OStackedEnsembleEstimator(
        base_models=[gbm], metalearner_params=dict(lambda_search=True),
        device="cpu")
    with pytest.raises(NotImplementedError,
                       match="queue A, item 8: multinomial GLM"):
        se.train(y="y", training_frame=fr)


def test_deeplearning_metalearner_raises_item_10(fits, cloud1):
    """The `deeplearning` metalearner stacks as the reference's (the same
    level-one frame, the same seeded network: predictions within 1e-5);
    given a parameter the reference's DeepLearning ignores, it raises
    naming item 10."""
    fx = fits["binomial"]
    params = dict(hidden=[8], epochs=5, seed=3, mini_batch_size=64)
    train = dict(ref=frames("binomial", 0, 600)[0], port=fx["port_train"])
    preds = {}
    for pkg, mod, dev in (("ref", ref_est, {}),
                          ("port", port_est, dict(device="cpu"))):
        se = mod.H2OStackedEnsembleEstimator(
            base_models=fx[pkg]["bases"], metalearner_algorithm="deeplearning",
            metalearner_params=dict(params), **dev)
        se.train(y="y", training_frame=train[pkg])
        assert type(se.model.meta).__name__ == "H2ODeepLearningEstimator"
        preds[pkg] = _pred(se.predict(fx[f"{pkg}_test"]), "binomial")
    np.testing.assert_allclose(preds["port"], preds["ref"], rtol=0, atol=TOL)
    se = port_est.H2OStackedEnsembleEstimator(
        base_models=fx["port"]["bases"], metalearner_algorithm="deeplearning",
        metalearner_params=dict(params, reproducible=True), device="cpu")
    with pytest.raises(NotImplementedError, match="queue A, item 10"):
        se.train(y="y", training_frame=fx["port_train"])


@pytest.mark.parametrize("kw", [dict(metalearner_nfolds=3),
                                dict(metalearner_transform="Logit")],
                         ids=["metalearner_nfolds", "metalearner_transform"])
def test_parameters_the_reference_ignores_raise(fits, kw):
    fx = fits["binomial"]
    se = port_est.H2OStackedEnsembleEstimator(
        base_models=fx["port"]["bases"], device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=next(iter(kw))):
        se.train(y="y", training_frame=fx["port_train"])
