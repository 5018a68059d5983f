"""The uplift DRF of the port against the reference's, on the CPU.

The same numpy-seeded frames (the reference's own uplift fixture, with a
categorical column added) go through the JAX package on a one-device cloud
and through the port with `device="cpu"`, where every histogram pass is
`segment` (B1's plain version):

- the bin codes byte for byte; for KL, Euclidean and ChiSquared, with the
  default `mtries` column sample (and for KL at 300 bins, whose uint16
  codes go to the device as int16), the forest equal node for node (features,
  bins, thresholds and split flags), the leaf values within LEAF_TOL =
  1e-6, predictions within PRED_TOL = 1e-5, and the training and
  validation AUUC, qini and ATE within METRIC_TOL = 1e-6 relative. The
  fixture holds no near-tied gains (the gains are f32 logs, which may
  round an ulp apart between XLA and torch);
- `auuc` of both kinds against the reference's on random rankings;
- 3-fold CV: the fold forests, the holdout predictions within PRED_TOL
  and the cross-validation metrics within METRIC_TOL;
- both `ValueError`s, the port's `ValueError` past 1022 bins (ROADMAP
  queue B, item 1) and the `NotImplementedError`s for the parameters the
  reference never reads;
- the MOJO member for member and loading across both ways,
  `convert.uplift_from_numpy`, and a served batch equal to `predict` with
  no fallback.
"""

import numpy as np
import pytest

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import uplift as refup
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import H2OUpliftRandomForestEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import uplift as up
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

LEAF_TOL = 1e-6
PRED_TOL = 1e-5
METRIC_TOL = 1e-6
X_COLS = ["x0", "x1", "x2", "g"]


def _uplift_frames(n=2000, seed=3):
    """The reference's fixture (tests/test_unsupervised.py): uplift 0.4
    where x0 > 0 for treated rows, a base rate lifted where x1 > 0.5, and a
    4-level categorical `g` of noise. Returns both packages' frames, y,
    the treatment and X."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    treat = rng.integers(0, 2, n)
    base = (X[:, 1] > 0.5).astype(float) * 0.2
    lift = np.where(X[:, 0] > 0, 0.4, 0.0) * treat
    y = (rng.uniform(size=n) < base + lift + 0.1).astype(int)
    g = rng.integers(0, 4, n)
    cols = {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
            "g": np.asarray(list("abcd"), dtype=object)[g],
            "treatment": np.asarray(["control", "treatment"],
                                    dtype=object)[treat],
            "y": np.asarray(["0", "1"], dtype=object)[y]}
    types = {"g": "enum", "treatment": "enum", "y": "enum"}
    return (RefFrame.from_dict(cols, column_types=types),
            Frame.from_dict(cols, column_types=types), y, treat, X)


def _fit_both(rf, pf, valid=(None, None), **params):
    params = dict(dict(treatment_column="treatment", ntrees=10, max_depth=5,
                       seed=11), **params)
    ref = refup.H2OUpliftRandomForestEstimator(**params)
    ref.train(x=X_COLS, y="y", training_frame=rf, validation_frame=valid[0])
    port = H2OUpliftRandomForestEstimator(device="cpu", **params)
    port.train(x=X_COLS, y="y", training_frame=pf, validation_frame=valid[1])
    return ref.model, port.model


def _check_forest(rf_, pf_, where):
    for f in ("feat", "bin", "thr", "is_split"):
        a, b = np.asarray(getattr(rf_, f)), getattr(pf_, f).cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, f)
    assert np.abs(np.asarray(rf_.value)
                  - pf_.value.cpu().numpy()).max() <= LEAF_TOL, where


def _check_metrics(rm_, pm_, where):
    for name in ("auuc", "qini", "auuc_normalized", "ate"):
        r, p = getattr(rm_, name), getattr(pm_, name)
        assert abs(r - p) <= METRIC_TOL * max(1.0, abs(r)), (where, name, r, p)
    assert rm_.nobs == pm_.nobs


def _uplift(model, frame):
    return model.predict(frame).vec("uplift_predict").numeric_np()


@pytest.mark.parametrize("metric,nbins", [
    ("KL", 20), ("Euclidean", 20), ("ChiSquared", 20), ("KL", 300)],
    ids=["KL", "Euclidean", "ChiSquared", "KL-300bins"])
def test_forest_matches_the_reference(cloud1, metric, nbins):
    """At the default 20 bins B is 32 and the codes uint8; at 300 bins B
    is 512 and the codes uint16, which the port sends to the device as
    int16."""
    rf, pf, y, treat, X = _uplift_frames()
    rv, pv, _, _, _ = _uplift_frames(600, seed=8)
    rm, pm = _fit_both(rf, pf, valid=(rv, pv), uplift_metric=metric,
                       nbins=nbins)
    assert pm.bm.codes.dtype == rm.bm.codes.dtype
    assert pm.bm.codes.dtype == (np.uint8 if nbins == 20 else np.uint16)
    assert pm.bm.codes.tobytes() == rm.bm.codes.tobytes()
    assert pm.bm.nbins == rm.bm.nbins == (32 if nbins == 20 else 512)
    assert pm.ntrees_built == rm.ntrees_built == 10
    _check_forest(rm.forest, pm.forest, metric)
    for r_fr, p_fr in ((rf, pf), (rv, pv)):
        assert np.abs(_uplift(pm, p_fr) - _uplift(rm, r_fr)).max() <= PRED_TOL
    _check_metrics(rm.training_metrics, pm.training_metrics, metric)
    _check_metrics(rm.validation_metrics, pm.validation_metrics, metric)
    # the reference's own bars (tests/test_longtail3.py)
    u = _uplift(pm, pf)
    assert u[X[:, 0] > 0].mean() > u[X[:, 0] <= 0].mean() + 0.1
    rand, _ = up.auuc(y.astype(float), treat.astype(float),
                      np.random.default_rng(3).uniform(size=len(y)))
    assert pm.training_metrics.auuc > rand


def test_auuc_matches_the_reference():
    rng = np.random.default_rng(12)
    for n, nbins in ((5000, 1000), (300, 1000), (2000, 50)):
        y = (rng.random(n) < 0.3).astype(float)
        t = (rng.random(n) < 0.6).astype(float)
        u = rng.normal(size=n)
        u[::7] = u[1]                              # ties in the ranking
        for kind in ("qini", "gain"):
            a, (ka, va) = refup.auuc(y, t, u, nbins=nbins, kind=kind)
            b, (kb, vb) = up.auuc(y, t, u, nbins=nbins, kind=kind)
            assert abs(a - b) <= METRIC_TOL * max(1.0, abs(a)), (n, kind)
            assert np.array_equal(ka, kb)
            assert np.abs(va - vb).max() <= METRIC_TOL * max(1.0,
                                                             np.abs(va).max())


def test_cross_validation_matches_the_reference(cloud1):
    rf, pf, _, _, _ = _uplift_frames(1500, seed=5)
    rm, pm = _fit_both(rf, pf, nfolds=3, ntrees=6, max_depth=4)
    assert len(pm.cross_validation_models) == len(rm.cross_validation_models)
    for a, b in zip(rm.cross_validation_models, pm.cross_validation_models):
        _check_forest(a.forest, b.forest, "fold")
    assert np.abs(pm._cv_holdout_pred - rm._cv_holdout_pred).max() <= PRED_TOL
    r, p = rm.cross_validation_metrics, pm.cross_validation_metrics
    assert type(p).__name__ == type(r).__name__ == "ModelMetricsBinomial"
    for name in ("auc", "logloss", "mse"):
        assert abs(getattr(r, name) - getattr(p, name)) <= METRIC_TOL * max(
            1.0, abs(getattr(r, name))), name
    for a, b in zip(rm.cross_validation_models, pm.cross_validation_models):
        _check_metrics(a.validation_metrics, b.validation_metrics, "fold")


def test_errors_and_unread_parameters(cloud1):
    rf, pf, _, _, _ = _uplift_frames(300)
    for bad, msg in ((dict(), "requires treatment_column"),
                     (dict(treatment_column="treatment", _y="x0"),
                      "binary categorical response")):
        y = bad.pop("_y", "y")
        with pytest.raises(ValueError, match=msg):
            refup.H2OUpliftRandomForestEstimator(**bad).train(
                x=X_COLS, y=y, training_frame=rf)
        with pytest.raises(ValueError, match=msg):
            H2OUpliftRandomForestEstimator(device="cpu", **bad).train(
                x=X_COLS, y=y, training_frame=pf)
    # B pads past the histogram kernels' 1024 bins (the reference fits it)
    with pytest.raises(ValueError, match="ROADMAP queue B, item 1"):
        H2OUpliftRandomForestEstimator(
            treatment_column="treatment", nbins=1023, device="cpu").train(
            x=X_COLS, y="y", training_frame=pf)
    for bad in (dict(auuc_type="Gain"), dict(auuc_nbins=100),
                dict(col_sample_rate_per_tree=0.5)):
        name = next(iter(bad))
        with pytest.raises(NotImplementedError, match=f"{name}.*item 10"):
            H2OUpliftRandomForestEstimator(
                treatment_column="treatment", device="cpu", **bad).train(
                x=X_COLS, y="y", training_frame=pf)


def test_mojo_convert_and_serving(cloud1, tmp_path):
    rf, pf, _, _, _ = _uplift_frames(1200, seed=9)
    rm, pm = _fit_both(rf, pf, ntrees=8)
    rt, pt, _, _, _ = _uplift_frames(400, seed=10)
    pp = mojo.save_model(pm, str(tmp_path), "port_uplift.h2o3")
    rp = refmojo.save_model(rm, str(tmp_path), "ref_uplift.h2o3")
    pn, pmeta, parr = _members(pp)
    rn, rmeta, rarr = _members(rp)
    assert pn == rn and sorted(parr) == sorted(rarr)
    assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
        k: v for k, v in rmeta.items() if k != "model_id"}
    for name in rarr:
        assert parr[name].dtype == rarr[name].dtype, name
        assert parr[name].tobytes() == rarr[name].tobytes(), name
    want = refmojo.load_model(rp).predict(rt).vec(
        "uplift_predict").numeric_np()
    for scored in (mojo.load_model(pp).predict(pt),
                   mojo.load_model(rp).predict(pt),
                   refmojo.load_model(pp).predict(rt)):
        assert np.array_equal(scored.vec("uplift_predict").numeric_np(), want)
    assert np.abs(_uplift(pm, pt) - want).max() <= PRED_TOL
    again = mojo.save_model(mojo.load_model(pp), str(tmp_path), "again.h2o3")
    assert _members(again)[1] == pmeta

    bm = rm.bm
    carried = convert.uplift_from_numpy(
        **{f: np.asarray(getattr(rm.forest, f))
           for f in ("feat", "bin", "thr", "is_split", "value")},
        edges=bm.edges, max_depth=rm.max_depth, x=rm.x, y=rm.y,
        nbins=bm.nbins, treatment_column=rm.treatment_col, domain=rm.domain,
        feature_domains=bm.domains, device="cpu")
    assert np.abs(_uplift(carried, pt) - _uplift(rm, rt)).max() <= PRED_TOL
    _check_metrics(rm._make_metrics(rt), carried._make_metrics(pt), "carried")

    eng = ScoringEngine(ServingConfig())
    try:
        sub = pt.take(np.arange(17, 333))
        served = eng.score("uplift", pm, sub).vec("uplift_predict").numeric_np()
        assert np.array_equal(served, _uplift(pm, sub))
        assert eng.snapshot()["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()
