"""NaiveBayes and isotonic regression of the port against the reference's,
on the CPU.

The same numpy-seeded frames go through the JAX package on a one-device
cloud and through the port with `device="cpu"`:

- NaiveBayes on numeric columns (with NaNs, three classes) and on numeric
  and categorical columns (`laplace=1`, binary, a level unseen in
  training at scoring): the priors and the categorical tables bit for
  bit, the per-class means and sds within MOMENT_TOL = 1e-6 relative (the
  port sums the f32 moments in another order than XLA's `segment_sum`;
  the fixtures' values lie on a 1/16 grid where every such sum is exact),
  the probabilities within PROB_TOL = 1e-6, the metrics within
  METRIC_TOL = 1e-6; two fits bit-equal;
- isotonic regression with a weights column, ties and NaNs, under
  `out_of_bounds` "NA" and "clip": `pav`'s knots bit for bit, the model's
  f64 scores bit-equal to `np.interp` (and to the reference's) on rows
  inside, on and outside the knots, and `predict` (whose frame keeps f32)
  equal to the reference's;
- 3-fold CV of both: holdouts and cross-validation metrics;
- the reference's `ValueError`s and the port's `NotImplementedError`s for
  the parameters the reference never reads;
- the MOJO payloads member for member, loading across both ways,
  `convert.naivebayes_from_numpy` and `isotonic_from_numpy`, and a served
  batch of each equal to `predict` with no fallback.
"""

import numpy as np
import pytest

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import isotonic as refiso
from h2o3_tpu.models import naive_bayes as refnb
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import (H2OIsotonicRegressionEstimator,
                                       H2ONaiveBayesEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import isotonic as piso
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

MOMENT_TOL = 1e-6
PROB_TOL = 1e-6
METRIC_TOL = 1e-6


def _frames(cols, types):
    return (RefFrame.from_dict(cols, column_types=types),
            Frame.from_dict(cols, column_types=types))


def _grid(X):
    """Values on a 1/16 grid within ±8: every Σx and Σx² of up to 900 rows
    is an integer multiple of 2^-8 below 2^24 of them, exact in f32 in any
    order, so the moments cannot depend on the order of summation (the
    full-width run on the card measures that gap, ROADMAP §C)."""
    return np.clip(np.round(X * 16) / 16, -8, 8)


def _nb_frames(kind, n=900, seed=0, unseen=False):
    """`numeric`: three classes shifting four numeric columns, NaNs in
    one; `categorical`: a binary class with two numeric and two enum
    columns whose levels lean by class; `unseen` adds the level "zz" to
    the first enum column. Numeric values lie on `_grid`."""
    rng = np.random.default_rng(seed)
    if kind == "numeric":
        y = rng.integers(0, 3, n)
        X = _grid(rng.normal(size=(n, 4))
                  + y[:, None] * np.array([1.0, -0.5, 0.3, 0]))
        X[::13, 2] = np.nan
        cols = {f"x{i}": X[:, i] for i in range(4)}
        cols["y"] = np.asarray(["a", "b", "c"], dtype=object)[y]
        return _frames(cols, {"y": "enum"})
    y = rng.integers(0, 2, n)
    X = _grid(rng.normal(size=(n, 2)) * 2 + y[:, None] * 2.0)
    g = np.where(rng.uniform(size=n) < 0.7, y * 2, rng.integers(0, 4, n))
    h = rng.integers(0, 3, n)
    gl = np.asarray(list("pqrs"), dtype=object)[g]
    if unseen:
        gl[::17] = "zz"
    cols = {"x0": X[:, 0], "x1": X[:, 1], "g": gl,
            "h": np.asarray(["u", "v", "w"], dtype=object)[h],
            "y": np.asarray(["no", "yes"], dtype=object)[y]}
    return _frames(cols, {"g": "enum", "h": "enum", "y": "enum"})


def _probs(frame, domain):
    return np.column_stack([frame.vec(str(c)).numeric_np() for c in domain])


def _fit_nb(rf, pf, **params):
    ref = refnb.H2ONaiveBayesEstimator(**params)
    ref.train(y="y", training_frame=rf)
    port = H2ONaiveBayesEstimator(device="cpu", **params)
    port.train(y="y", training_frame=pf)
    return ref, port


def _check_nb(rm, pm):
    assert pm.spec == rm.spec and pm.domain == rm.domain
    assert pm.priors.tobytes() == rm.priors.tobytes()
    for name, (tab, dom) in rm.cat_tables.items():
        assert pm.cat_tables[name][1] == dom
        assert pm.cat_tables[name][0].tobytes() == tab.tobytes(), name
    for name, st in rm.num_stats.items():
        assert np.abs(pm.num_stats[name] - st).max() <= MOMENT_TOL * np.abs(
            st).max(), name


@pytest.mark.parametrize("kind", ["numeric", "categorical"])
def test_naive_bayes_matches_the_reference(cloud1, kind):
    rf, pf = _nb_frames(kind)
    params = dict(laplace=1.0) if kind == "categorical" else {}
    ref, port = _fit_nb(rf, pf, **params)
    rm, pm = ref.model, port.model
    _check_nb(rm, pm)
    rt, pt = _nb_frames(kind, 400, seed=5, unseen=kind == "categorical")
    for r_fr, p_fr in ((rf, pf), (rt, pt)):
        want, got = rm.predict(r_fr), pm.predict(p_fr)
        assert np.abs(_probs(got, pm.domain)
                      - _probs(want, rm.domain)).max() <= PROB_TOL
    for name in ("logloss", "mse", "mean_per_class_error"):
        r, p = getattr(rm.training_metrics, name), getattr(
            pm.training_metrics, name)
        assert abs(r - p) <= METRIC_TOL * max(1.0, abs(r)), name
    # a second fit sums in the same order: bit-equal moments
    again = H2ONaiveBayesEstimator(device="cpu", **params)
    again.train(y="y", training_frame=pf)
    for name, st in pm.num_stats.items():
        assert again.model.num_stats[name].tobytes() == st.tobytes()


def _iso_frames(n=600, seed=1, w=True):
    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-2, 2, n), 2)           # ties
    y = np.tanh(x) + rng.normal(0, 0.4, n)
    x[::31] = np.nan
    cols = {"x": x, "y": y}
    if w:
        cols["w"] = rng.uniform(0.2, 3.0, n)
    return _frames(cols, {})


def _fit_iso(rf, pf, **params):
    ref = refiso.H2OIsotonicRegressionEstimator(**params)
    ref.train(x=["x"], y="y", training_frame=rf)
    port = H2OIsotonicRegressionEstimator(device="cpu", **params)
    port.train(x=["x"], y="y", training_frame=pf)
    return ref, port


@pytest.mark.parametrize("oob", ["NA", "clip"])
def test_isotonic_matches_the_reference(cloud1, oob):
    rf, pf = _iso_frames()
    ref, port = _fit_iso(rf, pf, out_of_bounds=oob, weights_column="w")
    rm, pm = ref.model, port.model
    assert pm.thresholds_x.tobytes() == rm.thresholds_x.tobytes()
    assert pm.thresholds_y.tobytes() == rm.thresholds_y.tobytes()
    col = pf.vec("x").numeric_np()
    ok = ~np.isnan(col)
    w = pf.vec("w").numeric_np()
    for a, b in zip(piso.pav(col[ok], pf.vec("y").numeric_np()[ok], w[ok]),
                    refiso.pav(col[ok], pf.vec("y").numeric_np()[ok], w[ok])):
        assert a.tobytes() == b.tobytes()
    tx, ty = pm.thresholds_x, pm.thresholds_y
    assert np.all(np.diff(tx) > 0) and np.all(np.diff(ty) >= 0)
    # rows inside, on the knots, between them, at and past both ends, NaN
    q = np.concatenate([np.linspace(-2.5, 2.5, 401), tx,
                        (tx[:-1] + tx[1:]) / 2, [np.nan, tx[0], tx[-1]]])
    got = pm._score(q)                       # f64, before the f32 frame
    want = np.interp(q, tx, ty)
    if oob == "NA":
        want = np.where((q < tx[0]) | (q > tx[-1]), np.nan, want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert got[ok].tobytes() == want[ok].tobytes()
    assert np.array_equal(rm._score(q), got, equal_nan=True)
    got_f = pm.predict(Frame.from_dict({"x": q})).vec("predict").numeric_np()
    ref_f = rm.predict(RefFrame.from_dict({"x": q})).vec("predict")
    assert np.array_equal(got_f, ref_f.numeric_np(), equal_nan=True)
    for name in ("mse", "rmse", "mae", "r2"):
        r, p = getattr(rm.training_metrics, name), getattr(
            pm.training_metrics, name)
        assert abs(r - p) <= METRIC_TOL * max(1.0, abs(r)), name


@pytest.mark.parametrize("algo", ["naivebayes", "isotonic"])
def test_cross_validation_matches_the_reference(cloud1, algo):
    if algo == "naivebayes":
        rf, pf = _nb_frames("categorical", 700, seed=3)
        ref, port = _fit_nb(rf, pf, nfolds=3, seed=7)
        tol, names = PROB_TOL, ("auc", "logloss")
    else:
        rf, pf = _iso_frames(700, seed=4, w=False)
        ref, port = _fit_iso(rf, pf, nfolds=3, seed=7, out_of_bounds="clip")
        tol, names = 0.0, ("mse", "rmse")
    rm, pm = ref.model, port.model
    assert len(pm.cross_validation_models) == len(rm.cross_validation_models) == 3
    a, b = rm._cv_holdout_pred, pm._cv_holdout_pred
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nan_to_num(np.abs(a - b)).max() <= tol
    for name in names:
        r = getattr(rm.cross_validation_metrics, name)
        p = getattr(pm.cross_validation_metrics, name)
        assert (np.isnan(r) and np.isnan(p)) or abs(r - p) <= METRIC_TOL * max(
            1.0, abs(r)), name


def test_errors_and_unread_parameters(cloud1):
    rf, pf = _iso_frames(200)
    with pytest.raises(ValueError, match="categorical response"):
        refnb.H2ONaiveBayesEstimator().train(y="y", training_frame=rf)
    with pytest.raises(ValueError, match="categorical response"):
        H2ONaiveBayesEstimator(device="cpu").train(y="y", training_frame=pf)
    with pytest.raises(ValueError, match="exactly one feature"):
        refiso.H2OIsotonicRegressionEstimator().train(
            x=["x", "w"], y="y", training_frame=rf)
    with pytest.raises(ValueError, match="exactly one feature"):
        H2OIsotonicRegressionEstimator(device="cpu").train(
            x=["x", "w"], y="y", training_frame=pf)
    _, nbf = _nb_frames("numeric", 200)
    for bad in (dict(eps_sdev=0.1), dict(eps_prob=0.1),
                dict(compute_metrics=False), dict(balance_classes=True),
                dict(class_sampling_factors=[1.0, 2.0, 1.0]),
                dict(max_after_balance_size=2.0)):
        name = next(iter(bad))
        with pytest.raises(NotImplementedError, match=f"{name}.*item 10"):
            H2ONaiveBayesEstimator(device="cpu", **bad).train(
                y="y", training_frame=nbf)
    with pytest.raises(NotImplementedError, match="custom_metric_func.*item 10"):
        H2OIsotonicRegressionEstimator(
            device="cpu", custom_metric_func="python:mse").train(
            x=["x"], y="y", training_frame=pf)


def _same_artifacts(tmp_path, rm, pm, name):
    pp = mojo.save_model(pm, str(tmp_path), f"port_{name}.h2o3")
    rp = refmojo.save_model(rm, str(tmp_path), f"ref_{name}.h2o3")
    pn, pmeta, parr = _members(pp)
    rn, rmeta, rarr = _members(rp)
    assert pn == rn and sorted(parr) == sorted(rarr)
    assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
        k: v for k, v in rmeta.items() if k != "model_id"}
    return pp, rp, parr, rarr


def test_mojo_convert_and_serving(cloud1, tmp_path):
    eng = ScoringEngine(ServingConfig())
    try:
        # NaiveBayes: tables bit for bit, moments to f32 summation order
        rf, pf = _nb_frames("categorical", 800, seed=9)
        ref, port = _fit_nb(rf, pf, laplace=0.5)
        rm, pm = ref.model, port.model
        rt, pt = _nb_frames("categorical", 300, seed=10, unseen=True)
        pp, rp, parr, rarr = _same_artifacts(tmp_path, rm, pm, "nb")
        for name in rarr:
            assert parr[name].dtype == rarr[name].dtype, name
            if name.startswith("nb_num_"):
                assert np.abs(parr[name] - rarr[name]).max() <= (
                    MOMENT_TOL * np.abs(rarr[name]).max()), name
            else:
                assert parr[name].tobytes() == rarr[name].tobytes(), name
        want = _probs(refmojo.load_model(rp).predict(rt), rm.domain)
        assert np.array_equal(_probs(mojo.load_model(rp).predict(pt),
                                     rm.domain), want)
        assert np.abs(_probs(refmojo.load_model(pp).predict(rt), rm.domain)
                      - want).max() <= PROB_TOL
        live = _probs(pm.predict(pt), pm.domain)
        assert np.abs(_probs(mojo.load_model(pp).predict(pt), pm.domain)
                      - live).max() <= 1e-12
        carried = convert.naivebayes_from_numpy(
            priors=rm.priors, num_stats=rm.num_stats,
            cat_tables=rm.cat_tables, spec=rm.spec, x=rm.x, y=rm.y,
            domain=rm.domain, device="cpu")
        assert np.abs(_probs(carried.predict(pt), rm.domain)
                      - want).max() <= PROB_TOL
        sub = pt.take(np.arange(11, 250))
        served = eng.score("nb", pm, sub)
        assert np.array_equal(_probs(served, pm.domain),
                              _probs(pm.predict(sub), pm.domain))

        # isotonic: knots bit for bit, scores bit for bit
        rf, pf = _iso_frames(500, seed=12)
        ref, port = _fit_iso(rf, pf, weights_column="w")
        rm, pm = ref.model, port.model
        pp, rp, parr, rarr = _same_artifacts(tmp_path, rm, pm, "iso")
        for name in rarr:
            assert parr[name].tobytes() == rarr[name].tobytes(), name
        q = np.linspace(-3, 3, 257)
        q[::9] = np.nan
        want = rm.predict(RefFrame.from_dict({"x": q})).vec(
            "predict").numeric_np()
        for scored in (mojo.load_model(pp).predict(Frame.from_dict({"x": q})),
                       mojo.load_model(rp).predict(Frame.from_dict({"x": q})),
                       refmojo.load_model(pp).predict(
                           RefFrame.from_dict({"x": q})),
                       pm.predict(Frame.from_dict({"x": q}))):
            assert np.array_equal(scored.vec("predict").numeric_np(), want,
                                  equal_nan=True)
        carried = convert.isotonic_from_numpy(
            thresholds_x=rm.thresholds_x, thresholds_y=rm.thresholds_y,
            x=rm.x, y=rm.y, out_of_bounds=rm.out_of_bounds, device="cpu")
        assert np.array_equal(carried._score(q), pm._score(q), equal_nan=True)
        sub = Frame.from_dict({"x": q[:100]})
        served = eng.score("iso", pm, sub).vec("predict").numeric_np()
        assert np.array_equal(served, pm.predict(sub).vec(
            "predict").numeric_np(), equal_nan=True)
        assert eng.snapshot()["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()
