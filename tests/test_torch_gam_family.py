"""GAM, ANOVA GLM and ModelSelection of the port against the reference's,
on the CPU.

The same numpy-seeded frames go through the JAX package on a one-device
cloud and through the port with `device="cpu"`:

- GAM, gaussian and binomial, with a linear numeric and a linear
  categorical column beside the spline column: the knots, the centres,
  the basis and the penalty bit for bit (`ops/splines.py` against the
  reference's), the coefficient names equal, β within BETA_TOL = 1e-3 of
  the largest |β| (the unstandardized f32 Gram's rounding moves β while η
  barely moves), the metrics within METRIC_TOL = 1e-5, and predictions
  within GRAM_TOL = 2e-4 of the reference's and of an f64 solve of the
  same penalized IRLS: at the defaults (no ridge) the system's condition
  number is ≈5e5 and the f32 Gram leaves both packages ≈8e-5 from the
  f64 solve (ROADMAP §C); with a ridge and fewer knots (condition ≈2e3)
  they agree within PRED_TOL = 1e-5, and so do the 3-fold CV holdouts;
  the MOJO member
  for member (β within BETA_TOL), loading across both ways, and
  `convert.gam_from_numpy`; a served batch;
- ANOVA GLM, gaussian with a categorical column and binomial: the terms
  and their df exactly, an active term's statistic within 1e-4 relative,
  an inactive term's within 1e-6 × the full model's deviance (a
  difference of two large f32-rounded deviances), p-values of active
  terms below 1e-6 in both; `predict` through the full GLM within
  PRED_TOL; `convert.anovaglm_from_numpy`;
- ModelSelection in each of allsubsets, maxr, forward and backward: the
  predictors of every size equal, R² within R2_TOL = 1e-6 and
  `coef(predictor_size)` within COEF_TOL = 1e-4;
  `convert.modelselection_from_numpy`;
- the `TypeError` on exporting ANOVA GLM and ModelSelection, the
  reference's `ValueError`s and the port's `NotImplementedError`s for the
  parameters the reference never reads.
"""

import numpy as np
import pytest

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import anovaglm as refanova
from h2o3_tpu.models import gam as refgam
from h2o3_tpu.models import modelselection as refms
from h2o3_tpu.ops import splines as refsplines
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import (H2OANOVAGLMEstimator,
                                       H2OGeneralizedAdditiveEstimator,
                                       H2OModelSelectionEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import anovaglm as panova
from h2o3_tpu_torch.ops import splines
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

BETA_TOL = 1e-3
GRAM_TOL = 2e-4
PRED_TOL = 1e-5
METRIC_TOL = 1e-5
R2_TOL = 1e-6
COEF_TOL = 1e-4


def _frames(cols, types):
    return (RefFrame.from_dict(cols, column_types=types),
            Frame.from_dict(cols, column_types=types))


def _gam_frames(family, n=800, seed=3):
    """The reference's GAM fixtures (tests/test_glm_family.py): a sine in
    `x`, with a linear `z` and a three-level `g` added."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, n)
    z = rng.normal(size=n)
    g = rng.integers(0, 3, n)
    cols = {"x": x, "z": z, "g": np.asarray(list("abc"), dtype=object)[g]}
    types = {"g": "enum"}
    eta = np.sin(x) * 2 + 0.5 * z + 0.4 * (g == 1)
    if family == "gaussian":
        cols["y"] = eta + rng.normal(0, 0.1, n)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-1.5 * eta))).astype(int)
        cols["y"] = np.asarray(["n", "p"], dtype=object)[y]
        types["y"] = "enum"
    return _frames(cols, types)


def _fit(ref_cls, port_cls, rf, pf, x, y="y", **params):
    ref = ref_cls(**params)
    ref.train(x=x, y=y, training_frame=rf)
    port = port_cls(device="cpu", **params)
    port.train(x=x, y=y, training_frame=pf)
    return ref, port


def _pred(frame, family):
    return frame.vec("p" if family == "binomial" else "predict").numeric_np()


def _f64_solve(pm, pf, family):
    """The port's penalized IRLS (its design, penalty and stop rule) solved
    in f64 throughout: the yardstick for the f32 Gram's rounding."""
    X = pm._design(pf).numpy().astype(np.float64)
    yv = pf.vec("y")
    y = (np.asarray(yv.data, np.float64) if yv.type == "enum"
         else yv.numeric_np())
    b = np.zeros(X.shape[1])
    for _ in range(50):
        eta = X @ b
        if family == "binomial":
            mu = 1 / (1 + np.exp(-eta))
            W = np.clip(mu * (1 - mu), 1e-10, None)
            z = eta + (y - mu) / W
        else:
            W, z = np.ones_like(y), y
        A = (X * W[:, None]).T @ X + pm.penalty
        nb = np.linalg.solve(A + 1e-8 * np.eye(len(b)), X.T @ (W * z))
        done = np.abs(nb - b).max() < 1e-4 or family == "gaussian"
        b = nb
        if done:
            break
    eta = X @ b
    return 1 / (1 + np.exp(-eta)) if family == "binomial" else eta


def _check_gam(rm, pm, rf, pf, family, tol):
    assert len(pm.gam_spec) == len(rm.gam_spec)
    for (pc, pk, pcen), (rc, rk, rcen) in zip(pm.gam_spec, rm.gam_spec):
        assert pc == rc and pk.tobytes() == rk.tobytes()
        assert pcen.tobytes() == rcen.tobytes()
        col = pf.vec(pc).numeric_np()
        assert splines.spline_basis(col, pk).tobytes() == \
            refsplines.spline_basis(col, rk).tobytes()
        m = len(pk) - 1
        assert splines.second_diff_penalty(m).tobytes() == \
            refsplines.second_diff_penalty(m).tobytes()
    assert list(pm.coef()) == list(rm.coef())
    assert np.abs(pm.beta - rm.beta).max() <= BETA_TOL * np.abs(rm.beta).max()
    assert np.abs(_pred(pm.predict(pf), family)
                  - _pred(rm.predict(rf), family)).max() <= tol
    exact = _f64_solve(pm, pf, family)
    assert np.abs(pm._score(pf) - exact).max() <= tol
    assert np.abs(rm._score(rf) - exact).max() <= tol
    names = ("auc", "logloss") if family == "binomial" else ("rmse", "r2")
    for name in names:
        r, p = getattr(rm.training_metrics, name), getattr(
            pm.training_metrics, name)
        assert abs(r - p) <= METRIC_TOL * max(1.0, abs(r)), name


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_gam_matches_the_reference(cloud1, family):
    rf, pf = _gam_frames(family)
    ref, port = _fit(refgam.H2OGeneralizedAdditiveEstimator,
                     H2OGeneralizedAdditiveEstimator, rf, pf, ["x", "z", "g"],
                     gam_columns=["x"], num_knots=[10], family=family)
    rm, pm = ref.model, port.model
    _check_gam(rm, pm, rf, pf, family, GRAM_TOL)
    rt, pt = _gam_frames(family, 300, seed=4)
    assert np.abs(_pred(pm.predict(pt), family)
                  - _pred(rm.predict(rt), family)).max() <= GRAM_TOL
    if family == "gaussian":
        assert pm.training_metrics.rmse < 0.2       # the reference's bar
    else:
        # Δβ of β ≈ 1e2 stalls above beta_epsilon in f32: all 50 steps run
        assert pm.iterations > 1
        assert pm.training_metrics.auc > 0.8


def test_gam_cv_mojo_convert_and_serving(cloud1, tmp_path):
    rf, pf = _gam_frames("binomial", 700, seed=6)
    ref, port = _fit(refgam.H2OGeneralizedAdditiveEstimator,
                     H2OGeneralizedAdditiveEstimator, rf, pf, ["x", "z", "g"],
                     gam_columns=["x"], num_knots=8, scale=[0.5],
                     lambda_=1e-4, nfolds=3, seed=5)
    rm, pm = ref.model, port.model
    _check_gam(rm, pm, rf, pf, "binomial", PRED_TOL)
    assert 1 < pm.iterations < 50 and pm.converged
    assert np.abs(pm._cv_holdout_pred - rm._cv_holdout_pred).max() <= PRED_TOL
    for name in ("auc", "logloss"):
        r = getattr(rm.cross_validation_metrics, name)
        p = getattr(pm.cross_validation_metrics, name)
        assert abs(r - p) <= METRIC_TOL * max(1.0, abs(r)), name

    rt, pt = _gam_frames("binomial", 300, seed=7)
    pp = mojo.save_model(pm, str(tmp_path), "port_gam.h2o3")
    rp = refmojo.save_model(rm, str(tmp_path), "ref_gam.h2o3")
    pn, pmeta, parr = _members(pp)
    rn, rmeta, rarr = _members(rp)
    assert pn == rn and sorted(parr) == sorted(rarr)
    assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
        k: v for k, v in rmeta.items() if k != "model_id"}
    for name in rarr:
        assert parr[name].dtype == rarr[name].dtype, name
        if name == "beta":
            assert np.abs(parr[name] - rarr[name]).max() <= (
                BETA_TOL * np.abs(rarr[name]).max())
        else:
            assert parr[name].tobytes() == rarr[name].tobytes(), name
    want = _pred(refmojo.load_model(rp).predict(rt), "binomial")
    assert np.array_equal(_pred(mojo.load_model(rp).predict(pt), "binomial"),
                          want)
    live = _pred(pm.predict(pt), "binomial")
    for scored in (mojo.load_model(pp).predict(pt),
                   refmojo.load_model(pp).predict(rt)):
        assert np.abs(_pred(scored, "binomial") - live).max() <= PRED_TOL
    assert np.abs(live - want).max() <= PRED_TOL
    di = rm.dinfo
    carried = convert.gam_from_numpy(
        beta=rm.beta, family=rm.family, x=rm.x, y=rm.y, spec=di._spec,
        coef_names=di.coef_names, gam_spec=rm.gam_spec, means=di.means,
        stds=di.stds, col_means=di.col_means, standardize=di.standardize,
        use_all=di.use_all, domain=rm.domain, device="cpu")
    assert np.abs(_pred(carried.predict(pt), "binomial")
                  - _pred(rm.predict(rt), "binomial")).max() <= PRED_TOL

    eng = ScoringEngine(ServingConfig())
    try:
        sub = pt.take(np.arange(9, 260))
        served = _pred(eng.score("gam", pm, sub), "binomial")
        assert np.abs(served - _pred(pm.predict(sub), "binomial")).max() <= 1e-7
        assert eng.snapshot()["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()


def _anova_frames(family, n=500, seed=5):
    """The reference's ANOVA fixture: only `a` matters; `b` is noise; a
    three-level `c` is added, active in the binomial case."""
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=n), rng.normal(size=n)
    c = rng.integers(0, 3, n)
    cols = {"a": a, "b": b, "c": np.asarray(list("xyz"), dtype=object)[c]}
    types = {"c": "enum"}
    if family == "gaussian":
        cols["y"] = 2.0 * a + rng.normal(0, 0.5, n)
    else:
        eta = 1.5 * a + 1.2 * (c == 2) - 0.5
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(int)
        cols["y"] = np.asarray(["0", "1"], dtype=object)[y]
        types["y"] = "enum"
    return _frames(cols, types)


@pytest.mark.parametrize("family", ["gaussian", "binomial"])
def test_anovaglm_matches_the_reference(cloud1, family):
    rf, pf = _anova_frames(family)
    x = ["a", "b", "c"]
    ref, port = _fit(refanova.H2OANOVAGLMEstimator, H2OANOVAGLMEstimator,
                     rf, pf, x, family=family, highest_interaction_term=2)
    rm, pm = ref.model, port.model
    assert pm._terms == rm._terms
    rtab, ptab = rm._table, pm._table
    assert [r["term"] for r in ptab] == [r["term"] for r in rtab]
    assert [r["df"] for r in ptab] == [r["df"] for r in rtab] == [
        1, 1, 2, 1, 2, 2]
    yv = rf.vec("y")
    yarr = (np.asarray(yv.data, np.float64) if yv.type == "enum"
            else yv.numeric_np())
    design = rm._as_design(rf)
    dev_full = refanova._deviance(family, yarr, rm._full.model._score(design),
                                  np.ones(rf.nrow))
    active = {"a"} | ({"c"} if family == "binomial" else set())
    for r, p in zip(rtab, ptab):
        if r["term"] in active:
            assert abs(p["deviance"] - r["deviance"]) <= 1e-4 * r["deviance"]
            assert p["p_value"] < 1e-6 and r["p_value"] < 1e-6
        else:
            assert abs(p["deviance"] - r["deviance"]) <= 1e-6 * dev_full, r
        assert p["deviance"] >= 0 and np.isfinite(p["deviance"])
    res = pm.result()
    assert res.names == ["model", "df", "deviance", "p_value"]
    got = pm.predict(pf)
    want = rm.predict(rf)
    col = "1" if family == "binomial" else "predict"
    assert np.abs(got.vec(col).numeric_np()
                  - want.vec(col).numeric_np()).max() <= PRED_TOL
    assert pm.training_metrics.nobs == rf.nrow
    fm = rm._full.model
    carried = convert.anovaglm_from_numpy(
        table=rtab, terms=rm._terms, x=rm.x, y=rm.y, full_glm=dict(
            beta=fm.beta, family=fm.family, x=fm.x, y=fm.y,
            spec=fm.dinfo._spec, coef_names=fm.dinfo.coef_names,
            col_means=fm.dinfo.col_means, standardize=False,
            domain=fm.domain), device="cpu")
    assert np.abs(carried.predict(pf).vec(col).numeric_np()
                  - want.vec(col).numeric_np()).max() <= PRED_TOL
    assert carried._table == [dict(r) for r in rtab]


def _ms_frame(n=400, seed=6):
    """The reference's ModelSelection fixture with a fourth, weaker
    predictor: y = 3·x1 + 1.5·x2 + 0.6·x4 + noise, x3 pure noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    y = 3 * X[:, 0] + 1.5 * X[:, 1] + 0.6 * X[:, 3] + rng.normal(0, 0.3, n)
    cols = {f"x{i + 1}": X[:, i] for i in range(4)}
    cols["y"] = y
    return _frames(cols, {})


@pytest.mark.parametrize("mode", ["allsubsets", "maxr", "forward",
                                  "backward"])
def test_modelselection_matches_the_reference(cloud1, mode):
    rf, pf = _ms_frame()
    x = ["x1", "x2", "x3", "x4"]
    ref, port = _fit(refms.H2OModelSelectionEstimator,
                     H2OModelSelectionEstimator, rf, pf, x, mode=mode,
                     max_predictor_number=4, family="gaussian")
    rm, pm = ref.model, port.model
    assert pm.get_best_model_predictors() == rm.get_best_model_predictors()
    assert [r["size"] for r in pm._results] == [r["size"] for r in rm._results]
    for a, b in zip(pm.get_best_r2_values(), rm.get_best_r2_values()):
        assert abs(a - b) <= R2_TOL
    for r in rm._results:
        cp, cr = pm.coef(r["size"]), rm.coef(r["size"])
        assert list(cp) == list(cr)
        assert max(abs(cp[k] - cr[k]) for k in cr) <= COEF_TOL
    preds = pm.get_best_model_predictors()
    assert preds[0] == ["x1"] and set(preds[1]) == {"x1", "x2"}
    assert set(preds[2]) == {"x1", "x2", "x4"}
    assert np.abs(pm.predict(pf).vec("predict").numeric_np()
                  - rm.predict(rf).vec("predict").numeric_np()).max() <= PRED_TOL
    res = pm.result()          # the frame keeps f32
    assert np.array_equal(res.vec("r2").numeric_np(), np.asarray(
        pm.get_best_r2_values(), np.float32))
    if mode == "maxr":
        carried = convert.modelselection_from_numpy(
            results=rm._results, x=rm.x, y=rm.y, device="cpu", glms=[dict(
                beta=g.model.beta, family=g.model.family, x=g.model.x,
                y=g.model.y, spec=g.model.dinfo._spec,
                coef_names=g.model.dinfo.coef_names, means=g.model.dinfo.means,
                stds=g.model.dinfo.stds, col_means=g.model.dinfo.col_means)
                for g in rm._best])
        assert carried.get_best_model_predictors() == preds
        assert np.abs(carried.predict(pf).vec("predict").numeric_np()
                      - rm.predict(rf).vec("predict").numeric_np()).max() <= PRED_TOL


def test_errors_exports_and_unread_parameters(cloud1, tmp_path):
    rf, pf = _gam_frames("gaussian", 200)
    with pytest.raises(ValueError, match="requires gam_columns"):
        refgam.H2OGeneralizedAdditiveEstimator().train(
            x=["x", "z"], y="y", training_frame=rf)
    with pytest.raises(ValueError, match="requires gam_columns"):
        H2OGeneralizedAdditiveEstimator(device="cpu").train(
            x=["x", "z"], y="y", training_frame=pf)
    for est in (refgam.H2OGeneralizedAdditiveEstimator,
                H2OGeneralizedAdditiveEstimator):
        kw = {} if est is refgam.H2OGeneralizedAdditiveEstimator else dict(
            device="cpu")
        with pytest.raises(ValueError, match="num_knots has 2 entries"):
            est(gam_columns=["x"], num_knots=[5, 6], **kw).train(
                x=["x", "z"], y="y", training_frame=rf if not kw else pf)
    for bad in (dict(bs=[1]), dict(spline_orders=[3]), dict(alpha=0.5),
                dict(keep_gam_cols=True)):
        name = next(iter(bad))
        with pytest.raises(NotImplementedError, match=f"{name}.*item 10"):
            H2OGeneralizedAdditiveEstimator(
                gam_columns=["x"], device="cpu", **bad).train(
                x=["x", "z"], y="y", training_frame=pf)
    for bad in (dict(link="identity"), dict(lambda_=0.1), dict(alpha=0.5),
                dict(standardize=False), dict(type=2),
                dict(early_stopping=True),
                dict(save_transformed_framekeys=True)):
        name = next(iter(bad))
        with pytest.raises(NotImplementedError, match=f"{name}.*item 10"):
            H2OANOVAGLMEstimator(device="cpu", **bad).train(
                x=["x", "z"], y="y", training_frame=pf)
    for bad in (dict(p_values_threshold=0.05), dict(lambda_=0.1),
                dict(alpha=0.5), dict(intercept=False),
                dict(build_glm_model=True)):
        name = next(iter(bad))
        with pytest.raises(NotImplementedError, match=f"{name}.*item 10"):
            H2OModelSelectionEstimator(device="cpu", **bad).train(
                x=["x", "z"], y="y", training_frame=pf)
    with pytest.raises(ValueError, match="unknown mode"):
        H2OModelSelectionEstimator(device="cpu", mode="sideways").train(
            x=["x", "z"], y="y", training_frame=pf)
    # neither package exports ANOVA GLM or ModelSelection
    for ref_cls, port_cls in (
            (refanova.H2OANOVAGLMEstimator, H2OANOVAGLMEstimator),
            (refms.H2OModelSelectionEstimator, H2OModelSelectionEstimator)):
        ref, port = _fit(ref_cls, port_cls, rf, pf, ["x", "z"])
        with pytest.raises(TypeError, match="not a MOJO-exportable kind"):
            refmojo.save_model(ref.model, str(tmp_path), "ref.h2o3")
        with pytest.raises(TypeError, match="not a MOJO-exportable kind"):
            mojo.save_model(port.model, str(tmp_path), "port.h2o3")
    assert panova._chi2_sf(3.841458820694124, 1) == pytest.approx(0.05)
