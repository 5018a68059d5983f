"""RuleFit of the port against the reference's, on the CPU.

The same numpy-seeded frames (the reference's own RuleFit fixtures of
`tests/test_longtail3.py`, whose trees have no near-tied gains) go
through the JAX package on a one-device cloud and through the port with
`device="cpu"`:

- binomial with `max_num_rules`, regression with `model_type="rules"`,
  and `algorithm="GBM"`: the rules equal, rule for rule and in order, with
  their supports bit for bit; the rules of a reference forest carried
  across equal to the reference's extraction; the rule evaluation bit-equal
  to the reference's host `Rule.evaluate`; the chosen λ's index on the
  path equal; the coefficients within COEF_TOL = 5e-3 (the lasso path's β
  is f32 in both packages, summed in other orders: a CPU rehearsal of
  these fixtures measured 2.1e-3 on the regression's unstandardized
  0/1 columns) and the predictions within PRED_TOL = 1e-4 (measured
  3.2e-5); `rule_importance` equal in names and order;
- `max_num_rules` honoured at 5 (regression): the same λ index, at most
  5 active rules;
- 3-fold CV (binomial, GBM): the folds' rules, holdouts and
  cross-validation metrics;
- the reference's `ValueError` and the port's `NotImplementedError`s for
  the parameters the reference never reads;
- the `rulefit` MOJO payload with its GLM child member for member, loading
  across both ways; `convert.rulefit_from_numpy`; a served batch equal to
  `predict` with no fallback.
"""

import types

import numpy as np
import pytest
import torch

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import drf as refdrf
from h2o3_tpu.models import rulefit as refrf
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import H2ORuleFitEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import rulefit as prf
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

COEF_TOL = 5e-3
PRED_TOL = 1e-4
METRIC_TOL = 1e-4


def _frames(cols, types_):
    return (RefFrame.from_dict(cols, column_types=types_),
            Frame.from_dict(cols, column_types=types_))


def _binary_frames(n=800, seed=0):
    """`tests/test_longtail3.py::_binary_frame`, NaNs added to x3."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    y = ((X[:, 0] > 0.3) & (X[:, 1] < 0.5) | (X[:, 2] > 1.0)).astype(int)
    X[::23, 3] = np.nan
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["y"] = np.asarray(["no", "yes"], dtype=object)[y]
    return _frames(cols, {"y": "enum"})


def _regression_frames(n=500, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    y = np.where(X[:, 0] > 0, 2.0, -1.0) + 0.1 * rng.normal(size=n)
    cols = {f"x{i}": X[:, i] for i in range(3)}
    cols["y"] = y
    return _frames(cols, {})


CASES = {
    "binomial": (_binary_frames, dict(
        max_num_rules=20, min_rule_length=2, max_rule_length=3,
        rule_generation_ntrees=20, seed=7)),
    "regression": (_regression_frames, dict(
        model_type="rules", min_rule_length=1, max_rule_length=2,
        rule_generation_ntrees=10, seed=3)),
    "gbm": (lambda: _binary_frames(600, 6), dict(
        rule_generation_ntrees=10, seed=1, algorithm="GBM")),
}


def _fit(rf, pf, **params):
    x = [n for n in pf.names if n != "y"]
    ref = refrf.H2ORuleFitEstimator(**params)
    ref.train(x=x, y="y", training_frame=rf)
    port = H2ORuleFitEstimator(device="cpu", **params)
    port.train(x=x, y="y", training_frame=pf)
    return ref, port


def _lam_index(gm):
    lams = [lv for lv, _ in gm.full_path]
    return int(np.argmin(np.abs(np.asarray(lams) - gm.lambda_best)))


def _pred(frame, model):
    return frame.vec("1" if model.problem == "binomial" else
                     "predict").numeric_np()


def _names(frame, col):
    v = frame.vec(col)
    return [v.domain[c] for c in np.asarray(v.data)]


def _check(rm, pm, rf, pf):
    assert [r.conds for r in pm.rules] == [r.conds for r in rm.rules]
    assert [r.support for r in pm.rules] == [r.support for r in rm.rules]
    assert max(abs(a.coef - b.coef) for a, b in zip(pm.rules, rm.rules)) <= (
        COEF_TOL)
    assert pm.lin_cols == rm.lin_cols and pm.lin_stats == rm.lin_stats
    assert _lam_index(pm._glm.model) == _lam_index(rm._glm.model)
    assert np.abs(_pred(pm.predict(pf), pm) - _pred(rm.predict(rf), rm)).max() <= (
        PRED_TOL)
    ip, ir = pm.rule_importance(), rm.rule_importance()
    assert _names(ip, "variable") == _names(ir, "variable")
    assert _names(ip, "rule") == _names(ir, "rule")
    assert np.abs(ip.vec("coefficient").numeric_np()
                  - ir.vec("coefficient").numeric_np()).max() <= COEF_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_rulefit_matches_the_reference(cloud1, case):
    make, params = CASES[case]
    rf, pf = make()
    ref, port = _fit(rf, pf, **params)
    rm, pm = ref.model, port.model
    _check(rm, pm, rf, pf)
    # rule evaluation on the device path bit-equal to the host's
    X = np.column_stack([pf.vec(n).numeric_np() for n in pm.x])
    M = prf.evaluate_rules(torch.from_numpy(X), pm.rules, pm._col_of)
    want = np.column_stack([r.evaluate(X, pm._col_of) for r in rm.rules])
    assert np.array_equal(M.numpy().astype(np.float64), want)
    for name in ("auc", "logloss") if pm.problem == "binomial" else (
            "rmse", "mae"):
        r = getattr(rm.training_metrics, name)
        p = getattr(pm.training_metrics, name)
        assert abs(r - p) <= METRIC_TOL * max(1.0, abs(r)), name
    if case == "binomial":
        assert pm.rule_counts["active"] <= params["max_num_rules"]
        # a reference forest carried across gives the reference's rules
        d = params["max_rule_length"]
        tree = refdrf.H2ORandomForestEstimator(ntrees=10, max_depth=d,
                                               seed=params["seed"] + d)
        tree.train(x=pm.x, y="y", training_frame=rf)
        carried = types.SimpleNamespace(forest=[types.SimpleNamespace(
            **{f: torch.from_numpy(np.asarray(getattr(s, f)))
               for f in ("feat", "thr", "is_split")})
            for s in tree.model.forest])
        assert [r.conds for r in prf._extract_rules(carried, pm.x, d)] == [
            r.conds for r in refrf._extract_rules(tree.model, pm.x, d)]


def test_max_num_rules_is_honoured(cloud1):
    rf, pf = _regression_frames(400, seed=2)
    ref, port = _fit(rf, pf, max_num_rules=5, min_rule_length=1,
                     max_rule_length=3, rule_generation_ntrees=12, seed=4)
    rm, pm = ref.model, port.model
    _check(rm, pm, rf, pf)
    assert pm.rule_counts["chosen_index"] == _lam_index(rm._glm.model)
    assert sum(abs(r.coef) > 1e-10 for r in pm.rules) <= 5
    assert pm.rule_importance().nrow <= 5 + len(pm.lin_cols)


def test_cross_validation_matches_the_reference(cloud1):
    rf, pf = _binary_frames(600, seed=3)
    ref, port = _fit(rf, pf, nfolds=3, rule_generation_ntrees=8, seed=5,
                     algorithm="GBM")
    rm, pm = ref.model, port.model
    assert len(pm.cross_validation_models) == len(
        rm.cross_validation_models) == 3
    for a, b in zip(rm.cross_validation_models, pm.cross_validation_models):
        assert [r.conds for r in b.rules] == [r.conds for r in a.rules]
    assert np.abs(rm._cv_holdout_pred - pm._cv_holdout_pred).max() <= PRED_TOL
    for name in ("auc", "logloss"):
        r = getattr(rm.cross_validation_metrics, name)
        p = getattr(pm.cross_validation_metrics, name)
        assert abs(r - p) <= METRIC_TOL * max(1.0, abs(r)), name


def test_errors_and_unread_parameters(cloud1):
    rng = np.random.default_rng(0)
    cols = {"x0": rng.normal(size=90),
            "y": np.asarray(list("abc"), dtype=object)[np.arange(90) % 3]}
    rf, pf = _frames(cols, {"y": "enum"})
    with pytest.raises(ValueError, match="binomial/regression"):
        refrf.H2ORuleFitEstimator().train(x=["x0"], y="y", training_frame=rf)
    with pytest.raises(ValueError, match="binomial/regression"):
        H2ORuleFitEstimator(device="cpu").train(x=["x0"], y="y",
                                                training_frame=pf)
    _, pf = _binary_frames(200)
    for bad in (dict(distribution="bernoulli"),
                dict(remove_duplicates=False), dict(lambda_=0.01)):
        name = next(iter(bad))
        with pytest.raises(NotImplementedError, match=f"{name}.*item 10"):
            H2ORuleFitEstimator(device="cpu", **bad).train(
                y="y", training_frame=pf)


def test_mojo_convert_and_serving(cloud1, tmp_path):
    rf, pf = _binary_frames(600, seed=6)
    ref, port = _fit(rf, pf, rule_generation_ntrees=10, seed=1,
                     algorithm="GBM")
    rm, pm = ref.model, port.model
    pp = mojo.save_model(pm, str(tmp_path), "port_rf.h2o3")
    rp = refmojo.save_model(rm, str(tmp_path), "ref_rf.h2o3")
    pn, pmeta, parr = _members(pp)
    rn, rmeta, rarr = _members(rp)
    assert pn == rn == sorted(["model.json", "arrays.npz", "glm/model.json",
                               "glm/arrays.npz"])
    assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
        k: v for k, v in rmeta.items() if k != "model_id"}
    assert sorted(parr) == sorted(rarr) == []
    rt, pt = _binary_frames(300, seed=16)
    want = _pred(refmojo.load_model(rp).predict(rt), rm)
    assert np.array_equal(_pred(mojo.load_model(rp).predict(pt), rm), want)
    got = _pred(mojo.load_model(pp).predict(pt), pm)
    assert np.array_equal(_pred(refmojo.load_model(pp).predict(rt), pm), got)
    assert np.abs(got - _pred(pm.predict(pt), pm)).max() <= 1e-5
    assert np.abs(got - want).max() <= PRED_TOL
    gm = rm._glm.model
    carried = convert.rulefit_from_numpy(
        rules=[(r.conds, r.support, r.coef) for r in rm.rules],
        lin_cols=rm.lin_cols, lin_stats=rm.lin_stats,
        glm=dict(beta=gm.beta, family=gm.family, x=gm.x, y=gm.y,
                 spec=gm.dinfo._spec, coef_names=gm.dinfo.coef_names,
                 col_means=gm.dinfo.col_means, standardize=False,
                 domain=gm.domain, lambda_best=gm.lambda_best),
        x=rm.x, y=rm.y, domain=rm.domain, problem=rm.problem, device="cpu")
    assert np.abs(_pred(carried.predict(pt), rm)
                  - _pred(rm.predict(rt), rm)).max() <= 1e-5
    assert _names(carried.rule_importance(), "rule") == _names(
        rm.rule_importance(), "rule")
    eng = ScoringEngine(ServingConfig())
    try:
        sub = pt.take(np.arange(5, 260))
        served = eng.score("rulefit", pm, sub)
        assert np.array_equal(_pred(served, pm), _pred(pm.predict(sub), pm))
        assert eng.snapshot()["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()
