"""GLM of the port against the reference's: seeded frames of 4000 rows with
two numeric and three enum columns (string levels, NaNs in a numeric
column) through the JAX package on a one-device cloud and through the port
on the CPU, one fit per case.

Each case must run the same path ("fused", "fused_path" or, under
``H2O3_EST_LEGACY=1``, "legacy") for the same number of IRLS iterations,
pick the same λ on a path, and give coefficients within 1e-4 and
predictions within 1e-5. The two packages add their f32 Gram sums in
another order, so β differs in its last bits and no tighter bound holds;
every fixture's last two Δβ lie at least 10 % from β_eps, so the two stop
at the same iteration (`test_last_step_is_far_from_beta_eps`).
"""

import numpy as np
import pytest
import torch

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import estimator_engine as ref_est
from h2o3_tpu.models import glm as refglm
from h2o3_tpu.models.glm import H2OGeneralizedLinearEstimator as RefGLM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import estimator_engine as est
from h2o3_tpu_torch.models import glm

X_COLS = ["a", "b", "c1", "c2", "c3"]
TYPES = {"c1": "enum", "c2": "enum", "c3": "enum"}


def glm_frame(n, seed, family, weights=False):
    """Two numeric columns (`a` normal with 3 % NaN, `b` uniform) and three
    string enums of 4, 3 and 5 levels; the response drawn from `family`
    around a linear predictor in all five. Binomial responses are the
    strings "no"/"yes"."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = rng.uniform(0, 4, n)
    c1 = rng.integers(0, 4, n)
    c2 = rng.integers(0, 3, n)
    c3 = rng.integers(0, 5, n)
    eta = (0.8 * np.nan_to_num(a) - 0.3 * b + np.asarray([0, .5, -.4, .2])[c1]
           + np.asarray([0, -.6, .3])[c2] + 0.15 * c3)
    if family == "gaussian":
        y = 1.0 + eta + 0.5 * rng.normal(size=n)
    elif family in ("binomial", "quasibinomial"):
        y = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "yes", "no")
        y = y.astype(object)
    elif family == "fractionalbinomial":
        y = rng.binomial(10, 1 / (1 + np.exp(-eta))) / 10.0
    elif family == "poisson":
        y = rng.poisson(np.exp(0.5 * eta)).astype(np.float64)
    elif family == "gamma":
        mu = np.exp(0.5 * eta + 1.0)
        y = rng.gamma(2.0, mu / 2.0)
    else:  # tweedie: a compound Poisson-gamma with exact zeros
        mu = np.exp(0.5 * eta)
        y = rng.poisson(mu) * rng.gamma(2.0, 0.5, n)
    a = a.copy()
    a[rng.random(n) < 0.03] = np.nan
    d = {"a": a, "b": b,
         "c1": np.asarray(["ORD", "JFK", "SFO", "ATL"], dtype=object)[c1],
         "c2": np.asarray(["mon", "tue", "wed"], dtype=object)[c2],
         "c3": np.asarray([f"L{i}" for i in range(5)], dtype=object)[c3],
         "y": y}
    if weights:
        d["w"] = rng.uniform(0.5, 2.0, n)
    types = dict(TYPES)
    if family in ("binomial", "quasibinomial"):
        types["y"] = "enum"
    return d, types


# case -> (family, parameters, validation frame, legacy comparator)
CASES = {
    "gaussian_ols": ("gaussian", dict(lambda_=0.0), False, False),
    "binomial": ("binomial", dict(lambda_=0.0), False, False),
    "quasibinomial": ("quasibinomial", dict(lambda_=0.0), False, False),
    "fractionalbinomial": ("fractionalbinomial", dict(lambda_=0.0), False,
                           False),
    "poisson": ("poisson", dict(lambda_=0.0), False, False),
    "gamma": ("gamma", dict(lambda_=0.0), False, False),
    "tweedie": ("tweedie", dict(lambda_=0.0), False, False),
    "ridge": ("gaussian", dict(lambda_=0.05, alpha=0.0), False, False),
    "ridge_binomial": ("binomial", dict(lambda_=1e-3, alpha=0.0), False,
                       False),
    "lasso": ("gaussian", dict(lambda_=0.02, alpha=1.0), False, False),
    "elastic_net_poisson": ("poisson", dict(lambda_=2e-3, alpha=0.5),
                            False, False),
    "non_negative": ("gaussian", dict(lambda_=0.0, non_negative=True),
                     False, False),
    "weighted_binomial": ("binomial", dict(lambda_=0.0,
                                           weights_column="w"), False, False),
    "lambda_search": ("gaussian", dict(lambda_search=True, alpha=0.5,
                                       nlambdas=10), False, False),
    "lambda_search_valid": ("binomial", dict(lambda_search=True, alpha=0.5,
                                             nlambdas=10), True, False),
    "pvalues_binomial": ("binomial", dict(lambda_=0.0,
                                          compute_p_values=True), False,
                         False),
    "pvalues_gamma": ("gamma", dict(lambda_=0.0, compute_p_values=True),
                      False, False),
    "legacy_binomial": ("binomial", dict(lambda_=1e-3, alpha=0.5), False,
                        True),
    "legacy_lambda_search": ("poisson", dict(lambda_search=True, alpha=0.5,
                                             nlambdas=6), True, True),
}

def _fit_pair(case):
    family, params, with_valid, legacy = CASES[case]
    weights = "weights_column" in params
    d, types = glm_frame(4000, 0, family, weights=weights)
    t, _ = glm_frame(1500, 1, family, weights=weights)
    rf, pf = (RefFrame.from_dict(d, column_types=types),
              Frame.from_dict(d, column_types=types))
    rt, pt = (RefFrame.from_dict(t, column_types=types),
              Frame.from_dict(t, column_types=types))
    kw = dict(family=family, **params)
    x = X_COLS
    ref = RefGLM(**kw)
    port = H2OGeneralizedLinearEstimator(device="cpu", **kw)
    ref_est.reset_plans()
    ref.train(x=x, y="y", training_frame=rf,
              validation_frame=rt if with_valid else None)
    ref_plan = ref_est.est_stats()["plans"][-1]
    est.reset_plans()
    port.train(x=x, y="y", training_frame=pf,
               validation_frame=pt if with_valid else None)
    port_plan = est.est_stats()["plans"][-1]
    return dict(ref=ref.model, port=port.model, ref_plan=ref_plan,
                port_plan=port_plan, rt=rt, pt=pt, family=family,
                ref_pred=ref.model.predict(rt), port_pred=port.model.predict(pt))


@pytest.fixture(scope="module")
def fits():
    out = {}
    mp = pytest.MonkeyPatch()
    mesh.init(jax.devices()[:1])
    try:
        for case, (_, _, _, legacy) in CASES.items():
            if legacy:
                mp.setenv("H2O3_EST_LEGACY", "1")
            try:
                out[case] = _fit_pair(case)
            finally:
                mp.delenv("H2O3_EST_LEGACY", raising=False)
    finally:
        mesh.reset()
        mp.undo()
    return out


def _pred_cols(frame, family):
    names = frame.names[1:] if family in ("binomial", "quasibinomial") \
        else frame.names
    return {n: np.asarray(frame.vec(n).data, np.float64) for n in names}


@pytest.mark.parametrize("case", list(CASES))
def test_same_path_and_iterations(fits, case):
    f = fits[case]
    rp, pp = f["ref_plan"], f["port_plan"]
    assert pp["path"] == rp["path"]
    assert pp.get("iterations") == rp.get("iterations")
    assert pp.get("converged") == rp.get("converged")
    if CASES[case][3]:
        assert pp["path"] == "legacy"
    elif CASES[case][1].get("lambda_search"):
        assert pp["path"] == "fused_path"
    else:
        assert pp["path"] == "fused"


@pytest.mark.parametrize("case", list(CASES))
def test_coefficients_match(fits, case):
    f = fits[case]
    ref, port = f["ref"], f["port"]
    assert port._names() == ref._names()
    np.testing.assert_allclose(np.asarray(port.beta), np.asarray(ref.beta),
                               rtol=1e-4, atol=1e-4)
    rc, pc = ref.coef(), port.coef()
    assert list(pc) == list(rc)
    np.testing.assert_allclose(list(pc.values()), list(rc.values()),
                               rtol=1e-4, atol=1e-4)
    assert port.lambda_best == pytest.approx(ref.lambda_best, rel=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_predictions_and_metrics_match(fits, case):
    f = fits[case]
    got, want = _pred_cols(f["port_pred"], f["family"]), \
        _pred_cols(f["ref_pred"], f["family"])
    assert f["port_pred"].names == f["ref_pred"].names
    for col in want:
        np.testing.assert_allclose(got[col], want[col], rtol=1e-5, atol=1e-5,
                                   err_msg=col)
    ref, port = f["ref"], f["port"]
    if f["family"] in ("binomial", "quasibinomial"):
        assert port.auc() == pytest.approx(ref.auc(), abs=1e-5)
        assert port.logloss() == pytest.approx(ref.logloss(), abs=1e-5)
    assert port.rmse() == pytest.approx(ref.rmse(), rel=1e-5)
    if ref.validation_metrics is not None:
        assert port.rmse(valid=True) == pytest.approx(ref.rmse(valid=True),
                                                      rel=1e-5)


@pytest.mark.parametrize("case", ["lambda_search", "lambda_search_valid",
                                  "legacy_lambda_search"])
def test_lambda_path_matches(fits, case):
    """The same λ grid, the same λ chosen (by validation deviance where a
    validation frame is given), and each λ's f32 path β within 1e-4."""
    f = fits[case]
    rpath = RefGLM.getGLMRegularizationPath(f["ref"])
    ppath = H2OGeneralizedLinearEstimator.getGLMRegularizationPath(f["port"])
    np.testing.assert_allclose(ppath["lambdas"], rpath["lambdas"], rtol=1e-5)
    best = [int(np.argmin(np.abs(np.asarray(p["lambdas"]) - m.lambda_best)))
            for p, m in ((rpath, f["ref"]), (ppath, f["port"]))]
    assert best[0] == best[1]
    for pc, rc in zip(ppath["coefficients"], rpath["coefficients"]):
        assert list(pc) == list(rc)
        np.testing.assert_allclose(list(pc.values()), list(rc.values()),
                                   rtol=1e-4, atol=1e-4)
    if not CASES[case][3]:
        plan = f["port"].fitplan
        assert plan["best_index"] == best[1]
        assert np.argmin(plan["path_deviances"]) == best[1]
        assert plan["ista_steps"] == 500 * plan["irls_iterations"]


def test_validation_selects_a_larger_lambda(fits):
    f = fits["lambda_search_valid"]
    assert f["port"].lambda_best > 0
    assert len(f["port"].full_path) == 10


@pytest.mark.parametrize("case", ["pvalues_binomial", "pvalues_gamma"])
def test_p_values_match(fits, case):
    f = fits[case]
    rt, pt = f["ref"].coef_with_p_values(), f["port"].coef_with_p_values()
    assert [r["names"] for r in pt] == [r["names"] for r in rt]
    for key in ("coefficients", "std_error", "z_value"):
        np.testing.assert_allclose([r[key] for r in pt], [r[key] for r in rt],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose([r["p_value"] for r in pt],
                               [r["p_value"] for r in rt], rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(f["port"].stderr, f["ref"].stderr, rtol=1e-4)
    assert all(np.isfinite(f["port"].stderr))


def test_p_values_need_lambda_zero(fits):
    with pytest.raises(ValueError, match="compute_p_values"):
        fits["binomial"]["port"].coef_with_p_values()


@pytest.mark.parametrize("case", ["binomial", "lasso"])
def test_varimp_and_summary_match(fits, case):
    ref, port = fits[case]["ref"], fits[case]["port"]
    rv, pv = ref.varimp(), port.varimp()
    assert [r[0] for r in pv] == [r[0] for r in rv]
    np.testing.assert_allclose([r[1] for r in pv], [r[1] for r in rv],
                               rtol=1e-4, atol=1e-5)
    rs, ps = ref.summary(), port.summary()
    for k in ("family", "number_of_predictors_total",
              "number_of_active_predictors", "lambda_"):
        assert ps[k] == rs[k], k


@pytest.mark.parametrize("case", ["binomial", "poisson", "tweedie"])
def test_glm_from_numpy_predicts_like_the_jax_model(fits, case):
    f = fits[case]
    ref = f["ref"]
    di = ref.dinfo
    model = convert.glm_from_numpy(
        beta=np.asarray(ref.beta), family=ref.family, x=ref.x, y=ref.y,
        spec=di._spec, coef_names=di.coef_names, means=di.means,
        stds=di.stds, col_means=di.col_means,
        transfer_groups=di._transfer_groups, standardize=di.standardize,
        use_all=di.use_all, domain=ref.domain, device="cpu")
    got = _pred_cols(model.predict(f["pt"]), f["family"])
    want = _pred_cols(f["ref_pred"], f["family"])
    for col in want:
        np.testing.assert_allclose(got[col], want[col], rtol=1e-6, atol=1e-6)


def test_glm_from_numpy_checks_its_input(fits):
    ref = fits["binomial"]["ref"]
    di = ref.dinfo
    kw = dict(family="binomial", x=ref.x, y=ref.y, spec=di._spec,
              coef_names=di.coef_names, means=di.means, stds=di.stds,
              col_means=di.col_means, domain=ref.domain, device="cpu")
    with pytest.raises(ValueError, match="beta"):
        convert.glm_from_numpy(beta=np.zeros(3), **kw)
    with pytest.raises(ValueError, match="family"):
        convert.glm_from_numpy(beta=np.asarray(ref.beta),
                               **dict(kw, family="multinomial"))


@pytest.mark.parametrize("case", [c for c, v in CASES.items()
                                  if not v[3] and "lambda_search" not in v[1]])
def test_last_step_is_far_from_beta_eps(fits, case):
    """The fixtures stop clear of β_eps (1e-4): the fused loop's last Δβ
    lies below 0.9·β_eps and the step before above 1.1·β_eps (or the fit is
    a single solve). That margin, 1e-5, is ten times the largest difference
    between the two packages' β on these fixtures (≈1e-6), so both stop at
    the same iteration."""
    deltas = fits[case]["port"].fitplan["deltas"]
    if len(deltas) == 1:          # gaussian with α·λ = 0: one solve
        assert CASES[case][0] == "gaussian"
        return
    assert deltas[-1] < 0.9e-4 and deltas[-2] > 1.1e-4


@pytest.mark.parametrize("family", ["multinomial", "AUTO"])
def test_multinomial_raises_naming_its_item(family):
    """A multinomial fit (family or AUTO on three classes) with
    `lambda_search`, which the reference's multinomial fit ignores,
    raises naming item 8 (`tests/test_torch_glm_multinomial.py` holds
    the fit itself and the other ignored parameters)."""
    rng = np.random.default_rng(0)
    fr = Frame.from_dict({"a": rng.normal(size=60),
                          "y": np.asarray(["p", "q", "r"], dtype=object)[
                              rng.integers(0, 3, 60)]},
                         column_types={"y": "enum"})
    with pytest.raises(NotImplementedError,
                       match="queue A, item 8: multinomial GLM"):
        H2OGeneralizedLinearEstimator(family=family, lambda_search=True,
                                      device="cpu").train(
            y="y", training_frame=fr)


@pytest.mark.parametrize("kw,msg", [(dict(alpha=1.5), "alpha"),
                                    (dict(lambda_=-1.0), "lambda"),
                                    (dict(family="nope"), "family")])
def test_bad_parameters_raise_like_the_reference(kw, msg):
    d, types = glm_frame(50, 0, "gaussian")
    fr = Frame.from_dict(d, column_types=types)
    rfr = RefFrame.from_dict(d, column_types=types)
    with pytest.raises(ValueError, match=msg) as pe:
        H2OGeneralizedLinearEstimator(device="cpu", **kw).train(
            y="y", training_frame=fr)
    with pytest.raises(ValueError, match=msg) as re_:
        RefGLM(**kw).train(y="y", training_frame=rfr)
    assert str(pe.value) == str(re_.value)


def test_defaults_match_the_reference():
    assert H2OGeneralizedLinearEstimator._param_defaults == \
        RefGLM._param_defaults
    assert glm.FAMILIES == refglm.FAMILIES


@pytest.mark.parametrize("family", ["binomial", "poisson", "gamma",
                                    "tweedie", "gaussian"])
@pytest.mark.parametrize("tp", [1.0, 1.5, 2.0])
def test_device_math_matches_the_reference(family, tp):
    """Deviance (device and host forms), IRLS weights, the Gram step and the
    Pearson sums on the same f32 inputs."""
    rng = np.random.default_rng(3)
    n, p = 300, 6
    X = rng.normal(size=(n, p)).astype(np.float32)
    beta = (0.2 * rng.normal(size=p)).astype(np.float32)
    w = rng.uniform(0.5, 2, n).astype(np.float32)
    if family == "binomial":
        y = (rng.random(n) < 0.4).astype(np.float32)
    elif family == "gaussian":
        y = rng.normal(size=n).astype(np.float32)
    else:
        y = rng.gamma(2.0, 1.0, n).astype(np.float32)
        y[::7] = 0.0 if family in ("poisson", "tweedie") else y[::7]
    Xt, yt, wt, bt = (torch.from_numpy(a) for a in (X, y, w, beta))
    jx = [jax.numpy.asarray(a) for a in (X, y, w, beta)]
    mu = 1 / (1 + np.exp(-(X @ beta))) if family == "binomial" \
        else np.exp(X @ beta)
    np.testing.assert_allclose(
        glm._family_deviance_sum(family, y.astype(np.float64), mu,
                                 w.astype(np.float64), tp, xp=np),
        refglm._family_deviance_sum(family, y.astype(np.float64), mu,
                                    w.astype(np.float64), tp, xp=np),
        rtol=1e-12)
    np.testing.assert_allclose(
        float(glm._deviance_device(Xt, yt, wt, bt, family, tp)),
        float(refglm._deviance_device(*jx, family, tp)), rtol=1e-5)
    g, xy = glm._gram_step(Xt, yt, wt, bt, family, tp)
    rg, rxy = refglm._gram_step(*jx, family, tp)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(xy.numpy(), np.asarray(rxy), rtol=1e-5,
                               atol=1e-3)
    ps, pw = glm._pearson_sums(Xt, yt, wt, bt, family, tp)
    rs, rw = refglm._pearson_sums(*jx, family, tp)
    np.testing.assert_allclose(float(ps), float(rs), rtol=1e-5)
    np.testing.assert_allclose(float(pw), float(rw), rtol=1e-6)


@pytest.mark.parametrize("lam,alpha,nonneg", [(0.0, 0.5, False),
                                              (0.01, 0.0, False),
                                              (0.01, 1.0, False),
                                              (0.002, 0.5, True),
                                              (0.0, 0.0, True)])
def test_penalized_solves_match_the_reference(lam, alpha, nonneg):
    """The device solve (LU, or 500 ISTA steps with no early exit) and the
    host f64 solve (early exit at 1e-9) on one Gram, against the
    reference's `_solve_pen_device` and `_solve_penalized`."""
    rng = np.random.default_rng(5)
    n, p = 400, 8
    X = np.column_stack([rng.normal(size=(n, p - 1)), np.ones(n)]).astype(
        np.float32)
    y = (X[:, :3] @ np.asarray([1.0, -0.5, 0.25]) + rng.normal(size=n)).astype(
        np.float32)
    gram, xy = (X.T @ X).astype(np.float32), (X.T @ y).astype(np.float32)
    b0 = np.zeros(p, np.float32)
    mask = np.ones(p, np.float32)
    mask[-1] = 0
    got = glm._solve_pen_device(torch.from_numpy(gram), torch.from_numpy(xy),
                                lam, alpha, float(n), torch.from_numpy(mask),
                                torch.from_numpy(b0), nonneg).numpy()
    jnp = jax.numpy
    want = np.asarray(refglm._solve_pen_device(
        jnp.asarray(gram), jnp.asarray(xy), jnp.float32(lam),
        jnp.float32(alpha), jnp.float32(n), jnp.asarray(mask),
        jnp.asarray(b0), nonneg))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if nonneg:
        assert (got[:-1] >= 0).all()
    g64, xy64 = gram.astype(np.float64), xy.astype(np.float64)
    np.testing.assert_array_equal(
        glm._solve_penalized(g64, xy64, lam, alpha, n, p - 1,
                             b0.astype(np.float64), nonneg),
        refglm._solve_penalized(g64, xy64, lam, alpha, n, p - 1,
                                b0.astype(np.float64), nonneg))


def test_beta_from_sums_matches_the_reference():
    for fam in ("binomial", "poisson", "gamma", "tweedie", "gaussian",
                "fractionalbinomial"):
        for wy, n in ((30.0, 100.0), (0.0, 10.0), (10.0, 10.0)):
            np.testing.assert_array_equal(
                H2OGeneralizedLinearEstimator._beta_from_sums(wy, n, fam, 4),
                RefGLM._beta_from_sums(wy, n, fam, 4))


def test_fit_records_its_plan_and_timings(fits):
    port = fits["binomial"]["port"]
    assert port.fitplan["path"] == "fused"
    assert set(port.fit_timings) == {"pack_s", "h2d_s", "expand_s", "irls_s",
                                     "pvalues_s", "metrics_s", "total_s"}
    stats = est.est_stats()
    assert stats["dispatch"].get("glm/fused", 0) >= 1
    assert stats["iterations"].get("glm", 0) >= 1
    assert port.device == torch.device("cpu")


# -- the port's own fused loop against its host loop (the reference's
# tests/test_estimator_engine.py matrix) -------------------------------------

ENGINE_CASES = [("gaussian", 0.1, 0.0), ("gaussian", 0.05, 1.0),
                ("binomial", 0.1, 0.0), ("binomial", 0.05, 1.0),
                ("poisson", 0.1, 0.0), ("poisson", 0.05, 1.0),
                ("tweedie", 0.1, 0.0), ("tweedie", 0.05, 1.0)]


def _engine_frame(family, n=1500, f=5):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, f))
    eta = X @ np.linspace(1.5, -1.5, f)
    if family == "binomial":
        y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(float)
    elif family == "poisson":
        y = rng.poisson(np.exp(np.clip(eta / 3, -3, 3))).astype(float)
    elif family == "tweedie":
        y = np.abs(eta) + rng.random(n)
    else:
        y = eta + 0.1 * rng.normal(size=n)
    fr = Frame.from_numpy(np.column_stack([X, y]),
                          names=[f"x{i}" for i in range(f)] + ["y"])
    return fr.asfactor("y") if family == "binomial" else fr


@pytest.mark.parametrize("family,lam,alpha", ENGINE_CASES)
def test_fused_matches_the_host_loop(monkeypatch, family, lam, alpha):
    """The fused loop (f32 solves on the device) reproduces the host f64
    loop's coefficients within the reference's own bound, 5e-3 of the
    largest (tests/test_estimator_engine.py)."""
    fr = _engine_frame(family)

    def coefs(legacy):
        if legacy:
            monkeypatch.setenv("H2O3_EST_LEGACY", "1")
        g = H2OGeneralizedLinearEstimator(family=family, lambda_=lam,
                                          alpha=alpha, device="cpu")
        g.train(y="y", training_frame=fr)
        return np.asarray(list(g.coef().values())), g.model.fitplan

    fused, plan = coefs(False)
    assert plan["path"] == "fused" and plan["converged"]
    legacy, lplan = coefs(True)
    assert lplan["path"] == "legacy"
    assert np.abs(fused - legacy).max() < 5e-3 * max(np.abs(legacy).max(),
                                                    1e-3)


def test_fused_divergence_falls_back_to_the_host_loop(monkeypatch):
    """A non-finite f32 β sends the fit to the f64 host loop, and the plan
    says so (no hidden fallback): the β is the host loop's, to the bit."""
    fr = _engine_frame("binomial")
    monkeypatch.setenv("H2O3_EST_LEGACY", "1")
    want = H2OGeneralizedLinearEstimator(family="binomial", lambda_=0.0,
                                         device="cpu")
    want.train(y="y", training_frame=fr)
    monkeypatch.delenv("H2O3_EST_LEGACY")
    monkeypatch.setattr(glm, "_solve_pen_device",
                        lambda gram, xy, *a: torch.full_like(xy, float("nan")))
    got = H2OGeneralizedLinearEstimator(family="binomial", lambda_=0.0,
                                        device="cpu")
    got.train(y="y", training_frame=fr)
    assert got.model.fitplan["path"] == "host_fallback"
    assert est.est_stats()["plans"][-1]["path"] == "host_fallback"
    np.testing.assert_array_equal(got.model.beta, want.model.beta)


def test_path_divergence_guard_skips_the_lambda(monkeypatch):
    """A λ whose f32 IRLS diverges restarts the warm start from zero and
    gets an infinite deviance, so it is never chosen; the other λ are
    unaffected."""
    fr = _engine_frame("gaussian")
    kw = dict(family="gaussian", lambda_search=True, alpha=0.5, nlambdas=6,
              device="cpu")
    clean = H2OGeneralizedLinearEstimator(**kw)
    clean.train(y="y", training_frame=fr)
    lams = [lv for lv, _ in clean.model.full_path]
    solve = glm._solve_pen_device

    def poisoned(gram, xy, lam, *a):
        out = solve(gram, xy, lam, *a)
        return out * float("nan") if lam == np.float32(lams[-1]) else out

    monkeypatch.setattr(glm, "_solve_pen_device", poisoned)
    g = H2OGeneralizedLinearEstimator(**kw)
    g.train(y="y", training_frame=fr)
    devs = g.model.fitplan["path_deviances"]
    assert np.isinf(devs[-1]) and np.isfinite(devs[:-1]).all()
    assert not g.model.full_path[-1][1].any()            # reset to zero
    np.testing.assert_array_equal(devs[:-1],
                                  clean.model.fitplan["path_deviances"][:-1])
    assert g.model.fitplan["best_index"] == int(np.argmin(devs[:-1]))
