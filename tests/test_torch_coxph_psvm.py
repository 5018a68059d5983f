"""CoxPH and PSVM of the port against the reference's, on the CPU.

The same numpy-seeded frames go through the JAX package on a one-device
cloud and through the port with `device="cpu"`:

- CoxPH under Efron and Breslow, with a start column, with strata, and on
  categorical covariates only (many tied linear predictors): the tie
  structure equal to the reference's run loop; the partial
  log-likelihood, gradient and Hessian within ORACLE_TOL = 1e-10
  (relative) of an f64 numpy oracle (the reference's loop over tie groups
  with f64 cumulative sums) at β = 0 and at the fitted β; β within
  BETA_TOL = 1e-5 of the reference's (which sums its risk sets in f32),
  the standard errors within SE_TOL = 1e-5 relative, the log-likelihoods
  within LL_TOL = 1e-6 relative; the concordance bit-equal, both on the
  same linear predictor and from each package's own fit;
- PSVM with the gaussian kernel on a ring and the linear kernel on a
  half-plane: W and b bit-equal; the decision function within
  DECISION_TOL = 5e-3·max(1, |f|) and β within BETA_PSVM_TOL = 5e-3
  (optax inside `jax.jit` and the port's eager Adam round differently, so
  the 1e-7 relative stop may fall a few steps apart: a CPU rehearsal of
  the ring measured 1.9e-3 and 1.5e-3, and rows permuted, which reorder
  the f32 loss sum, stopped it from 322 to 332 steps, 6.7e-4 apart; the
  linear kernel on the ring stopped at 58 or 64 steps, 1.8e-2 apart, so
  it fits the half-plane, where it runs its 1000 steps),
  the training AUC within AUC_TOL = 1e-3, `svs_count` within SVS_ROWS = 5
  rows (it sits on the 1 + sv_threshold boundary);
- 3-fold CV of both: holdouts and cross-validation metrics;
- the reference's `ValueError`s and the port's `NotImplementedError`s for
  the parameters the reference never reads;
- the `coxph` MOJO payload member for member, loading across both ways;
  PSVM's export `TypeError`, in both packages; `convert.coxph_from_numpy`
  and `convert.psvm_from_numpy`; a served batch of each equal to
  `predict` with no fallback.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import coxph as refcox
from h2o3_tpu.models import psvm as refpsvm
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import (H2OCoxProportionalHazardsEstimator,
                                       H2OSupportVectorMachineEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import coxph as pcox
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

ORACLE_TOL = 1e-10
BETA_TOL = 1e-5
SE_TOL = 1e-5
LL_TOL = 1e-6
DECISION_TOL = 5e-3
BETA_PSVM_TOL = 5e-3
AUC_TOL = 1e-3
SVS_ROWS = 5


def _frames(cols, types):
    return (RefFrame.from_dict(cols, column_types=types),
            Frame.from_dict(cols, column_types=types))


def _surv_frames(case, n=600, seed=0):
    """Exponential survival with two numeric covariates and a
    two-level group, censored, times on a 1/20 grid (tie groups of
    several events), a late-entry start column; `categorical` replaces
    the covariates by two enums of 3 and 4 levels."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    a = rng.integers(0, 3, n)
    b = rng.integers(0, 4, n)
    eta = (X @ np.array([0.8, -0.5]) if case != "categorical"
           else 0.6 * (a == 1) - 0.4 * (a == 2) + 0.3 * b)
    t = rng.exponential(1.0 / np.exp(eta))
    c = rng.exponential(2.0, n)
    time = np.ceil(np.minimum(t, c) * 20) / 20
    cols = {"x1": X[:, 0], "x2": X[:, 1],
            "a": np.asarray(["p", "q", "r"], dtype=object)[a],
            "b": np.asarray(["s", "t", "u", "v"], dtype=object)[b],
            "grp": np.asarray(["g0", "g1"], dtype=object)[
                rng.integers(0, 2, n)],
            "time": time, "event": (t <= c).astype(np.float64),
            "start": np.floor(rng.uniform(0, 0.6, n) * time * 20) / 20}
    return _frames(cols, {"a": "enum", "b": "enum", "grp": "enum"})


COX_CASES = {
    "efron": (dict(ties="efron"), ["x1", "x2"]),
    "breslow_start": (dict(ties="breslow", start_column="start"),
                      ["x1", "x2"]),
    "efron_strata_start": (dict(ties="efron", start_column="start",
                                stratify_by=["grp"]), ["x1", "x2", "grp"]),
    "categorical": (dict(ties="efron"), ["a", "b"]),
}


def _ref_loop_ties(ts):
    """The reference's run loop (`h2o3_tpu/models/coxph.py:230-241`)."""
    m = len(ts)
    tie_first = np.zeros(m, np.int64)
    tie_size = np.zeros(m, np.int64)
    last_in_tie = np.zeros(m, np.int64)
    i = 0
    while i < m:
        j = i
        while j + 1 < m and ts[j + 1] == ts[i]:
            j += 1
        tie_first[i: j + 1] = i
        tie_size[i] = j - i + 1
        last_in_tie[i: j + 1] = j
        i = j + 1
    return tie_first, tie_size, last_in_tie


def _oracle(Xs, w, ev, ts, t0, ties, beta):
    """The reference's `_partial_ll` on one stratum with f64 cumulative
    sums in place of its f32 `jnp.cumsum`: the f64 numpy oracle."""
    tie_first, tie_size, last_in_tie = _ref_loop_ties(ts)
    eta = Xs @ beta
    r = w * np.exp(eta)

    def sums(X, rr):
        return (np.cumsum(rr), np.cumsum(rr[:, None] * X, axis=0),
                np.cumsum(rr[:, None, None] * (X[:, :, None] * X[:, None, :]),
                          axis=0))

    rs0, rs1, rs2 = sums(Xs, r)
    if t0 is not None:
        sp = np.argsort(-t0, kind="mergesort")
        start_sorted = t0[sp]
        cs0, cs1, cs2 = sums(Xs[sp], r[sp])
    ev = ev.astype(bool)
    p = Xs.shape[1]
    ll, grad, hess = 0.0, np.zeros(p), np.zeros((p, p))
    for g0 in np.unique(tie_first[ev]):
        rows = np.arange(g0, g0 + tie_size[g0])
        erows = rows[ev[rows]]
        d = len(erows)
        li = last_in_tie[g0]
        s0, s1, s2 = rs0[li], rs1[li], rs2[li]
        if t0 is not None:
            k = int(np.searchsorted(-start_sorted, -ts[g0], side="right"))
            if k > 0:
                s0, s1, s2 = s0 - cs0[k - 1], s1 - cs1[k - 1], s2 - cs2[k - 1]
        sw = w[erows].sum()
        ll += (w[erows] * eta[erows]).sum()
        grad += (w[erows, None] * Xs[erows]).sum(axis=0)
        if ties == "efron" and d > 1:
            e0 = r[erows].sum()
            e1 = (r[erows, None] * Xs[erows]).sum(axis=0)
            e2 = (r[erows, None, None] * (Xs[erows][:, :, None]
                                          * Xs[erows][:, None, :])).sum(axis=0)
            for kk in range(d):
                f = kk / d
                d0, d1, d2 = s0 - f * e0, s1 - f * e1, s2 - f * e2
                ll -= (sw / d) * np.log(max(d0, 1e-300))
                grad -= (sw / d) * d1 / d0
                hess += (sw / d) * (d2 / d0 - np.outer(d1, d1) / d0**2)
        else:
            ll -= sw * np.log(max(s0, 1e-300))
            grad -= sw * s1 / s0
            hess += sw * (s2 / s0 - np.outer(s1, s1) / s0**2)
    return ll, grad, hess


def _strata(pf, x, params):
    """The reference's host preparation (`coxph.py:192-255`): per stratum
    the centred rows sorted by descending stop time, their weights,
    events, stop and start times."""
    start = params.get("start_column")
    strat = params.get("stratify_by") or []
    xs = [c for c in x if c not in ("time", start) and c not in strat]
    dinfo = pcox.DataInfo(pf, xs, standardize=False)
    X = dinfo.fit_transform(pf).astype(np.float64)
    Xc = X - X.mean(axis=0)
    t = pf.vec("time").numeric_np()
    t0 = pf.vec(start).numeric_np() if start else None
    ev = pf.vec("event").numeric_np()
    if strat:
        keys = np.zeros(len(t), np.int64)
        for c in strat:
            codes = np.asarray(pf.vec(c).data, np.int64)
            keys = keys * (codes.max() + 2) + codes
        _, strata = np.unique(keys, return_inverse=True)
    else:
        strata = np.zeros(len(t), np.int64)
    out = []
    for s in np.unique(strata):
        rows = np.nonzero(strata == s)[0]
        rows = rows[np.argsort(-t[rows], kind="mergesort")]
        out.append((Xc[rows], np.ones(len(rows)), ev[rows], t[rows],
                    t0[rows] if t0 is not None else None))
    return out, X


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(1.0, float(np.max(np.abs(b)))))


def _fit_cox(rf, pf, x, **params):
    ref = refcox.H2OCoxProportionalHazardsEstimator(stop_column="time",
                                                    **params)
    ref.train(x=x, y="event", training_frame=rf)
    port = H2OCoxProportionalHazardsEstimator(stop_column="time",
                                              device="cpu", **params)
    port.train(x=x, y="event", training_frame=pf)
    return ref, port


@pytest.mark.parametrize("case", list(COX_CASES))
def test_coxph_matches_the_reference(cloud1, case):
    params, x = COX_CASES[case]
    rf, pf = _surv_frames(case)
    ref, port = _fit_cox(rf, pf, x + (["start"] if "start_column" in params
                                      else []), **params)
    rm, pm = ref.model, port.model
    assert pm.dinfo.coef_names == rm.dinfo.coef_names
    assert pm.newton["stopped_on_step"]
    assert pm.newton["multi_event_groups"] > 0
    # the partial likelihood against the f64 oracle, at 0 and at β
    strata, X = _strata(pf, x, params)
    ties = params["ties"]
    for beta in (np.zeros(len(pm.beta)), pm.beta):
        want = [0.0, 0.0, 0.0]
        got = [0.0, 0.0, 0.0]
        bd = torch.from_numpy(beta)
        for Xs, w, ev, ts, t0 in strata:
            assert all(np.array_equal(u, v) for u, v in zip(
                pcox.tie_structure(ts), _ref_loop_ties(ts)))
            for i, v in enumerate(_oracle(Xs, w, ev, ts, t0, ties, beta)):
                want[i] = want[i] + v
            st = pcox._Stratum(Xs, w, ev, ts, t0, ties, torch.device("cpu"))
            for i, v in enumerate(st.partial_ll(bd)):
                got[i] = got[i] + v.numpy()
        for g, wv in zip(got, want):
            assert np.max(np.abs(g - wv)) <= ORACLE_TOL * max(
                1.0, float(np.max(np.abs(wv))))
    assert np.abs(pm.beta - rm.beta).max() <= BETA_TOL
    assert np.abs(pm.se_coef - rm.se_coef).max() <= SE_TOL * np.abs(
        rm.se_coef).max()
    for name in ("loglik", "loglik_null"):
        r, p = getattr(rm, name), getattr(pm, name)
        assert abs(r - p) <= LL_TOL * abs(r), name
    assert pm.n_event == rm.n_event
    # Harrell's C: bit-equal on the same lp, and from each package's fit
    t, e = pf.vec("time").numeric_np(), pf.vec("event").numeric_np()
    lp = X @ rm.beta
    assert pcox._concordance(t, e, lp, device="cpu") == refcox._concordance(
        t, e, lp)
    assert pm.concordance == rm.concordance
    # the outputs: coefficients table, predict, metrics
    tab_r, tab_p = rm.coefficients_table(), pm.coefficients_table()
    assert [r["name"] for r in tab_p] == [r["name"] for r in tab_r]
    assert max(abs(a["z_coef"] - b["z_coef"]) for a, b in zip(
        tab_p, tab_r)) <= 1e-3
    lp_r = rm.predict(rf).vec("lp").numeric_np()
    lp_p = pm.predict(pf).vec("lp").numeric_np()
    assert _rel(lp_p, lp_r) <= 1e-4
    assert pm.model_performance(pf) is pm.training_metrics
    assert pm.training_metrics.nobs == rm.training_metrics.nobs


def _svm_frames(n=400, seed=2, p=3, kind="ring"):
    """A ring in the first two of `p` numeric columns (the gaussian
    kernel's case), or the half-plane x0 + x1 > 0 (the linear kernel's,
    `tests/test_longtail3.py::test_psvm_separable`), with a categorical
    column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    y = (np.sqrt((X[:, :2] ** 2).sum(axis=1)) > 1.1 if kind == "ring"
         else X[:, 0] + X[:, 1] > 0).astype(int)
    cols = {f"x{i}": X[:, i] for i in range(p)}
    cols["c"] = np.asarray(["k", "l", "m"], dtype=object)[
        rng.integers(0, 3, n)]
    cols["y"] = np.asarray(["in", "out"], dtype=object)[y]
    return _frames(cols, {"c": "enum", "y": "enum"})


def _fit_svm(rf, pf, **params):
    ref = refpsvm.H2OSupportVectorMachineEstimator(**params)
    ref.train(y="y", training_frame=rf)
    port = H2OSupportVectorMachineEstimator(device="cpu", **params)
    port.train(y="y", training_frame=pf)
    return ref, port


def _check_decision(rm, pm, rf, pf):
    fr_, fp = rm.decision_function(rf), pm.decision_function(pf)
    assert np.max(np.abs(fp - fr_) / np.maximum(1.0, np.abs(fr_))) <= (
        DECISION_TOL)


@pytest.mark.parametrize("kernel", ["gaussian", "linear"])
def test_psvm_matches_the_reference(cloud1, kernel):
    rf, pf = _svm_frames(kind="ring" if kernel == "gaussian" else "plane")
    params = dict(kernel_type=kernel, seed=5)
    if kernel == "gaussian":
        params.update(gamma=1.0, positive_weight=2.0)
    ref, port = _fit_svm(rf, pf, **params)
    rm, pm = ref.model, port.model
    if kernel == "gaussian":
        assert pm.W.tobytes() == rm.W.tobytes()
        assert pm.b.tobytes() == rm.b.tobytes()
    else:
        assert pm.W is None and rm.W is None
    assert pm.adam["stopped_on_rule"] == (kernel == "gaussian")
    assert np.abs(pm.beta - rm.beta).max() <= BETA_PSVM_TOL
    assert abs(pm.bias - rm.bias) <= BETA_PSVM_TOL
    _check_decision(rm, pm, rf, pf)
    assert abs(pm.svs_count - rm.svs_count) <= SVS_ROWS
    assert abs(pm.training_metrics.auc - rm.training_metrics.auc) <= AUC_TOL
    rt, pt = _svm_frames(200, seed=9, kind="ring" if kernel == "gaussian"
                         else "plane")
    _check_decision(rm, pm, rt, pt)
    got, want = pm.predict(pt), rm.predict(rt)
    assert got.names == want.names == ["predict", "decision_function"]
    lab_p = np.asarray(got.vec("predict").data)
    lab_r = np.asarray(want.vec("predict").data)
    f = rm.decision_function(rt)
    # labels equal but where f lies within the tolerance of 0
    far = np.abs(f) > DECISION_TOL
    assert np.array_equal(lab_p[far], lab_r[far])
    if kernel == "gaussian":
        assert pm.training_metrics.auc > 0.95


@pytest.mark.parametrize("algo", ["coxph", "psvm"])
def test_cross_validation_matches_the_reference(cloud1, algo):
    if algo == "coxph":
        rf, pf = _surv_frames("efron", 500, seed=3)
        ref, port = _fit_cox(rf, pf, ["x1", "x2"], nfolds=3, seed=7)
        tol, mtol, names = 1e-4, 1e-5, ("mse", "rmse")
    else:
        rf, pf = _svm_frames(360, seed=4)
        ref, port = _fit_svm(rf, pf, nfolds=3, seed=7, gamma=1.0)
        tol, mtol, names = DECISION_TOL, AUC_TOL, ("auc",)
    rm, pm = ref.model, port.model
    assert len(pm.cross_validation_models) == len(
        rm.cross_validation_models) == 3
    a, b = rm._cv_holdout_pred, pm._cv_holdout_pred
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(a).max())
    for name in names:
        r = getattr(rm.cross_validation_metrics, name)
        p = getattr(pm.cross_validation_metrics, name)
        assert abs(r - p) <= mtol * max(1.0, abs(r)), name


def test_errors_and_unread_parameters(cloud1):
    rf, pf = _surv_frames("efron", 200)
    with pytest.raises(ValueError, match="requires stop_column"):
        refcox.H2OCoxProportionalHazardsEstimator().train(
            x=["x1"], y="event", training_frame=rf)
    with pytest.raises(ValueError, match="requires stop_column"):
        H2OCoxProportionalHazardsEstimator(device="cpu").train(
            x=["x1"], y="event", training_frame=pf)
    for bad in (dict(lre_min=5.0), dict(interactions=["x1", "x2"])):
        name = next(iter(bad))
        with pytest.raises(NotImplementedError, match=f"{name}.*item 10"):
            H2OCoxProportionalHazardsEstimator(
                stop_column="time", device="cpu", **bad).train(
                x=["x1", "x2"], y="event", training_frame=pf)
    # an unknown ties value fits Breslow, as in the reference
    odd = H2OCoxProportionalHazardsEstimator(
        stop_column="time", ties="exact", device="cpu").train(
        x=["x1", "x2"], y="event", training_frame=pf).model
    bres = H2OCoxProportionalHazardsEstimator(
        stop_column="time", ties="breslow", device="cpu").train(
        x=["x1", "x2"], y="event", training_frame=pf).model
    assert odd.beta.tobytes() == bres.beta.tobytes()
    rs, ps = _svm_frames(100)
    with pytest.raises(ValueError, match="binary categorical response"):
        refpsvm.H2OSupportVectorMachineEstimator().train(
            y="x0", training_frame=rs)
    with pytest.raises(ValueError, match="binary categorical response"):
        H2OSupportVectorMachineEstimator(device="cpu").train(
            y="x0", training_frame=ps)
    for bad in (dict(fact_threshold=1e-3), dict(feasible_threshold=0.1),
                dict(surrogate_gap_threshold=0.1), dict(mu_factor=2.0)):
        name = next(iter(bad))
        with pytest.raises(NotImplementedError, match=f"{name}.*item 10"):
            H2OSupportVectorMachineEstimator(device="cpu", **bad).train(
                y="y", training_frame=ps)


def test_mojo_convert_and_serving(cloud1, tmp_path):
    eng = ScoringEngine(ServingConfig())
    try:
        # CoxPH: the payload member for member, both ways
        rf, pf = _surv_frames("categorical", 500, seed=11)
        x = ["a", "b", "x1"]
        ref, port = _fit_cox(rf, pf, x, ties="efron")
        rm, pm = ref.model, port.model
        pp = mojo.save_model(pm, str(tmp_path), "port_cox.h2o3")
        rp = refmojo.save_model(rm, str(tmp_path), "ref_cox.h2o3")
        pn, pmeta, parr = _members(pp)
        rn, rmeta, rarr = _members(rp)
        assert pn == rn and sorted(parr) == sorted(rarr)
        assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
            k: v for k, v in rmeta.items() if k != "model_id"}
        assert np.abs(parr["beta"] - rarr["beta"]).max() <= BETA_TOL
        rt, pt = _surv_frames("categorical", 200, seed=12)
        want = refmojo.load_model(rp).predict(rt).vec("lp").numeric_np()
        assert np.array_equal(mojo.load_model(rp).predict(pt).vec(
            "lp").numeric_np(), want)
        got = mojo.load_model(pp).predict(pt).vec("lp").numeric_np()
        assert np.array_equal(refmojo.load_model(pp).predict(rt).vec(
            "lp").numeric_np(), got)
        live = pm.predict(pt).vec("lp").numeric_np()
        assert _rel(got, live) <= 1e-6      # predict rounds its design to f32
        carried = convert.coxph_from_numpy(
            beta=rm.beta, se=rm.se_coef, loglik=rm.loglik,
            loglik_null=rm.loglik_null, concordance=rm.concordance,
            n_event=rm.n_event, x=rm.x, y=rm.y, stop_col=rm.stop_col,
            spec=rm.dinfo._spec, coef_names=rm.dinfo.coef_names,
            col_means=rm.dinfo.col_means, device="cpu")
        assert np.array_equal(carried.predict(pt).vec("lp").numeric_np(),
                              rm.predict(rt).vec("lp").numeric_np())
        assert carried.coefficients_table() == rm.coefficients_table()
        sub = pt.take(np.arange(7, 150))
        served = eng.score("cox", pm, sub).vec("lp").numeric_np()
        assert np.array_equal(served, pm.predict(sub).vec("lp").numeric_np())

        # PSVM: no MOJO in either package; carried and served
        rf, pf = _svm_frames(300, seed=13)
        ref, port = _fit_svm(rf, pf, gamma=1.0, seed=3)
        rm, pm = ref.model, port.model
        with pytest.raises(TypeError, match="not a MOJO-exportable kind"):
            refmojo.save_model(rm, str(tmp_path), "ref_svm.h2o3")
        with pytest.raises(TypeError, match="not a MOJO-exportable kind"):
            mojo.save_model(pm, str(tmp_path), "port_svm.h2o3")
        carried = convert.psvm_from_numpy(
            W=rm.W, b=rm.b, beta=rm.beta, bias=rm.bias, domain=rm.domain,
            kernel=rm.kernel, svs_count=rm.svs_count, x=rm.x, y=rm.y,
            spec=rm.dinfo._spec, coef_names=rm.dinfo.coef_names,
            means=rm.dinfo.means, stds=rm.dinfo.stds,
            col_means=rm.dinfo.col_means, device="cpu")
        rt, pt = _svm_frames(200, seed=14)
        want = rm.decision_function(rt)
        assert np.max(np.abs(carried.decision_function(pt) - want)
                      / np.maximum(1.0, np.abs(want))) <= 1e-5
        sub = pt.take(np.arange(3, 180))
        served = eng.score("svm", pm, sub)
        live = pm.predict(sub)
        assert np.array_equal(served.vec("decision_function").numeric_np(),
                              live.vec("decision_function").numeric_np())
        assert np.array_equal(np.asarray(served.vec("predict").data),
                              np.asarray(live.vec("predict").data))
        assert eng.snapshot()["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()
