"""Multinomial GLM of the port against the reference's, on the CPU.

Seeded frames (three numeric columns, `a` with 3 % NaN; a string enum of
four levels where a case asks for it; labels drawn from a softmax over
class scores, so no class is separable) go through the JAX package on a
one-device cloud and through the port on the CPU, one fit per case: 3
classes at λ = 0, 4 classes with a ridge (α = 0, λ = 1e-3), a weights
column, 4 classes with a categorical predictor, and AUTO on a 3-class
response.

The two packages run L-BFGS with other line searches (optax's zoom search
in the reference, `torch.optim.LBFGS`'s strong-Wolfe search in the port),
so their iterates differ; what is held is the optimum. Both stop when two
successive losses differ by less than 1e-9. The reference's loss is an f32
sum: for a loss of order 1 (an ulp ≈ 6e-8) that means equal, which may
come before the gradient is small. The port sums the same f32 row terms
in f64, so it stops later, nearer the optimum. The f64 gradient norm of
the objective at each package's returned β, measured on these fixtures:
reference 3.2e-8 to 1.5e-5 (k3_auto), port 1.8e-8 to 9.1e-6; on the CV
folds 1.8e-7 to 1.3e-5 and 1.1e-7 to 7.2e-6. The coefficients are
compared after centring over classes (B − mean_k B_k: at λ = 0 a vector
added to every class leaves the softmax unchanged), against each other
and against an independent oracle, scipy's f64 L-BFGS-B of the same loss
(tol 1e-12) polished by Newton steps: measured, the reference lies 1.1e-7
to 1.2e-4 (k3_auto) from it, the port 4.9e-8 to 2.4e-5; BETA_TOL is
3e-4. Class probabilities agree within 1e-4 (measured 1.8e-7 to 7.6e-5;
the CV holdouts 4.5e-5), training logloss within 1e-5 relative (measured
≤ 3.8e-9).

Also held: no p-values (`compute_p_values` on k3_lambda0),
`coef`/`coef_norm` per class, varimp, `summary`, the `predict` frame,
training and validation metrics, `convert.glm_from_numpy` of a reference
model, the MOJO written by each package (member by member, and loaded
across), 3-fold CV holdouts and metrics, a multiclass stack (a GBM and
the CV GLM under the multinomial metalearner) with its MOJO, the serving
engine, and the raises where the reference's multinomial fit ignores a
parameter. The checks run in one test, the raises in three cases of
another: see `test_multinomial_glm_matches_the_reference`.
"""

from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import pytest
from scipy.optimize import minimize

import jax

import h2o3_tpu.estimators as ref_est
from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.parallel import mesh
import h2o3_tpu_torch.estimators as port_est
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import estimator_engine as est
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from test_torch_mojo import _members

P_TOL = 1e-4           # class probabilities, port vs reference
LOGLOSS_RTOL = 1e-5
# centred standardized β, each pair of the three fits: the reference
# stops 1.2e-4 from the optimum on k3_auto (its gradient norm 1.5e-5)
BETA_TOL = 3e-4
GRAD_TOL = 5e-5        # f64 gradient norm at a package's returned β
CLASSES = ["ash", "birch", "cedar", "dogwood"]
LEVELS = ["north", "east", "south", "west"]


def mn_frame(n, seed, K, weights=False, cat=False):
    """Numeric `a` (normal, 3 % NaN), `b` (uniform 0..4), `c` (normal),
    with `g` a four-level string enum when `cat`; the label one of the
    first K CLASSES, drawn from a softmax over class scores linear in
    them (fixed effects, so every seed draws from one law)."""
    law = np.random.default_rng(100 + K)
    W = law.normal(size=(K, 3)) * 0.6
    Wg = law.normal(size=(K, 4)) * 0.5
    rng = np.random.default_rng(seed)
    a, b, c = rng.normal(size=n), rng.uniform(0, 4, n), rng.normal(size=n)
    eta = np.column_stack([a, b - 2.0, c]) @ W.T
    g = rng.integers(0, 4, n)
    if cat:
        eta += Wg.T[g]
    y = (eta - np.log(-np.log(rng.random((n, K))))).argmax(1)   # Gumbel max
    a = a.copy()
    a[rng.random(n) < 0.03] = np.nan
    d = {"a": a, "b": b, "c": c,
         "y": np.asarray(CLASSES, dtype=object)[y]}
    types = {"y": "enum"}
    if cat:
        d["g"] = np.asarray(LEVELS, dtype=object)[g]
        types["g"] = "enum"
    if weights:
        d["w"] = rng.uniform(0.5, 2.0, n)
    return d, types


# case -> (classes, parameters, frame options, validation frame)
CASES = {
    "k3_lambda0": (3, dict(family="multinomial", lambda_=0.0,
                           compute_p_values=True), {}, False),
    "k4_ridge": (4, dict(family="multinomial", alpha=0.0, lambda_=1e-3),
                 {}, True),
    "k3_weights": (3, dict(family="multinomial", lambda_=0.0,
                           weights_column="w"), dict(weights=True), True),
    "k4_categorical": (4, dict(family="multinomial", lambda_=0.0),
                       dict(cat=True), True),
    "k3_auto": (3, {}, dict(cat=True), False),
}
N_TRAIN, N_VALID = 2000, 700


def _frames(d, types):
    return (RefFrame.from_dict(d, column_types=types),
            Frame.from_dict(d, column_types=types))


def oracle(Xd, ycodes, w, K, l2):
    """The centred f64 optimum of the reference's loss on the design
    `Xd` (intercept last), by scipy's L-BFGS-B, and the loss-and-gradient
    function."""
    n, p = Xd.shape
    Y = np.eye(K)[ycodes]

    def f(b):
        B = b.reshape(K, p)
        L = Xd @ B.T
        m = L.max(1, keepdims=True)
        lse = m[:, 0] + np.log(np.exp(L - m).sum(1))
        loss = (-np.sum(w * (np.sum(L * Y, 1) - lse)) / n
                + 0.5 * l2 * np.sum(B[:, :-1] ** 2))
        G = ((np.exp(L - lse[:, None]) - Y) * w[:, None]).T @ Xd / n
        G[:, :-1] += l2 * B[:, :-1]
        return loss, G.ravel()

    r = minimize(f, np.zeros(K * p), jac=True, method="L-BFGS-B", tol=1e-12,
                 options=dict(maxiter=20000, maxfun=40000, gtol=1e-10))
    B = r.x.reshape(K, p)
    # three Newton steps from there, least squares through the Hessian's
    # null space (the class gauge, collinear columns): an f64 optimum
    pen = np.kron(np.eye(K), np.diag(np.r_[np.ones(p - 1), 0.0])) * l2
    for _ in range(3):
        P = np.exp(Xd @ B.T)
        P /= P.sum(1, keepdims=True)
        c = w / n
        H = (np.einsum("i,ik,ia,ib->kab", c, P, Xd, Xd)[:, :, None, :]
             * np.eye(K)[:, None, :, None]
             - np.einsum("i,ik,il,ia,ib->kalb", c, P, P, Xd, Xd))
        H = H.reshape(K * p, K * p) + pen
        B = B - np.linalg.lstsq(H, f(B.ravel())[1], rcond=None)[0].reshape(
            K, p)
    return _centre(B), f


def _centre(B):
    B = np.asarray(B, np.float64)
    return B - B.mean(axis=0)


@pytest.fixture(scope="module")
def fits():
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for case, (K, params, opts, with_valid) in CASES.items():
            d, types = mn_frame(N_TRAIN, 0, K, **opts)
            rf, pf = _frames(d, types)
            rv = pv = None
            if with_valid:
                rv, pv = _frames(*mn_frame(N_VALID, 1, K, **opts))
            ref = ref_est.H2OGeneralizedLinearEstimator(**params)
            ref.train(y="y", training_frame=rf, validation_frame=rv)
            port = port_est.H2OGeneralizedLinearEstimator(device="cpu",
                                                          **params)
            port.train(y="y", training_frame=pf, validation_frame=pv)
            x = port.model.x
            _, Xd = est.design_matrix(pf, x, standardize=True,
                                      add_intercept=True, device="cpu")
            w = (d["w"] if "weights_column" in params
                 else np.ones(N_TRAIN))
            lam, alpha = params.get("lambda_", 0.0), params.get("alpha", 0.5)
            B_opt, f = oracle(Xd.numpy().astype(np.float64),
                              np.asarray(pf.vec("y").data), w, K,
                              lam * (1 - alpha))
            out[case] = dict(ref=ref.model, port=port.model, rf=rf, pf=pf,
                             rv=rv, pv=pv, B_opt=B_opt, f=f)
    finally:
        mesh.reset()
    return out


def _labels(frame):
    """The `predict` labels (codes index each frame's own domain)."""
    v = frame.vec("predict")
    return [v.domain[c] for c in np.asarray(v.data)]


def _probs(frame):
    return np.column_stack([np.asarray(frame.vec(c).data, np.float64)
                            for c in frame.names[1:]])


def _check_probabilities_and_logloss(f, case):
    got, want = f["port"].predict(f["pf"]), f["ref"].predict(f["rf"])
    np.testing.assert_allclose(_probs(got), _probs(want), rtol=0, atol=P_TOL)
    assert abs(f["port"].logloss() - f["ref"].logloss()) \
        <= LOGLOSS_RTOL * f["ref"].logloss()


def _check_centred_beta(f, case):
    """Centred β within BETA_TOL of the reference's, and each package's
    within BETA_TOL of the f64 optimum, the f64 gradient norm at its β
    below GRAD_TOL."""
    assert np.asarray(f["port"].beta).shape == np.asarray(f["ref"].beta).shape
    np.testing.assert_allclose(_centre(f["port"].beta), _centre(f["ref"].beta),
                               rtol=0, atol=BETA_TOL)
    for pkg in ("ref", "port"):
        B = np.asarray(f[pkg].beta, np.float64)
        np.testing.assert_allclose(_centre(B), f["B_opt"], rtol=0,
                                   atol=BETA_TOL, err_msg=pkg)
        assert np.linalg.norm(f["f"](B.ravel())[1]) < GRAD_TOL, pkg


def _check_fit_plan(f, case):
    """The port records its L-BFGS run: stopped by the loss rule within
    the step cap, the loss it reports the one at its β. No p-values, in
    either package: `coef_with_p_values` raises."""
    plan = f["port"].fitplan
    assert plan["path"] == "lbfgs" and plan["converged"]
    assert 1 <= plan["iterations"] <= 200
    assert plan["func_evals"] > plan["iterations"]
    loss64 = f["f"](np.asarray(f["port"].beta).ravel())[0]
    assert abs(plan["loss"] - loss64) <= 1e-6 * max(1.0, abs(loss64))
    assert f["port"].family == "multinomial" == f["ref"].family
    for pkg in ("ref", "port"):
        assert f[pkg].stderr is None
        with pytest.raises(ValueError, match="p-values unavailable"):
            f[pkg].coef_with_p_values()


def _check_coef_and_coef_norm(f, case):
    for method in ("coef", "coef_norm"):
        got, want = getattr(f["port"], method)(), getattr(f["ref"], method)()
        assert list(got) == list(want) == f["ref"].domain
        names = list(want[f["ref"].domain[0]])
        assert all(list(got[k]) == names for k in got)
        g = np.asarray([[got[k][nm] for nm in names] for k in got])
        w = np.asarray([[want[k][nm] for nm in names] for k in want])
        # de-standardizing divides the slopes by σ ≥ 0.99 on these frames
        np.testing.assert_allclose(_centre(g), _centre(w), rtol=0,
                                   atol=5 * BETA_TOL, err_msg=method)


def _check_varimp_and_summary(f, case):
    got, want = f["port"].varimp_table, f["ref"].varimp_table
    assert sorted(r[0] for r in got) == sorted(r[0] for r in want)
    wmap = {r[0]: r for r in want}
    for name, mag, rel, share in got:
        np.testing.assert_allclose([mag, rel, share], wmap[name][1:],
                                   rtol=0, atol=BETA_TOL, err_msg=name)
    sg, sw = f["port"].summary(), f["ref"].summary()
    for k in ("family", "number_of_predictors_total",
              "number_of_active_predictors", "lambda_"):
        assert sg[k] == sw[k], k


def _check_predict_frame_and_metrics(f, case):
    K = CASES[case][0]
    frames = [("train", f["pf"], f["rf"])]
    if f["pv"] is not None:
        frames.append(("valid", f["pv"], f["rv"]))
    for tag, pfr, rfr in frames:
        got, want = f["port"].predict(pfr), f["ref"].predict(rfr)
        assert got.names == want.names == ["predict"] + CLASSES[:K], tag
        assert got.vec("predict").type == "enum"
        p = _probs(got)
        np.testing.assert_allclose(p.sum(1), 1.0, rtol=0, atol=1e-6)
        # labels equal wherever the top two probabilities are apart
        top2 = np.sort(p, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * P_TOL
        lab_g, lab_w = np.asarray(_labels(got)), np.asarray(_labels(want))
        assert (lab_g[clear] == lab_w[clear]).all(), tag
        mg = f["port"].model_performance(pfr)
        mw = f["ref"].model_performance(rfr)
        assert abs(mg.logloss - mw.logloss) <= LOGLOSS_RTOL * mw.logloss
        for k in ("mean_per_class_error", "accuracy", "mse"):
            assert abs(getattr(mg, k) - getattr(mw, k)) <= 2e-3, (tag, k)
    if f["pv"] is not None:
        vg, vw = f["port"].validation_metrics, f["ref"].validation_metrics
        assert abs(vg.logloss - vw.logloss) <= LOGLOSS_RTOL * vw.logloss
        assert vg.nobs == vw.nobs == N_VALID


def _check_glm_from_numpy(f):
    """A reference model carried across predicts what it predicts; a
    β of the wrong shape for a multinomial model raises naming the
    family."""
    ref = f["ref"]
    di = ref.dinfo
    kw = dict(family="multinomial", x=ref.x, y=ref.y, spec=di._spec,
              coef_names=di.coef_names, means=di.means, stds=di.stds,
              col_means=di.col_means, standardize=di.standardize,
              use_all=di.use_all, domain=ref.domain, device="cpu")
    model = convert.glm_from_numpy(beta=np.asarray(ref.beta),
                                   transfer_groups=di._transfer_groups, **kw)
    got, want = model.predict(f["pv"]), ref.predict(f["rv"])
    assert got.names == want.names
    np.testing.assert_allclose(_probs(got), _probs(want), rtol=0, atol=1e-6)
    for bad in (np.asarray(ref.beta)[0], np.asarray(ref.beta)[:3]):
        with pytest.raises(ValueError, match="family"):
            convert.glm_from_numpy(beta=bad, **kw)


def _check_mojo(f, d):
    """Each package's artifact: members equal apart from model_id and β
    (centred within BETA_TOL); each scored by the other package's numpy
    scorer equal to the writer's scorer (f64 both), and within 1e-5 of
    the writer's model (f32)."""
    paths = dict(ref=refmojo.save_model(f["ref"], str(d), "ref.h2o3"),
                 port=mojo.save_model(f["port"], str(d), "port.h2o3"))
    ref_names, ref_meta, ref_arr = _members(paths["ref"])
    names, meta, arr = _members(paths["port"])
    assert names == ref_names == ["arrays.npz", "model.json"]
    assert meta.pop("model_id") == f["port"].model_id
    ref_meta.pop("model_id")
    assert meta == ref_meta
    assert meta["family"] == "multinomial" and meta["kind"] == "glm"
    assert sorted(arr) == sorted(ref_arr) == ["beta", "means", "stds"]
    assert arr["beta"].dtype == ref_arr["beta"].dtype == np.float64
    assert arr["beta"].shape == ref_arr["beta"].shape == (4, 3 + 3 + 1)
    np.testing.assert_allclose(_centre(arr["beta"]), _centre(ref_arr["beta"]),
                               rtol=0, atol=BETA_TOL)
    for k in ("means", "stds"):
        assert np.array_equal(arr[k], ref_arr[k])
    for writer, path in paths.items():
        got = mojo.load_model(path).predict(f["pv"])
        want = refmojo.load_model(path).predict(f["rv"])
        assert got.names == want.names == ["predict"] + CLASSES
        np.testing.assert_allclose(_probs(got), _probs(want), rtol=0,
                                   atol=1e-12, err_msg=writer)
        fitted = f[writer].predict(f["pv"] if writer == "port" else f["rv"])
        np.testing.assert_allclose(_probs(got), _probs(fitted), rtol=0,
                                   atol=1e-5, err_msg=writer)


def _check_serving(f):
    """The engine serves the port's model from 4 threads, each response
    `predict`'s columns and values, no fallback."""
    model = f["port"]
    rng = np.random.default_rng(8)
    reqs = []
    for i, n in enumerate(rng.integers(1, 120, 10)):
        d, types = mn_frame(int(n), 20 + i, 4, cat=True)
        reqs.append(Frame.from_dict({k: v for k, v in d.items() if k != "y"},
                                    column_types={"g": "enum"}))
    eng = ScoringEngine(ServingConfig())
    try:
        with ThreadPoolExecutor(max_workers=4) as ex:
            outs = list(ex.map(lambda r: eng.score("mn", model, r), reqs))
        snap = eng.snapshot()
    finally:
        eng.shutdown()
    for r, o in zip(reqs, outs):
        want = model.predict(r)
        assert o.names == want.names
        assert o.nrow == r.nrow
        np.testing.assert_allclose(_probs(o), _probs(want), rtol=0, atol=1e-6)
        assert _labels(o) == _labels(want)
    assert snap["totals"]["fallback_scores"] == 0


def _check_response_rules():
    """A numeric response with family='multinomial' raises."""
    d, _ = mn_frame(300, 5, 3)
    num = Frame.from_dict({"a": d["b"], "y": d["c"]})
    with pytest.raises(ValueError, match="categorical response"):
        port_est.H2OGeneralizedLinearEstimator(
            family="multinomial", device="cpu").train(y="y", training_frame=num)


CV = dict(nfolds=3, fold_assignment="Modulo", seed=7,
          keep_cross_validation_predictions=True)


@pytest.fixture(scope="module")
def cv_fits():
    """Per package: a 3-fold multinomial GLM and a 3-fold 4-class GBM on
    one frame (a categorical predictor, λ = 0), and their stack with the
    default metalearner."""
    d, types = mn_frame(900, 3, 4, cat=True)
    rf, pf = _frames(d, types)
    rt, pt = _frames(*mn_frame(300, 4, 4, cat=True))
    out = dict(rt=rt, pt=pt, pf=pf)
    mesh.init(jax.devices()[:1])
    try:
        for pkg, mod, fr, dev in (("ref", ref_est, rf, {}),
                                  ("port", port_est, pf,
                                   dict(device="cpu"))):
            glm = mod.H2OGeneralizedLinearEstimator(
                family="multinomial", lambda_=0.0, **CV, **dev)
            glm.train(y="y", training_frame=fr)
            gbm = mod.H2OGradientBoostingEstimator(
                ntrees=3, max_depth=2, **CV, **dev)
            gbm.train(y="y", training_frame=fr)
            se = mod.H2OStackedEnsembleEstimator(base_models=[gbm, glm],
                                                 **dev)
            se.train(y="y", training_frame=fr)
            out[pkg] = dict(glm=glm, gbm=gbm, se=se)
    finally:
        mesh.reset()
    return out


def _check_cv(cv_fits):
    """3-fold CV: the (n, K) holdouts within P_TOL, the CV metrics, each
    fold's centred β and validation logloss."""
    ref, port = cv_fits["ref"]["glm"].model, cv_fits["port"]["glm"].model
    assert port._cv_holdout_pred.shape == ref._cv_holdout_pred.shape \
        == (900, 4)
    np.testing.assert_allclose(port._cv_holdout_pred, ref._cv_holdout_pred,
                               rtol=0, atol=P_TOL)
    mg, mw = port.cross_validation_metrics, ref.cross_validation_metrics
    assert abs(mg.logloss - mw.logloss) <= LOGLOSS_RTOL * mw.logloss
    assert abs(mg.mean_per_class_error - mw.mean_per_class_error) <= 2e-3
    assert len(port.cross_validation_models) == 3
    for a, b in zip(port.cross_validation_models, ref.cross_validation_models):
        np.testing.assert_allclose(_centre(a.beta), _centre(b.beta), rtol=0,
                                   atol=BETA_TOL)
        assert abs(a.validation_metrics.logloss - b.validation_metrics.logloss) \
            <= LOGLOSS_RTOL * b.validation_metrics.logloss


def _check_stack(cv_fits, d):
    """The multiclass stack: the multinomial metalearner (no
    `non_negative`) on m{i}_p{k}, predictions within P_TOL of the
    reference's, its logloss; its artifact's children, scored by the
    port's numpy scorer within 1e-5 of the fitted stack."""
    ref, port = cv_fits["ref"]["se"], cv_fits["port"]["se"]
    meta = port.model.meta.model
    assert meta.family == "multinomial" and meta.stderr is None
    assert meta.x == ref.model.meta.model.x == [
        f"m{i}_p{k}" for i in range(2) for k in range(4)]
    assert not port.model.meta._parms["non_negative"]
    got, want = port.predict(cv_fits["pt"]), ref.predict(cv_fits["rt"])
    assert got.names == want.names == ["predict"] + CLASSES
    np.testing.assert_allclose(_probs(got), _probs(want), rtol=0, atol=P_TOL)
    assert abs(port.model.logloss() - ref.model.logloss()) \
        <= LOGLOSS_RTOL * ref.model.logloss()
    scorer = mojo.load_model(mojo.save_model(port.model, str(d), "se.h2o3"))
    assert sorted(scorer.children) == ["base0", "base1", "meta"]
    assert scorer.children["meta"].meta["family"] == "multinomial"
    art = scorer.predict(cv_fits["pt"])
    assert art.names == got.names
    np.testing.assert_allclose(_probs(art), _probs(got), rtol=0, atol=1e-5)


@contextmanager
def _named(what):
    """Prefix an assertion's message with the check and case it came
    from."""
    try:
        yield
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from e


CASE_CHECKS = (_check_probabilities_and_logloss, _check_centred_beta,
               _check_fit_plan, _check_coef_and_coef_norm,
               _check_varimp_and_summary, _check_predict_frame_and_metrics)


def test_multinomial_glm_matches_the_reference(fits, cv_fits, tmp_path):
    """Every fixture through every per-case check, then the carried
    model, both MOJOs, serving, CV and the multiclass stack. One test
    id: a new file's test count sets where pytest-xdist's loadfile
    scheduler, which orders files by their number of tests, puts it, and
    a count this low keeps every other file where it was."""
    for case in CASES:
        for check in CASE_CHECKS:
            with _named(f"{case}, {check.__name__}"):
                check(fits[case], case)
    cat = fits["k4_categorical"]
    for what, check in (("glm_from_numpy", lambda: _check_glm_from_numpy(cat)),
                        ("mojo", lambda: _check_mojo(cat, tmp_path)),
                        ("serving", lambda: _check_serving(cat)),
                        ("response rules", _check_response_rules),
                        ("cv", lambda: _check_cv(cv_fits)),
                        ("stack", lambda: _check_stack(cv_fits, tmp_path))):
        with _named(what):
            check()


@pytest.mark.parametrize("kw,what", [
    (dict(lambda_search=True), "lambda_search"),
    (dict(alpha=0.5, lambda_=1e-3), "L1 share"),
    (dict(non_negative=True), "non_negative"),
])
def test_reference_ignores_raise(kw, what):
    """Each parameter the reference's multinomial fit ignores raises,
    naming it and item 8, for family='multinomial' and for AUTO on three
    classes."""
    d, types = mn_frame(60, 0, 3)
    fr = Frame.from_dict(d, column_types=types)
    for family in ("multinomial", "AUTO"):
        with pytest.raises(NotImplementedError,
                           match=f"{what}.*queue A, item 8: multinomial GLM"):
            port_est.H2OGeneralizedLinearEstimator(
                family=family, device="cpu", **kw).train(
                    y="y", training_frame=fr)
