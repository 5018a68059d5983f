"""The tree models' explanation outputs through both packages:
`predict_contributions` (TreeSHAP), `predict_leaf_node_assignment`,
`feature_frequencies` and `staged_predict_proba`.

Two kinds of model. Carried across: a model trained by the JAX package,
its forest and covers read out as numpy and built in the port with
`convert.forest_from_numpy`, so both packages explain the very same trees:
contributions within 1e-12 of the reference's (its native TreeSHAP sums in
another order), leaf ids, paths and feature frequencies exactly, staged
probabilities within 1e-6. Fitted: the same frame and parameters through
both packages' fits on the CPU, whose leaf values agree within ~1e-7, so
contributions agree within 1e-5.

The scoring frame pins the routing TreeSHAP and leaf assignment use: f64
rows against f32 thresholds widened to f64. A frame keeps a numeric
column in f32 unless a magnitude passes 2^24, so two columns carry one
such row and keep f64 values set exactly on a threshold and one f64 ulp
above it (the ulp routes right; rounded to f32 it would route left).
"""

import numpy as np
import pytest

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame

F = 4
NAMES = [f"f{i}" for i in range(F)] + ["y"]

CASES = {
    "gbm": (RefGBM, H2OGradientBoostingEstimator,
            dict(ntrees=8, max_depth=4, seed=42), "binomial"),
    "gbm_gaussian": (RefGBM, H2OGradientBoostingEstimator,
                     dict(ntrees=6, max_depth=4, seed=42), "regression"),
    "drf": (RefDRF, H2ORandomForestEstimator,
            dict(ntrees=6, max_depth=5, seed=42), "binomial"),
    "drf_regression": (RefDRF, H2ORandomForestEstimator,
                       dict(ntrees=5, max_depth=5, seed=42), "regression"),
}


def _data(n, seed, problem):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    logit = 1.5 * X[:, 0] - 0.8 * X[:, 1] + 0.3 * X[:, 0] * X[:, 2]
    if problem == "binomial":
        y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    else:
        y = logit + 0.1 * rng.normal(size=n)
    return np.column_stack([X, y])


def _frames(d, problem):
    rf, pf = RefFrame.from_numpy(d, names=NAMES), Frame.from_numpy(d, names=NAMES)
    if problem == "binomial":
        rf, pf = rf.asfactor("y"), pf.asfactor("y")
    return rf, pf


def _pinned_rows(model, seed):
    """48 scoring rows: 10 % NaN, and in columns 0 and 1 values exactly on
    the forest's split thresholds of those features and one f64 ulp above
    them; row 0 holds 2^25 in both, so their Vecs stay f64."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(48, F))
    X[rng.random(X.shape) < 0.1] = np.nan
    feat = np.asarray(model.forest[0].feat)
    thr = np.asarray(model.forest[0].thr)
    split = np.asarray(model.forest[0].is_split)
    for j in (0, 1):
        t = thr[split & (feat == j)].astype(np.float64)
        if t.size:
            X[1::2, j] = t[rng.integers(0, t.size, 24)]
            X[2::4, j] = np.nextafter(X[2::4, j], np.inf)
    X[0, :2] = 2.0 ** 25
    return np.column_stack([X, np.zeros(48)])


@pytest.fixture(scope="module")
def fits():
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for case, (Ref, Port, params, problem) in CASES.items():
            rf, pf = _frames(_data(1200, 0, problem), problem)
            ref = Ref(**params)
            ref.train(y="y", training_frame=rf)
            port = Port(device="cpu", **params)
            port.train(y="y", training_frame=pf)
            m = ref.model
            carried = convert.forest_from_numpy(
                **{f: np.asarray(getattr(m.forest[0], f))
                   for f in ("feat", "bin", "thr", "is_split", "value")},
                covers=np.asarray(m.covers[0]), f0=m.f0, edges=m.bm.edges,
                max_depth=m.max_depth, x=m.x, y=m.y, nbins=m.bm.nbins,
                domain=m.domain, problem=m.problem,
                distribution=m.distribution, mode=m.mode, device="cpu")
            rows = _pinned_rows(m, 1)
            rt, pt = (RefFrame.from_numpy(rows, names=NAMES),
                      Frame.from_numpy(rows, names=NAMES))
            out[case] = dict(ref=ref, port=port, carried=carried, rt=rt, pt=pt)
    finally:
        mesh.reset()
    return out


def _col(fr, name):
    v = fr.vec(name)
    if v.type == "enum":
        return np.asarray(v.domain, dtype=object)[np.asarray(v.data)]
    if v.type == "string":
        return np.asarray(v.to_numpy(), dtype=object)
    return np.asarray(v.data, np.float64)


def test_scoring_frame_keeps_f64_values(fits):
    fx = fits["gbm"]
    for j in (0, 1):
        assert fx["pt"].vec(f"f{j}").data.dtype == np.float64
        assert fx["rt"].vec(f"f{j}").data.dtype == np.float64


OPTIONS = [("Original", 0, 0, False), ("Compact", 0, 0, False),
           ("Original", 2, 1, False), ("Original", -1, -1, True),
           ("Original", 1, 0, True), ("Original", 0, 3, False)]


@pytest.mark.parametrize("opt", OPTIONS, ids=lambda o: "-".join(map(str, o)))
@pytest.mark.parametrize("case", list(CASES))
def test_carried_contributions_match_reference(fits, case, opt):
    fmt, top, bottom, cabs = opt
    fx = fits[case]
    want = fx["ref"].model.predict_contributions(
        fx["rt"], output_format=fmt, top_n=top, bottom_n=bottom,
        compare_abs=cabs)
    got = fx["carried"].predict_contributions(
        fx["pt"], output_format=fmt, top_n=top, bottom_n=bottom,
        compare_abs=cabs)
    assert got.names == want.names
    for n in want.names:
        a, b = _col(got, n), _col(want, n)
        if n.startswith(("top_feature", "bottom_feature")):
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_fitted_contributions_agree(fits, case):
    fx = fits[case]
    want = fx["ref"].predict_contributions(fx["rt"])
    got = fx["port"].predict_contributions(fx["pt"])
    assert got.names == want.names == [f"f{i}" for i in range(F)] + ["BiasTerm"]
    C = np.column_stack([_col(got, n) for n in got.names])
    W = np.column_stack([_col(want, n) for n in want.names])
    np.testing.assert_allclose(C, W, rtol=0, atol=1e-5)
    # local accuracy: Σφ + BiasTerm is the raw margin (DRF: the average)
    m = fx["port"].model
    margins = m._margins(m._matrix(fx["pt"]))[:, 0]
    if m.mode == "drf":
        margins = margins / m.ntrees_built
    np.testing.assert_allclose(C.sum(axis=1), margins, rtol=0, atol=1e-5)
    assert np.all(C[:, -1] == C[0, -1])


@pytest.mark.parametrize("case", ["gbm", "drf"])
def test_bias_term_computed_once_per_forest(fits, case, monkeypatch):
    """The model keeps its bias term: a second call computes no forest
    expectation, and a new forest or covers object computes it anew, to
    the same bits as `forest_bias` on that forest."""
    from h2o3_tpu_torch.models import tree_shap as ts

    m = fits[case]["carried"]
    m.__dict__.pop("_shap_bias_of", None)
    calls = []
    real = ts.forest_bias
    monkeypatch.setattr(ts, "forest_bias",
                        lambda *a: calls.append(a) or real(*a))
    first = _col(m.predict_contributions(fits[case]["pt"]), "BiasTerm")
    again = _col(m.predict_contributions(fits[case]["pt"]), "BiasTerm")
    assert len(calls) == 1
    np.testing.assert_array_equal(first, again)
    scale = 1.0 / m.ntrees_built if m.mode == "drf" else 1.0
    assert m._shap_bias(scale) == real(m.forest[0], m.covers[0], scale)
    old = m.covers
    try:
        m.covers = [old[0].clone()]
        m._shap_bias(scale)
        assert len(calls) == 2
    finally:
        m.covers = old


@pytest.mark.parametrize("case", list(CASES))
def test_replay_plan_equals_plain_on_fitted_models(fits, case):
    """The kernel's algorithm in torch (`tree_shap_replay_plain` over
    `build_shap_plan`) gives `tree_shap_plain`'s bits on the fitted and
    the carried models' forests."""
    import torch

    from h2o3_tpu_torch.models import tree_shap as ts

    fx = fits[case]
    for m in (fx["port"].model, fx["carried"]):
        X = m._rows_f64(fx["pt"])
        scale = 1.0 / m.ntrees_built if m.mode == "drf" else 1.0
        bias = m._shap_bias(scale)
        plan = ts.build_shap_plan(m.forest[0], m.covers[0], X.shape[1])
        want = ts.tree_shap_plain(m.forest[0], m.covers[0], X, scale, bias)
        got = ts.tree_shap_replay_plain(plan, X, scale, bias)
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("case", ["gbm", "drf"])
def test_shap_plan_built_once_per_forest(fits, case):
    """The model keeps its path plan: built at the first call, then the
    same one, the memory ledger grown by its bytes; a new covers object or
    another feature count builds it anew. On the CPU `predict_contributions`
    runs the plain version and builds none."""
    from h2o3_tpu_torch.models import tree_shap as ts
    from h2o3_tpu_torch.runtime import memory_ledger

    m = fits[case]["carried"]
    m.__dict__.pop("_shap_plan_of", None)
    before = ts.plan_builds
    m.predict_contributions(fits[case]["pt"])
    assert ts.plan_builds == before
    host0, dev0 = memory_ledger.measure(m)
    plan = m._shap_plan(F)
    assert m._shap_plan(F) is plan
    assert ts.plan_builds == before + 1
    host1, dev1 = memory_ledger.measure(m)
    assert (host1 - host0, dev1 - dev0) == (plan.nbytes(), 0)
    old = m.covers
    try:
        m.covers = [old[0].clone()]
        assert m._shap_plan(F) is not plan
        assert ts.plan_builds == before + 2
        assert m._shap_plan(F + 1).n_feat == F + 1
        assert ts.plan_builds == before + 3
    finally:
        m.covers = old
        m.__dict__.pop("_shap_plan_of", None)


def test_contributions_raise_for_multinomial_and_offset():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, F))
    y = np.argmax(X[:, :3], axis=1).astype(np.float64)
    fr = Frame.from_numpy(np.column_stack([X, y]), names=NAMES).asfactor("y")
    est = H2OGradientBoostingEstimator(ntrees=2, max_depth=2, device="cpu")
    est.train(y="y", training_frame=fr)
    with pytest.raises(ValueError, match="multinomial"):
        est.predict_contributions(fr)
    d = _data(300, 4, "regression")
    fo = Frame.from_numpy(np.column_stack([d, np.full(300, 0.5)]),
                          names=NAMES + ["off"])
    est = H2OGradientBoostingEstimator(ntrees=2, max_depth=2, device="cpu",
                                       offset_column="off")
    est.train(y="y", training_frame=fo)
    with pytest.raises(ValueError, match="offset_column"):
        est.predict_contributions(fo)
    with pytest.raises(ValueError, match="output_format"):
        H2OGradientBoostingEstimator(ntrees=1, device="cpu").train(
            y="y", training_frame=fo).predict_contributions(fo, "Wide")


@pytest.mark.parametrize("kind", ["Path", "Node_ID"])
@pytest.mark.parametrize("case", list(CASES))
def test_carried_leaf_assignment_exact(fits, case, kind):
    fx = fits[case]
    want = fx["ref"].model.predict_leaf_node_assignment(fx["rt"], type=kind)
    got = fx["carried"].predict_leaf_node_assignment(fx["pt"], type=kind)
    assert got.names == want.names
    assert got.names == [f"T{t + 1}.C1" for t in range(fx["carried"].ntrees_built)]
    for n in want.names:
        assert got.vec(n).type == want.vec(n).type
        np.testing.assert_array_equal(_col(got, n), _col(want, n))


@pytest.mark.parametrize("case", ["gbm", "drf"])
def test_leaf_paths_decode_to_node_ids(fits, case):
    fx = fits[case]
    paths = fx["port"].predict_leaf_node_assignment(fx["pt"])
    ids = fx["port"].predict_leaf_node_assignment(fx["pt"], type="Node_ID")
    for n in ids.names:
        for p, i in zip(_col(paths, n), _col(ids, n)):
            node = 0
            for step in p:
                node = 2 * node + (1 if step == "L" else 2)
            assert node == i


@pytest.mark.parametrize("case", list(CASES))
def test_carried_feature_frequencies_exact(fits, case):
    fx = fits[case]
    want = fx["ref"].model.feature_frequencies(fx["rt"])
    got = fx["carried"].feature_frequencies(fx["pt"])
    assert got.names == want.names == [f"f{i}" for i in range(F)]
    for n in want.names:
        np.testing.assert_array_equal(_col(got, n), _col(want, n))


def test_carried_staged_predict_proba(fits):
    fx = fits["gbm"]
    want = fx["ref"].model.staged_predict_proba(fx["rt"])
    got = fx["carried"].staged_predict_proba(fx["pt"])
    assert got.names == want.names == [f"T{t + 1}" for t in range(8)]
    for n in want.names:
        np.testing.assert_allclose(_col(got, n), _col(want, n), rtol=0,
                                   atol=1e-6)
    p1 = _col(fx["carried"].predict(fx["pt"]), "1")
    np.testing.assert_allclose(_col(got, "T8"), p1, rtol=0, atol=1e-6)


def test_staged_predict_proba_through_the_estimator(fits):
    fx = fits["gbm"]
    got = fx["port"].staged_predict_proba(fx["pt"])
    want = fx["ref"].staged_predict_proba(fx["rt"])
    for n in want.names:
        np.testing.assert_allclose(_col(got, n), _col(want, n), rtol=0,
                                   atol=1e-5)
    for case in ("drf", "gbm_gaussian"):
        with pytest.raises(ValueError, match="binomial boosting"):
            fits[case]["port"].staged_predict_proba(fits[case]["pt"])
