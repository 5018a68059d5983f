"""The slice end to end: a scaled-down `bench_gbm` (HIGGS-like frame,
`asfactor`, depth-4 UniformAdaptive GBM) through the JAX package on a
one-device cloud and through the port on the CPU. Forest structure must
match exactly; leaf values, AUC and predictions within 1e-5. A JAX model's
forest carried across with `convert.forest_from_numpy` predicts the same."""

import numpy as np
import pytest

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.frame.frame import Frame

N, F = 4000, 8
NAMES = [f"f{i}" for i in range(F)] + ["label"]


def make_higgs_like(n_rows, n_feat=F, seed=0):
    """bench.py::make_higgs_like."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    logits = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 1.5 * X[:, 2] * X[:, 3]
              + 0.7 * np.sin(3 * X[:, 4]) + 0.5 * (X[:, 5] ** 2 - 1))
    y = (rng.random(n_rows) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


PARAMS = dict(ntrees=5, max_depth=4, learn_rate=0.1,
              histogram_type="UniformAdaptive", seed=42)


@pytest.fixture(scope="module")
def fits():
    """One binomial and one regression fit per package (the reference on a
    one-device cloud: the unsharded single-fold reductions)."""
    X, y = make_higgs_like(N)
    Xt, yt = make_higgs_like(1500, seed=1)
    Xt[::37, 2] = np.nan                               # NAs at scoring time
    data = np.column_stack([X, y])
    test = np.column_stack([Xt, yt])
    yreg = (X[:, 0] * 2 + np.sin(X[:, 1] * 3)).astype(np.float32)
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for kind in ("binomial", "regression"):
            d = data if kind == "binomial" else np.column_stack([X, yreg])
            rf = RefFrame.from_numpy(d, names=NAMES)
            pf = Frame.from_numpy(d, names=NAMES)
            if kind == "binomial":
                rf, pf = rf.asfactor("label"), pf.asfactor("label")
            ref = RefGBM(**PARAMS)
            ref.train(y="label", training_frame=rf)
            port = H2OGradientBoostingEstimator(device="cpu", **PARAMS)
            port.train(y="label", training_frame=pf)
            rt = RefFrame.from_numpy(test, names=NAMES)
            pt = Frame.from_numpy(test, names=NAMES)
            if kind == "binomial":
                rt, pt = rt.asfactor("label"), pt.asfactor("label")
            out[kind] = dict(ref=ref, port=port, ref_test=rt, port_test=pt,
                             ref_pred=ref.predict(rt), port_pred=port.predict(pt))
    finally:
        mesh.reset()
    return out


@pytest.mark.parametrize("kind", ["binomial", "regression"])
def test_forest_structure_matches(fits, kind):
    ref, port = fits[kind]["ref"].model, fits[kind]["port"].model
    rf = ref.forest[0]
    pf = port.forest[0]
    assert port.ntrees_built == ref.ntrees_built == 5
    for f in ("feat", "bin", "is_split"):
        assert np.array_equal(getattr(pf, f).numpy(), np.asarray(getattr(rf, f))), f
    assert np.asarray(rf.is_split).sum() > 20
    np.testing.assert_allclose(pf.thr.numpy(), np.asarray(rf.thr), rtol=0, atol=0)
    np.testing.assert_allclose(pf.value.numpy(), np.asarray(rf.value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.covers[0].numpy(), np.asarray(ref.covers[0]),
                               rtol=1e-6, atol=1e-3)
    assert port.f0 == pytest.approx(ref.f0, abs=1e-7)


def test_training_auc_matches(fits):
    ref, port = fits["binomial"]["ref"], fits["binomial"]["port"]
    assert port.auc() > 0.7
    assert abs(port.auc() - ref.auc()) <= 1e-5
    assert abs(port.logloss() - ref.logloss()) <= 1e-5


def test_regression_metrics_match(fits):
    ref, port = fits["regression"]["ref"], fits["regression"]["port"]
    assert abs(port.rmse() - ref.rmse()) <= 1e-5


@pytest.mark.parametrize("kind", ["binomial", "regression"])
def test_predictions_match(fits, kind):
    fx = fits[kind]
    rp, pp = fx["ref_pred"], fx["port_pred"]
    assert pp.names == rp.names
    for col in pp.names[1:] if kind == "binomial" else pp.names:
        np.testing.assert_allclose(np.asarray(pp.vec(col).data),
                                   np.asarray(rp.vec(col).data),
                                   rtol=1e-5, atol=1e-5)
    if kind == "binomial":
        assert pp.names == ["predict", "0", "1"]
        agree = np.mean(np.asarray(pp.vec("predict").data)
                        == np.asarray(rp.vec("predict").data))
        assert agree > 0.999


def test_holdout_auc_matches(fits):
    fx = fits["binomial"]
    a = fx["port"].model.model_performance(fx["port_test"]).auc
    b = fx["ref"].model.model_performance(fx["ref_test"]).auc
    assert abs(a - b) <= 1e-5


def test_varimp_matches(fits):
    ref, port = fits["binomial"]["ref"], fits["binomial"]["port"]
    rv, pv = ref.varimp(), port.varimp()
    assert [r[0] for r in pv] == [r[0] for r in rv]
    # a split gain is a difference of f32 sums of squares, so its error
    # scales with the largest gain, not with its own size
    top = rv[0][1]
    np.testing.assert_allclose([r[1] for r in pv], [r[1] for r in rv],
                               rtol=1e-5, atol=1e-5 * top)


@pytest.mark.parametrize("kind", ["binomial", "regression"])
def test_forest_from_numpy_predicts_like_the_jax_model(fits, kind):
    fx = fits[kind]
    ref = fx["ref"].model
    st = ref.forest[0]
    model = convert.forest_from_numpy(
        feat=np.asarray(st.feat), bin=np.asarray(st.bin), thr=np.asarray(st.thr),
        is_split=np.asarray(st.is_split), value=np.asarray(st.value),
        covers=np.asarray(ref.covers[0]), f0=ref.f0, edges=ref.bm.edges,
        max_depth=ref.max_depth, x=ref.x, y=ref.y, nbins=ref.bm.nbins,
        domain=ref.domain, problem=ref.problem,
        distribution=ref.distribution, device="cpu")
    got = model.predict(fx["port_test"])
    want = fx["ref_pred"]
    assert got.names == want.names
    for col in got.names[1:] if kind == "binomial" else got.names:
        np.testing.assert_allclose(np.asarray(got.vec(col).data),
                                   np.asarray(want.vec(col).data),
                                   rtol=1e-6, atol=1e-6)


# nfolds, goss, per-class rates, balancing, monotone constraints and
# calibration are ported: their cases now hold the reference's checks of
# nfolds=1, goss with row sampling, a wrong-length rate vector, a monotone
# constraint on an unknown column and calibration without a frame;
# balancing, where the reference has no check, fits and is held to its
# prior correction
@pytest.mark.parametrize("kw,error,match", [
    (dict(sample_rate_per_class=[0.5]), ValueError,
     "sample_rate_per_class needs 2 entries, got 1"),
    (dict(goss=True, sample_rate=0.5), ValueError,
     "goss replaces row sampling"),
    (dict(balance_classes=True), None, None),
    (dict(monotone_constraints={"f99": 1}), ValueError,
     "monotone_constraints: unknown column 'f99'"),
    (dict(nfolds=1), ValueError, "nfolds must be 0 \\(no CV\\) or >= 2"),
    (dict(calibrate_model=True), ValueError,
     "calibrate_model=True requires calibration_frame")],
    ids=[f"kw{i}" for i in range(6)])
def test_unported_parameters_raise(kw, error, match):
    X, y = make_higgs_like(200)
    fr = Frame.from_numpy(np.column_stack([X, y]), names=NAMES).asfactor("label")
    params = dict(PARAMS, device="cpu")
    params.update(kw)
    est = H2OGradientBoostingEstimator(**params)
    if error is not None:
        with pytest.raises(error, match=match):
            est.train(y="label", training_frame=fr)
        return
    est.train(y="label", training_frame=fr)
    prior, modeld = est.model.balance_dists
    np.testing.assert_array_equal(prior, np.bincount(y.astype(int)) / 200)
    np.testing.assert_allclose(modeld, [0.5, 0.5], rtol=0, atol=1e-15)
    p = est.model._score_probs(est.model._matrix(fr))
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=0, atol=1e-12)


def test_split_frame_matches_reference():
    X, y = make_higgs_like(500)
    d = np.column_stack([X, y])
    a = Frame.from_numpy(d, names=NAMES).split_frame([0.7, 0.2], seed=5)
    b = RefFrame.from_numpy(d, names=NAMES).split_frame([0.7, 0.2], seed=5)
    assert [p.nrow for p in a] == [p.nrow for p in b]
    for pa, pb in zip(a, b):
        assert np.array_equal(pa.to_numpy(), pb.to_numpy())


def test_binned_stats_quantiles_equal_nanquantile():
    """The training-metric score edges are written out as sort + lerp
    (torch.nanquantile refuses more than 2^24 rows); on the real rows they
    are bit-equal to nanquantile over the padded vector."""
    import torch

    from h2o3_tpu_torch.models.shared_tree import _binom_binned_stats

    rng = np.random.default_rng(9)
    m = torch.from_numpy(rng.normal(size=5000).astype(np.float32))
    y = torch.from_numpy((rng.random(5000) < 0.4).astype(np.float32))
    n = 4904
    qs = _binom_binned_stats(m, y, n)[0]
    p = torch.sigmoid(m)
    p[n:] = float("nan")
    assert torch.equal(qs, torch.nanquantile(p, torch.linspace(0.0, 1.0, 400)))
