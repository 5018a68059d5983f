"""The DRF path end to end, and GBM with sampling: the same frames through
the JAX package (one-device cloud) and through the port on the CPU (DRF
with ``hist_method="pallas"``, whose CPU twin is `hist_plain_rows`).

Row samples, column samples and per-split mtries draw from threefry in
both, so the forests must match exactly: feature, bin and split flag per
node. Binary labels and a regression target on a grid of quarters keep
every histogram sum exact in f32, so the many exact ties of `min_rows=1`
trees are broken the same way in both (first occurrence) and no near-tie
can flip. Leaf values, OOB metrics and predictions agree within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.metrics import ModelMetricsBinomial
from h2o3_tpu_torch.models.tree import histogram_level_plan
from h2o3_tpu_torch.ops import histogram

from test_torch_gbm import make_higgs_like

N, F = 2000, 6
NAMES = [f"f{i}" for i in range(F)] + ["label"]

# case -> (estimator pair, response kind, parameters, compact cap)
CASES = {
    "drf_binomial": ("drf", "binomial", dict(ntrees=5, max_depth=10, seed=42), None),
    "drf_regression": ("drf", "regression", dict(ntrees=5, max_depth=10, seed=42), None),
    # depth 14: levels 9..13 run in 256 compact slots, no overflow
    "drf_compact": ("drf", "binomial", dict(ntrees=5, max_depth=14, seed=42), 256),
    "gbm_sampled": ("gbm", "binomial",
                    dict(ntrees=5, max_depth=4, seed=42, sample_rate=0.7,
                         col_sample_rate=0.8,
                         histogram_type="UniformAdaptive"), None),
}


def _data(n, seed, kind):
    X, y = make_higgs_like(n, n_feat=F, seed=seed)
    if kind == "regression":
        y = (np.round(4 * (2 * X[:, 0] + np.sin(3 * X[:, 1]))) / 4).astype(np.float32)
    return np.column_stack([X, y])


def _frames(d, kind):
    rf, pf = RefFrame.from_numpy(d, names=NAMES), Frame.from_numpy(d, names=NAMES)
    if kind == "binomial":
        rf, pf = rf.asfactor("label"), pf.asfactor("label")
    return rf, pf


@pytest.fixture(scope="module")
def fits():
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name, (algo, kind, params, cap) in CASES.items():
                if cap is None:
                    mp.delenv("H2O3_COMPACT_CAP", raising=False)
                else:
                    mp.setenv("H2O3_COMPACT_CAP", str(cap))
                rf, pf = _frames(_data(N, 0, kind), kind)
                if algo == "drf":
                    ref = RefDRF(**params)
                    port = H2ORandomForestEstimator(device="cpu",
                                                    hist_method="pallas",
                                                    **params)
                else:
                    ref = RefGBM(**params)
                    port = H2OGradientBoostingEstimator(device="cpu", **params)
                ref.train(y="label", training_frame=rf)
                histogram.DISPATCH.clear()
                port.train(y="label", training_frame=pf)
                dispatch = dict(histogram.DISPATCH)
                test = _data(1500, 1, kind)
                test[::37, 2] = np.nan                  # NAs at scoring time
                rt, pt = _frames(test, kind)
                out[name] = dict(ref=ref, port=port, kind=kind, ref_test=rt,
                                 port_test=pt, dispatch=dispatch,
                                 ref_pred=ref.predict(rt),
                                 port_pred=port.predict(pt))
    finally:
        mesh.reset()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_forest_structure_matches(fits, case):
    ref, port = fits[case]["ref"].model, fits[case]["port"].model
    rf, pf = ref.forest[0], port.forest
    assert port.ntrees_built == ref.ntrees_built == 5
    assert port.max_depth == ref.max_depth
    for f in ("feat", "bin", "is_split"):
        assert np.array_equal(getattr(pf, f).numpy(), np.asarray(getattr(rf, f))), f
    assert np.asarray(rf.is_split).sum() > 50
    np.testing.assert_allclose(pf.thr.numpy(), np.asarray(rf.thr), rtol=0, atol=0)
    np.testing.assert_allclose(pf.value.numpy(), np.asarray(rf.value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.covers.numpy(), np.asarray(ref.covers[0]),
                               rtol=1e-6, atol=1e-3)
    assert port.f0 == pytest.approx(ref.f0, abs=1e-7)


@pytest.mark.parametrize("case", list(CASES))
def test_training_metrics_match(fits, case):
    """DRF: out-of-bag metrics; GBM: in-bag."""
    ref, port = fits[case]["ref"], fits[case]["port"]
    if fits[case]["kind"] == "binomial":
        assert port.auc() > 0.65
        assert abs(port.auc() - ref.auc()) <= 1e-5
        assert abs(port.logloss() - ref.logloss()) <= 1e-5
    else:
        assert abs(port.rmse() - ref.rmse()) <= 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_predictions_match(fits, case):
    fx = fits[case]
    rp, pp = fx["ref_pred"], fx["port_pred"]
    assert pp.names == rp.names
    for col in pp.names[1:] if fx["kind"] == "binomial" else pp.names:
        np.testing.assert_allclose(np.asarray(pp.vec(col).data),
                                   np.asarray(rp.vec(col).data),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["drf_binomial", "drf_compact"])
def test_holdout_auc_matches(fits, case):
    """A DRF's probabilities are averages of a few leaf means, so many
    holdout rows tie. The two scorers add the trees in another order, and a
    last-bit difference splits or merges a group of ties, which moves the
    AUC by more than the 1e-5 the predictions agree to. So the AUC is taken
    of both models' predictions rounded to 1e-6, which keeps the ties."""
    fx = fits[case]
    y = np.asarray(fx["port_test"].vec("label").data)

    def auc(pred):
        p1 = np.round(np.asarray(pred.vec("1").data, np.float64), 6)
        return ModelMetricsBinomial.make(y, p1).auc

    assert abs(auc(fx["port_pred"]) - auc(fx["ref_pred"])) <= 1e-12
    assert abs(fx["port"].model.model_performance(fx["port_test"]).auc
               - auc(fx["port_pred"])) <= 1e-3


def test_drf_passes_dispatch_pallas(fits):
    """Every histogram pass of a DRF fit asked for with "pallas" went to
    the B2 entry: the dense plan of depth 10, and the compact plan of
    depth 14 (9 dense levels, the transition, 5 compact levels)."""
    assert fits["drf_binomial"]["dispatch"] == {
        "pallas": 5 * len(histogram_level_plan(10))}
    assert fits["drf_compact"]["dispatch"] == {
        "pallas": 5 * len(histogram_level_plan(14, 256))}
    assert len(histogram_level_plan(14, 256)) == 15
    port = fits["drf_compact"]["port"].model
    assert port.compact_cap == 256 and port.dense_rebuilds == 0


def test_varimp_matches(fits):
    ref, port = fits["drf_binomial"]["ref"], fits["drf_binomial"]["port"]
    rv, pv = ref.varimp(), port.varimp()
    assert [r[0] for r in pv] == [r[0] for r in rv]
    top = rv[0][1]
    np.testing.assert_allclose([r[1] for r in pv], [r[1] for r in rv],
                               rtol=1e-5, atol=1e-5 * top)


@pytest.mark.parametrize("case", ["drf_binomial", "drf_regression"])
def test_forest_from_numpy_predicts_like_the_jax_drf(fits, case):
    fx = fits[case]
    ref = fx["ref"].model
    st = ref.forest[0]
    model = convert.forest_from_numpy(
        feat=np.asarray(st.feat), bin=np.asarray(st.bin), thr=np.asarray(st.thr),
        is_split=np.asarray(st.is_split), value=np.asarray(st.value),
        covers=np.asarray(ref.covers[0]), f0=ref.f0, edges=ref.bm.edges,
        max_depth=ref.max_depth, x=ref.x, y=ref.y, nbins=ref.bm.nbins,
        domain=ref.domain, problem=ref.problem, distribution=ref.distribution,
        mode=ref.mode, device="cpu")
    got, want = model.predict(fx["port_test"]), fx["ref_pred"]
    assert got.names == want.names
    for col in got.names[1:] if fx["kind"] == "binomial" else got.names:
        np.testing.assert_allclose(np.asarray(got.vec(col).data),
                                   np.asarray(want.vec(col).data),
                                   rtol=1e-6, atol=1e-6)


def _port_drf(**kw):
    _, pf = _frames(_data(N, 0, "binomial"), "binomial")
    est = H2ORandomForestEstimator(device="cpu", ntrees=3, seed=42, **kw)
    return est.train(y="label", training_frame=pf).model


def test_overflow_rebuild_equals_the_dense_tree(monkeypatch):
    """A 64-slot cap overflows at depth 14 with min_rows=1: every tree is
    rebuilt with dense levels from the same keys, which is the forest of a
    cap too wide to switch on (8192 slots: all 14 levels dense)."""
    monkeypatch.setenv("H2O3_COMPACT_CAP", "64")
    small = _port_drf(max_depth=14, hist_method="pallas")
    monkeypatch.setenv("H2O3_COMPACT_CAP", "8192")
    dense = _port_drf(max_depth=14)
    assert small.dense_rebuilds == 3 and dense.dense_rebuilds == 0
    for f in ("feat", "bin", "is_split", "value"):
        assert torch.equal(getattr(small.forest, f), getattr(dense.forest, f)), f
    assert small.auc() == dense.auc()


def test_pallas_and_segment_give_the_same_forest_on_cpu():
    """On the CPU "pallas" runs `hist_plain_rows`, the same per-feature
    index_add_ fold as "segment" over the same rows: the same bits."""
    a, b = _port_drf(max_depth=8, hist_method="pallas"), _port_drf(max_depth=8)
    for f in ("feat", "bin", "is_split", "value"):
        assert torch.equal(getattr(a.forest, f), getattr(b.forest, f)), f


def test_drf_defaults_and_mtries():
    est = H2ORandomForestEstimator(device="cpu")
    ref = RefDRF()
    tp, rtp = est._tree_params(), ref._tree_params()
    for k in ("ntrees", "max_depth", "min_rows", "nbins", "sample_rate",
              "col_sample_rate", "col_sample_rate_per_tree", "mtries",
              "reg_lambda", "min_split_improvement"):
        assert tp[k] == rtp[k], k
    for F_, problem in ((28, "binomial"), (28, "regression"), (6, "binomial")):
        assert (est._resolved_mtries(tp, F_, problem)
                == ref._resolved_mtries(rtp, F_, problem))
    assert est._resolved_mtries(tp, 28, "binomial") == 5
    with pytest.raises(ValueError):
        H2ORandomForestEstimator(device="cpu", mtries=-3).train(
            y="label", training_frame=_frames(_data(100, 0, "binomial"),
                                              "binomial")[1])
