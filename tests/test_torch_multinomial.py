"""Multinomial GBM and DRF: the same 4-class frame through the JAX package
(one-device cloud) and through the port on the CPU.

Four well-separated classes (the label is the argmax of four strong
features plus small noise), so no split gain is near a tie: each class
forest's structure (feature, bin and split flag per node) must match
exactly. The DRF's gradients are one-hot counts, exact in f32, and its row
samples and mtries draws come from threefry with the class keys chained as
the reference chains them (class k's key folds class k−1's), so a wrong key
would show here. Leaf values, probabilities, logloss and the mean per-class
error agree within 1e-5; a JAX multinomial model carried across with
`convert.forest_from_numpy` predicts the same.
"""

import numpy as np
import pytest

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.models.metrics import ModelMetricsMultinomial as RefMM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch import convert
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.metrics import ModelMetricsMultinomial

N, F, K = 3000, 8, 4
NAMES = [f"f{i}" for i in range(F)] + ["label"]
TOL = 1e-5

CASES = {
    "gbm": (RefGBM, H2OGradientBoostingEstimator,
            dict(ntrees=5, max_depth=3, seed=42)),
    # the DRF defaults: row sampling, mtries = sqrt(F) per split
    "drf": (RefDRF, H2ORandomForestEstimator,
            dict(ntrees=5, max_depth=6, seed=42)),
}


def make_classes(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = np.argmax(2 * X[:, :K] + 0.5 * rng.normal(size=(n, K)), axis=1)
    return np.column_stack([X, y.astype(np.float32)])


@pytest.fixture(scope="module")
def fits():
    train, test = make_classes(N, 0), make_classes(1000, 1)
    test[::41, 3] = np.nan                         # NAs at scoring time
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for case, (Ref, Port, params) in CASES.items():
            rf = RefFrame.from_numpy(train, names=NAMES).asfactor("label")
            pf = Frame.from_numpy(train, names=NAMES).asfactor("label")
            rt = RefFrame.from_numpy(test, names=NAMES).asfactor("label")
            pt = Frame.from_numpy(test, names=NAMES).asfactor("label")
            ref = Ref(**params)
            ref.train(y="label", training_frame=rf, validation_frame=rt)
            port = Port(device="cpu", **params)
            port.train(y="label", training_frame=pf, validation_frame=pt)
            out[case] = dict(ref=ref, port=port, ref_test=rt, port_test=pt,
                             ref_pred=ref.predict(rt), port_pred=port.predict(pt))
    finally:
        mesh.reset()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_class_forests_match(fits, case):
    ref, port = fits[case]["ref"].model, fits[case]["port"].model
    assert len(port.forest) == len(ref.forest) == K
    assert port.ntrees_built == ref.ntrees_built == 5
    for k in range(K):
        rf, pf = ref.forest[k], port.forest[k]
        for f in ("feat", "bin", "is_split"):
            assert np.array_equal(getattr(pf, f).numpy(),
                                  np.asarray(getattr(rf, f))), (k, f)
        assert np.asarray(rf.is_split).sum() >= 5 * 5
        np.testing.assert_array_equal(pf.thr.numpy(), np.asarray(rf.thr))
        np.testing.assert_allclose(pf.value.numpy(), np.asarray(rf.value),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(port.covers[k].numpy(),
                                   np.asarray(ref.covers[k]), rtol=1e-6,
                                   atol=1e-3)
    np.testing.assert_allclose(np.asarray(port.f0), np.asarray(ref.f0),
                               rtol=0, atol=1e-7)
    assert np.asarray(port.f0).shape == (K,)


@pytest.mark.parametrize("case", list(CASES))
def test_probabilities_match(fits, case):
    rp, pp = fits[case]["ref_pred"], fits[case]["port_pred"]
    assert pp.names == rp.names == ["predict"] + [str(k) for k in range(K)]
    probs = np.column_stack([np.asarray(pp.vec(str(k)).data) for k in range(K)])
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
    for k in range(K):
        np.testing.assert_allclose(np.asarray(pp.vec(str(k)).data),
                                   np.asarray(rp.vec(str(k)).data),
                                   rtol=TOL, atol=TOL)
    agree = np.mean(np.asarray(pp.vec("predict").data)
                    == np.asarray(rp.vec("predict").data))
    assert agree > 0.999


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("valid", [False, True])
def test_metrics_match(fits, case, valid):
    ref, port = fits[case]["ref"], fits[case]["port"]
    rm, pm = ref.model._m(valid=valid), port.model._m(valid=valid)
    assert type(pm).__name__ == "ModelMetricsMultinomial"
    for name in ("logloss", "mean_per_class_error", "mse", "accuracy"):
        assert abs(getattr(pm, name) - getattr(rm, name)) <= TOL, name
    assert pm.logloss < np.log(K)            # better than the uniform guess
    np.testing.assert_array_equal(pm.confusion_matrix, rm.confusion_matrix)
    assert port.model.mean_per_class_error(valid=valid) == pm.mean_per_class_error


def test_multinomial_metrics_equal_the_reference_on_the_same_probabilities():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 5, 700)
    p = rng.random((700, 5))
    p[::9, 2] = 0.0                                   # clipped at 1e-15
    p /= p.sum(axis=1, keepdims=True)
    a, b = ModelMetricsMultinomial.make(y, p), RefMM.make(y, p)
    for name in ("logloss", "mean_per_class_error", "mse", "rmse", "accuracy",
                 "nobs"):
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.confusion_matrix, b.confusion_matrix)


@pytest.mark.parametrize("case", list(CASES))
def test_forest_from_numpy_predicts_like_the_jax_model(fits, case):
    fx = fits[case]
    ref = fx["ref"].model
    fields = {f: [np.asarray(getattr(ref.forest[k], f)) for k in range(K)]
              for f in ("feat", "bin", "thr", "is_split", "value")}
    model = convert.forest_from_numpy(
        **fields, covers=[np.asarray(c) for c in ref.covers], f0=ref.f0,
        edges=ref.bm.edges, max_depth=ref.max_depth, x=ref.x, y=ref.y,
        nbins=ref.bm.nbins, domain=ref.domain, problem=ref.problem,
        distribution=ref.distribution, mode=ref.mode, device="cpu")
    assert len(model.forest) == K and model.nclass == K
    got, want = model.predict(fx["port_test"]), fx["ref_pred"]
    assert got.names == want.names
    for k in range(K):
        np.testing.assert_allclose(np.asarray(got.vec(str(k)).data),
                                   np.asarray(want.vec(str(k)).data),
                                   rtol=1e-6, atol=1e-6)


def test_forest_from_numpy_rejects_mismatched_classes(fits):
    ref = fits["gbm"]["ref"].model
    st = ref.forest[0]
    kw = dict(feat=np.asarray(st.feat), bin=np.asarray(st.bin),
              thr=np.asarray(st.thr), is_split=np.asarray(st.is_split),
              value=np.asarray(st.value), covers=None, edges=ref.bm.edges,
              max_depth=ref.max_depth, x=ref.x, y=ref.y, nbins=ref.bm.nbins,
              domain=ref.domain, problem="multinomial", device="cpu")
    with pytest.raises(ValueError, match="class forests"):
        convert.forest_from_numpy(f0=ref.f0, **kw)
