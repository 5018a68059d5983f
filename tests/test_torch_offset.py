"""`offset_column` through both packages' GBM fits on the CPU.

A GBM with an offset starts its margins at f0 + offset (f0 ignores the
offset), fits, scores and stops on those margins, and adds the frame's
offset to the margins at `predict`; a validation frame adds its own
offset. Bernoulli, gaussian and poisson fits, with and without a
validation frame: the same forest structure (feature, bin and split flag
per node) as the reference, leaf values, predictions and metrics within
1e-5. DRF rejects the offset with the reference's `ValueError`; GLM raises
`NotImplementedError` (the reference's GLM drops the column and fits
without it, which the port does not copy).
"""

import numpy as np
import pytest

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.estimators import (H2OGeneralizedLinearEstimator,
                                       H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame

F = 5
NAMES = [f"f{i}" for i in range(F)] + ["off", "y"]
TOL = 1e-5
DISTS = ["bernoulli", "gaussian", "poisson"]


def _data(n, seed, dist):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F))
    off = 0.5 * rng.normal(size=n)
    eta = 0.8 * X[:, 0] - 0.6 * X[:, 1] + 0.4 * X[:, 2] * X[:, 3] + off
    if dist == "bernoulli":
        y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.float64)
    elif dist == "poisson":
        y = rng.poisson(np.exp(0.5 * eta)).astype(np.float64)
    else:
        y = eta + 0.2 * rng.normal(size=n)
    return np.column_stack([X, off, y])


def _frames(d, dist):
    rf, pf = RefFrame.from_numpy(d, names=NAMES), Frame.from_numpy(d, names=NAMES)
    if dist == "bernoulli":
        rf, pf = rf.asfactor("y"), pf.asfactor("y")
    return rf, pf


@pytest.fixture(scope="module")
def fits():
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for dist in DISTS:
            rf, pf = _frames(_data(1500, 0, dist), dist)
            rv, pv = _frames(_data(600, 1, dist), dist)
            for valid in (False, True):
                params = dict(ntrees=6, max_depth=4, seed=7, distribution=dist,
                              offset_column="off")
                ref = RefGBM(**params)
                ref.train(y="y", training_frame=rf,
                          validation_frame=rv if valid else None)
                port = H2OGradientBoostingEstimator(device="cpu", **params)
                port.train(y="y", training_frame=pf,
                           validation_frame=pv if valid else None)
                out[(dist, valid)] = dict(ref=ref, port=port, rv=rv, pv=pv)
    finally:
        mesh.reset()
    return out


KEYS = [(d, v) for d in DISTS for v in (False, True)]
IDS = [f"{d}-{'valid' if v else 'train'}" for d, v in KEYS]


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_offset_forest_matches_reference(fits, key):
    ref, port = fits[key]["ref"].model, fits[key]["port"].model
    assert port.x == ref.x == [f"f{i}" for i in range(F)]
    assert port.f0 == pytest.approx(float(np.asarray(ref.f0).reshape(-1)[0]),
                                    abs=TOL)
    rf, pf = ref.forest[0], port.forest[0]
    for f in ("feat", "bin", "is_split"):
        np.testing.assert_array_equal(getattr(pf, f).numpy(),
                                      np.asarray(getattr(rf, f)))
    np.testing.assert_allclose(pf.value.numpy(), np.asarray(rf.value),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_offset_predictions_and_metrics_match(fits, key):
    fx = fits[key]
    ref, port = fx["ref"], fx["port"]
    col = "1" if key[0] == "bernoulli" else "predict"
    got = np.asarray(port.predict(fx["pv"]).vec(col).data, np.float64)
    want = np.asarray(ref.predict(fx["rv"]).vec(col).data, np.float64)
    scale = np.maximum(1.0, np.abs(want))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL)
    valid = key[1]
    if key[0] == "bernoulli":
        assert port.auc(valid=valid) == pytest.approx(ref.auc(valid=valid),
                                                      abs=TOL)
        assert port.logloss(valid=valid) == pytest.approx(
            ref.logloss(valid=valid), abs=TOL)
    else:
        assert port.rmse(valid=valid) == pytest.approx(
            ref.rmse(valid=valid), rel=TOL, abs=TOL)
    # model_performance applies the scored frame's offset too
    perf = port.model.model_performance(fx["pv"])
    assert perf.mse == pytest.approx(ref.model.model_performance(fx["rv"]).mse,
                                     rel=TOL, abs=TOL)
    hist_p, hist_r = port.scoring_history, ref.scoring_history
    assert len(hist_p) == len(hist_r)


def test_offset_column_left_out_of_default_x():
    d = _data(200, 2, "gaussian")
    fr = Frame.from_numpy(d, names=NAMES)
    est = H2OGradientBoostingEstimator(ntrees=1, max_depth=2, device="cpu",
                                       offset_column="off")
    est.train(y="y", training_frame=fr)
    assert "off" not in est.model.x
    plain = H2OGradientBoostingEstimator(ntrees=1, max_depth=2, device="cpu")
    plain.train(y="y", training_frame=fr)
    assert "off" in plain.model.x


def test_drf_rejects_offset():
    fr = Frame.from_numpy(_data(200, 3, "gaussian"), names=NAMES)
    with pytest.raises(ValueError, match="not supported for DRF"):
        H2ORandomForestEstimator(ntrees=2, device="cpu",
                                 offset_column="off").train(
            y="y", training_frame=fr)


def test_glm_raises_for_offset():
    fr = Frame.from_numpy(_data(200, 4, "gaussian"), names=NAMES)
    with pytest.raises(NotImplementedError, match="offset_column"):
        H2OGeneralizedLinearEstimator(family="gaussian", device="cpu",
                                      offset_column="off").train(
            y="y", training_frame=fr)


def test_predict_adds_the_frames_offset(fits):
    """A gaussian model's prediction moves one for one with the frame's
    offset; a frame without the column scores without it."""
    fx = fits[("gaussian", False)]
    d = _data(100, 5, "gaussian")
    base = np.asarray(fx["port"].predict(Frame.from_numpy(d, names=NAMES))
                      .vec("predict").data, np.float64)
    d[:, F] += 1.0
    moved = np.asarray(fx["port"].predict(Frame.from_numpy(d, names=NAMES))
                       .vec("predict").data, np.float64)
    np.testing.assert_allclose(moved - base, 1.0, rtol=0, atol=1e-6)
    none = Frame.from_numpy(np.delete(d, F, axis=1),
                            names=[n for n in NAMES if n != "off"])
    bare = np.asarray(fx["port"].predict(none).vec("predict").data, np.float64)
    np.testing.assert_allclose(moved - bare, d[:, F], rtol=0, atol=1e-6)
