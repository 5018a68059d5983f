"""MOJO artifacts of the port against the reference's: the same frames fit
by both packages (GBM bernoulli, gaussian, poisson and multinomial, DRF
binomial, regression and multinomial; binary labels, a target on a grid of
quarters and four well-separated classes, so the forests match), exported
by each, compared member by member, and loaded across. A multinomial model
writes one class forest `forest{k}_*` per class and the f0 list.

The zip members are compared, not the zip bytes: `zipfile.writestr` stamps
the current time. `model.json` must be equal apart from `model_id`, and
every array equal. A GBM's leaf values are Newton steps on f32 gradient
sums, which the two packages add in another order from the second tree on
(`tests/test_torch_gbm.py` holds them to 1e-5), so a several-tree GBM's
`forest0_value` is held to 1e-6 (1e-5 for the multinomial GBM, whose
softmax gradients are not dyadic: `tests/test_torch_multinomial.py`); a
one-tree gaussian GBM on 2048 rows of the quarter grid sums exactly, and
there every array is equal to the bit.

A binomial and a poisson GLM are held the same way: `model.json` equal,
the standardization stats equal to the bit and β within 1e-5; and a
reference multinomial GLM's artifact scores in the port's numpy scorer.
"""

import io
import json
import zipfile

import numpy as np
import pytest

import jax

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch import mojo
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame

from test_torch_gbm import make_higgs_like

F = 6
NAMES = [f"f{i}" for i in range(F)] + ["label"]

# case -> (algo, response kind, rows, parameters, leaf-value tolerance:
# 0 = bit-equal)
CASES = {
    "gbm_bernoulli": ("gbm", "binomial", 2000,
                      dict(ntrees=4, max_depth=4, seed=42), 1e-6),
    "gbm_gaussian": ("gbm", "regression", 2000,
                     dict(ntrees=4, max_depth=4, seed=42), 1e-6),
    "gbm_gaussian_one_tree": ("gbm", "regression", 2048,
                              dict(ntrees=1, max_depth=4, seed=42), 0),
    "gbm_poisson": ("gbm", "counts", 2000,
                    dict(ntrees=4, max_depth=4, seed=42,
                         distribution="poisson"), 1e-6),
    "gbm_multinomial": ("gbm", "multinomial", 2000,
                        dict(ntrees=4, max_depth=3, seed=42), 1e-5),
    "drf_binomial": ("drf", "binomial", 2000,
                     dict(ntrees=4, max_depth=8, seed=42), 0),
    "drf_regression": ("drf", "regression", 2000,
                       dict(ntrees=4, max_depth=8, seed=42), 0),
    "drf_multinomial": ("drf", "multinomial", 2000,
                        dict(ntrees=4, max_depth=8, seed=42), 0),
}
CLASSIFIERS = ("binomial", "multinomial")


def _data(n, seed, kind):
    X, y = make_higgs_like(n, n_feat=F, seed=seed)
    if kind == "regression":
        y = (np.round(4 * (2 * X[:, 0] + np.sin(3 * X[:, 1]))) / 4).astype(np.float32)
    elif kind == "counts":
        rng = np.random.default_rng(seed + 7)
        y = rng.poisson(np.exp(0.5 * X[:, 0] - 0.3 * X[:, 1])).astype(np.float32)
    elif kind == "multinomial":
        rng = np.random.default_rng(seed + 7)
        y = np.argmax(2 * X[:, :4] + 0.5 * rng.normal(size=(n, 4)),
                      axis=1).astype(np.float32)
    return np.column_stack([X, y])


def _frames(d, kind):
    rf, pf = RefFrame.from_numpy(d, names=NAMES), Frame.from_numpy(d, names=NAMES)
    if kind in CLASSIFIERS:
        rf, pf = rf.asfactor("label"), pf.asfactor("label")
    return rf, pf


def _members(path):
    with zipfile.ZipFile(path) as z:
        names = sorted(z.namelist())
        meta = json.loads(z.read("model.json"))
        arrays = dict(np.load(io.BytesIO(z.read("arrays.npz"))))
    return names, meta, arrays


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for case, (algo, kind, n, params, _exact) in CASES.items():
            rf, pf = _frames(_data(n, 0, kind), kind)
            if algo == "drf":
                ref = RefDRF(**params)
                port = H2ORandomForestEstimator(device="cpu",
                                                hist_method="pallas", **params)
            else:
                ref = RefGBM(**params)
                port = H2OGradientBoostingEstimator(device="cpu", **params)
            ref.train(y="label", training_frame=rf)
            port.train(y="label", training_frame=pf)
            d = tmp_path_factory.mktemp(case)
            test = _data(700, 1, kind)
            test[::37, 2] = np.nan                  # NAs at scoring time
            rt, pt = _frames(test, kind)
            out[case] = dict(
                kind=kind, ref=ref.model, port=port.model, ref_test=rt,
                port_test=pt,
                ref_path=refmojo.save_model(ref.model, str(d), "ref.h2o3"),
                port_path=mojo.save_model(port.model, str(d), "port.h2o3"))
    finally:
        mesh.reset()
    return out


def _pred_cols(frame, kind):
    names = frame.names[1:] if kind in CLASSIFIERS else frame.names
    return {n: np.asarray(frame.vec(n).data, np.float64) for n in names}


@pytest.mark.parametrize("case", list(CASES))
def test_model_json_equal_apart_from_model_id(artifacts, case):
    a = artifacts[case]
    ref_names, ref_meta, _ = _members(a["ref_path"])
    names, meta, _ = _members(a["port_path"])
    assert names == ref_names == ["arrays.npz", "model.json"]
    assert meta.pop("model_id") == a["port"].model_id
    ref_meta.pop("model_id")
    assert meta == ref_meta
    K = 4 if a["kind"] == "multinomial" else 1
    assert meta["n_forests"] == K and meta["kind"] == "tree"
    assert np.ndim(meta["f0"]) == (K > 1)


@pytest.mark.parametrize("case", list(CASES))
def test_arrays_equal(artifacts, case):
    a = artifacts[case]
    _, _, ref_arrays = _members(a["ref_path"])
    _, _, arrays = _members(a["port_path"])
    K = 4 if a["kind"] == "multinomial" else 1
    assert sorted(arrays) == sorted(ref_arrays) == sorted(
        f"forest{c}_{f}" for c in range(K)
        for f in ("bin", "cover", "feat", "is_split", "thr", "value"))
    tol = CASES[case][4]
    for k in sorted(arrays):
        assert arrays[k].dtype == ref_arrays[k].dtype, k
        assert arrays[k].shape == ref_arrays[k].shape, k
        if k.endswith("_value") and tol:
            np.testing.assert_allclose(arrays[k], ref_arrays[k], rtol=0,
                                       atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(arrays[k], ref_arrays[k], err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_cross_load_predicts_like_the_fitted_model(artifacts, case):
    """The reference's loader on the port's file and the port's loader on
    the reference's file both predict what the fitted models predict."""
    a = artifacts[case]
    kind = a["kind"]
    want_port = _pred_cols(a["port"].predict(a["port_test"]), kind)
    want_ref = _pred_cols(a["ref"].predict(a["ref_test"]), kind)
    ref_on_port = refmojo.load_model(a["port_path"]).predict(a["ref_test"])
    port_on_ref = mojo.load_model(a["ref_path"]).predict(a["port_test"])
    port_on_port = mojo.load_model(a["port_path"]).predict(a["port_test"])
    for got, want in ((_pred_cols(ref_on_port, kind), want_port),
                      (_pred_cols(port_on_ref, kind), want_ref),
                      (_pred_cols(port_on_port, kind), want_port)):
        assert list(got) == list(want)
        for col in want:
            np.testing.assert_allclose(got[col], want[col], rtol=0,
                                       atol=1e-5, err_msg=col)


def test_artifact_reexports_losslessly(artifacts, tmp_path):
    a = artifacts["drf_binomial"]
    loaded = mojo.load_model(a["port_path"])
    again = mojo.save_model(loaded, str(tmp_path), "again.h2o3")
    _, meta0, arr0 = _members(a["port_path"])
    _, meta1, arr1 = _members(again)
    assert meta0 == meta1
    assert all(np.array_equal(arr0[k], arr1[k]) for k in arr0)


def test_unsupported_model_raises_the_reference_type_error(tmp_path):
    class NotATree:
        model_id, algo, x, y = "m", "glm", ["a"], "y"

    with pytest.raises(TypeError) as port_err:
        mojo.save_model(NotATree(), str(tmp_path))
    with pytest.raises(TypeError) as ref_err:
        refmojo.save_model(NotATree(), str(tmp_path))
    assert str(port_err.value) == str(ref_err.value)


def test_save_refuses_to_overwrite_without_force(artifacts):
    a = artifacts["gbm_bernoulli"]
    with pytest.raises(FileExistsError):
        mojo.save_model(a["port"], a["port_path"])
    assert mojo.save_model(a["port"], a["port_path"], force=True) == a["port_path"]


# -- GLM artifacts ----------------------------------------------------------

GLM_CASES = {"glm_binomial": "binomial", "glm_poisson": "poisson"}


@pytest.fixture(scope="module")
def glm_artifacts(tmp_path_factory):
    """A binomial and a poisson GLM fit by both packages on the frames of
    `tests/test_torch_glm.py` (string enums, NaNs), each exported."""
    from h2o3_tpu.models.glm import H2OGeneralizedLinearEstimator as RefGLM
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator

    from test_torch_glm import X_COLS, glm_frame

    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for case, family in GLM_CASES.items():
            d, types = glm_frame(3000, 0, family)
            t, _ = glm_frame(700, 1, family)
            t["c1"] = t["c1"].copy()
            t["c1"][::9] = "BOS"                 # a level the fit never saw
            ref = RefGLM(family=family, lambda_=0.0)
            ref.train(x=X_COLS, y="y",
                      training_frame=RefFrame.from_dict(d, column_types=types))
            port = H2OGeneralizedLinearEstimator(family=family, lambda_=0.0,
                                                 device="cpu")
            port.train(x=X_COLS, y="y",
                       training_frame=Frame.from_dict(d, column_types=types))
            dd = tmp_path_factory.mktemp(case)
            out[case] = dict(
                family=family, ref=ref.model, port=port.model,
                ref_test=RefFrame.from_dict(t, column_types=types),
                port_test=Frame.from_dict(t, column_types=types),
                ref_path=refmojo.save_model(ref.model, str(dd), "ref.h2o3"),
                port_path=mojo.save_model(port.model, str(dd), "port.h2o3"))
    finally:
        mesh.reset()
    return out


@pytest.mark.parametrize("case", list(GLM_CASES))
def test_glm_members_equal(glm_artifacts, case):
    """model.json equal apart from model_id; `means`, `stds` equal to the
    bit (host numpy in both packages); `beta` within 1e-5 (the two
    packages' f32 Gram sums differ in order: `tests/test_torch_glm.py`)."""
    a = glm_artifacts[case]
    ref_names, ref_meta, ref_arrays = _members(a["ref_path"])
    names, meta, arrays = _members(a["port_path"])
    assert names == ref_names == ["arrays.npz", "model.json"]
    assert meta.pop("model_id") == a["port"].model_id
    ref_meta.pop("model_id")
    assert meta == ref_meta
    assert meta["kind"] == "glm" and meta["family"] == a["family"]
    assert sorted(arrays) == sorted(ref_arrays) == ["beta", "means", "stds"]
    for k in arrays:
        assert arrays[k].dtype == ref_arrays[k].dtype == np.float64, k
        assert arrays[k].shape == ref_arrays[k].shape, k
    np.testing.assert_array_equal(arrays["means"], ref_arrays["means"])
    np.testing.assert_array_equal(arrays["stds"], ref_arrays["stds"])
    np.testing.assert_allclose(arrays["beta"], ref_arrays["beta"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", list(GLM_CASES))
def test_glm_cross_load_predicts_like_the_fitted_model(glm_artifacts, case):
    a = glm_artifacts[case]
    kind = "binomial" if a["family"] == "binomial" else "regression"
    want_port = _pred_cols(a["port"].predict(a["port_test"]), kind)
    want_ref = _pred_cols(a["ref"].predict(a["ref_test"]), kind)
    ref_on_port = refmojo.load_model(a["port_path"]).predict(a["ref_test"])
    port_on_ref = mojo.load_model(a["ref_path"]).predict(a["port_test"])
    port_on_port = mojo.load_model(a["port_path"]).predict(a["port_test"])
    for got, want in ((_pred_cols(ref_on_port, kind), want_port),
                      (_pred_cols(port_on_ref, kind), want_ref),
                      (_pred_cols(port_on_port, kind), want_port)):
        assert list(got) == list(want)
        for col in want:
            np.testing.assert_allclose(got[col], want[col], rtol=1e-5,
                                       atol=1e-5, err_msg=col)


def test_glm_artifact_reexports_losslessly(glm_artifacts, tmp_path):
    a = glm_artifacts["glm_binomial"]
    again = mojo.save_model(mojo.load_model(a["port_path"]), str(tmp_path),
                            "again.h2o3")
    _, meta0, arr0 = _members(a["port_path"])
    _, meta1, arr1 = _members(again)
    assert meta0 == meta1
    assert all(np.array_equal(arr0[k], arr1[k]) for k in arr0)


def test_reference_multinomial_glm_artifact_scores_in_the_port(tmp_path):
    """The port's numpy scorer reads the reference's multinomial GLM
    artifact and predicts what it predicts (the port's own multinomial
    GLM and its artifact: `tests/test_torch_glm_multinomial.py`)."""
    from h2o3_tpu.models.glm import H2OGeneralizedLinearEstimator as RefGLM

    rng = np.random.default_rng(6)
    X = rng.normal(size=(600, 3))
    y = np.argmax(np.column_stack([X[:, 0], X[:, 1], -X[:, 0]]), axis=1)
    d = np.column_stack([X, y])
    names = ["a", "b", "c", "y"]
    mesh.init(jax.devices()[:1])
    try:
        ref = RefGLM(family="multinomial", lambda_=0.0)
        ref.train(y="y", training_frame=RefFrame.from_numpy(
            d, names=names).asfactor("y"))
        path = refmojo.save_model(ref.model, str(tmp_path), "m.h2o3")
    finally:
        mesh.reset()
    want = refmojo.load_model(path).predict(RefFrame.from_numpy(d, names=names))
    got = mojo.load_model(path).predict(Frame.from_numpy(d, names=names))
    assert got.names == want.names == ["predict", "0", "1", "2"]
    for col in got.names[1:]:
        np.testing.assert_allclose(np.asarray(got.vec(col).data),
                                   np.asarray(want.vec(col).data),
                                   rtol=0, atol=1e-12)


CONTRIB_CASES = ["gbm_bernoulli", "gbm_gaussian", "drf_binomial",
                 "drf_regression"]


@pytest.mark.parametrize("case", CONTRIB_CASES)
def test_contributions_cross_load(artifacts, case):
    """The port's `MojoScorer.predict_contributions` (its plain TreeSHAP)
    on either package's artifact against the reference scorer's on the
    same artifact (its native TreeSHAP where built): within 1e-12."""
    a = artifacts[case]
    for path in (a["ref_path"], a["port_path"]):
        want = refmojo.load_model(path).predict_contributions(a["ref_test"])
        got = mojo.load_model(path).predict_contributions(a["port_test"])
        assert got.names == want.names == [f"f{i}" for i in range(F)] + ["BiasTerm"]
        for n in want.names:
            np.testing.assert_allclose(np.asarray(got.vec(n).data, np.float64),
                                       np.asarray(want.vec(n).data, np.float64),
                                       rtol=0, atol=1e-12)


def test_contributions_of_the_artifact_equal_the_model(artifacts):
    a = artifacts["gbm_bernoulli"]
    got = mojo.load_model(a["port_path"]).predict_contributions(a["port_test"])
    want = a["port"].predict_contributions(a["port_test"])
    for n in want.names:
        np.testing.assert_array_equal(np.asarray(got.vec(n).data),
                                      np.asarray(want.vec(n).data))
    with pytest.raises(ValueError, match="multinomial"):
        mojo.load_model(artifacts["gbm_multinomial"]["port_path"]) \
            .predict_contributions(artifacts["gbm_multinomial"]["port_test"])


# -- StackedEnsemble artifacts ------------------------------------------------

@pytest.fixture(scope="module")
def se_artifacts(tmp_path_factory):
    """A binomial StackedEnsemble over a 2-fold GBM and GLM, fit by both
    packages on one frame and exported by each: the ensemble's `meta`
    with a child payload per base model and one for the metalearner."""
    import h2o3_tpu.estimators as ref_est
    import h2o3_tpu_torch.estimators as port_est

    d = _data(400, 5, "binomial")
    t = _data(300, 6, "binomial")
    cv = dict(nfolds=2, fold_assignment="Modulo", seed=3,
              keep_cross_validation_predictions=True)
    out = {}
    dd = tmp_path_factory.mktemp("se")
    mesh.init(jax.devices()[:1])
    try:
        for pkg, mod, frame_cls, save, dev in (
                ("ref", ref_est, RefFrame, refmojo.save_model, {}),
                ("port", port_est, Frame, mojo.save_model,
                 dict(device="cpu"))):
            i = 0 if pkg == "ref" else 1
            fr, ft = _frames(d, "binomial")[i], _frames(t, "binomial")[i]
            bases = [mod.H2OGradientBoostingEstimator(ntrees=3, max_depth=3,
                                                      **cv, **dev),
                     mod.H2OGeneralizedLinearEstimator(family="binomial",
                                                       lambda_=0.0, **cv,
                                                       **dev)]
            for b in bases:
                b.train(y="label", training_frame=fr)
            se = mod.H2OStackedEnsembleEstimator(base_models=bases, **dev)
            se.train(y="label", training_frame=fr)
            out[pkg] = dict(model=se.model, test=ft,
                            path=save(se.model, str(dd), f"{pkg}.h2o3"))
    finally:
        mesh.reset()
    return out


def test_se_artifact_members(se_artifacts):
    with zipfile.ZipFile(se_artifacts["port"]["path"]) as z:
        port_names = sorted(z.namelist())
    with zipfile.ZipFile(se_artifacts["ref"]["path"]) as z:
        ref_names = sorted(z.namelist())
    assert port_names == ref_names == sorted(
        f"{p}{m}" for p in ("", "base0/", "base1/", "meta/")
        for m in ("arrays.npz", "model.json"))
    _, meta, arrays = _members(se_artifacts["port"]["path"])
    _, ref_meta, _ = _members(se_artifacts["ref"]["path"])
    assert meta.pop("model_id") and ref_meta.pop("model_id")
    assert meta == ref_meta
    assert meta["kind"] == "stackedensemble" and meta["n_base"] == 2
    assert arrays == {}


@pytest.mark.parametrize("artifact", ["port", "ref"])
def test_se_artifact_scores_like_the_fitted_ensemble(se_artifacts, artifact):
    """Either package's artifact, scored by the port's numpy scorer, gives
    the fitted ensemble's probabilities within 1e-5; and the reference's
    scorer reads the port's artifact the same."""
    a = se_artifacts[artifact]
    want = a["model"].predict(a["test"])
    got = mojo.load_model(a["path"]).predict(se_artifacts["port"]["test"])
    assert got.names == want.names == ["predict", "0", "1"]
    for col in ("0", "1"):
        np.testing.assert_allclose(np.asarray(got.vec(col).data, np.float64),
                                   np.asarray(want.vec(col).data, np.float64),
                                   rtol=0, atol=1e-5)
    if artifact == "port":
        ref_got = refmojo.load_model(a["path"]).predict(
            se_artifacts["ref"]["test"])
        np.testing.assert_allclose(
            np.asarray(ref_got.vec("1").data, np.float64),
            np.asarray(want.vec("1").data, np.float64), rtol=0, atol=1e-5)


def test_se_artifact_reexports_losslessly(se_artifacts, tmp_path):
    path = se_artifacts["port"]["path"]
    again = mojo.save_model(mojo.load_model(path), str(tmp_path), "again.h2o3")
    with zipfile.ZipFile(path) as z0, zipfile.ZipFile(again) as z1:
        assert sorted(z0.namelist()) == sorted(z1.namelist())
        for name in z0.namelist():
            if name.endswith(".json"):
                assert json.loads(z0.read(name)) == json.loads(z1.read(name))
