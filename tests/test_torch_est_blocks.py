"""The estimator engine's blocks lane against the reference's, on the CPU.

Under ``H2O3_EST_SHARD=1`` (S = 8 ordered row blocks, their partials
folded left to right) the port and the reference — on a one-device cloud
(`cloud1`) — fit the same numpy-seeded frames:

- GLM, binomial and gaussian (the fused IRLS, its Gram one augmented
  product a block): β within BETA_TOL·max(1, |β|);
- K-Means (Furthest, standardized, a categorical column): centres and the
  training WSS within `UNSUP_SMALL_TOLS`' 1e-5;
- PCA GramSVD (STANDARDIZE and DEMEAN): eigenvalues within 1e-5 relative,
  eigenvectors within 1e-4 up to sign;
- λ search, binomial with a validation frame and gaussian without: the
  same λ list, λ_best and plan iterations, every λ's β and the re-solved β
  within 1e-4, predictions within 1e-5 (`test_torch_glm.py`'s bars);
- the multinomial GLM (3 classes, a ridge): β centred over the classes
  within 3e-4, probabilities within 1e-4 (`test_torch_glm_multinomial.py`'s);
- K-Means from `user_points`: centres 1e-5, the same iteration count and
  assignments, WSS 1e-5 relative (`test_torch_kmeans.py`'s); PCA
  Randomized, whose tall-skinny QR gives another Q than the reference's
  one QR of Y but the same subspace, at PCA's bars; SVD GramSVD, Power and
  Randomized under NONE and DEMEAN: d, v and u within 1e-4
  (`test_torch_pca_svd.py`'s).

Each fit's `record_fit` path is the reference's ("fused_blocks"), with the
same shard count. The two packages fold the same blocks but round their
products in their own orders (XLA's dot against BLAS), so the lanes are
compared within tolerances; the port's pod lane is held to the port's
blocks lane bit for bit in `test_torch_est_pod.py`.
"""

import numpy as np
import pytest

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import estimator_engine as refest
from h2o3_tpu.models.glm import H2OGeneralizedLinearEstimator as RefGLM
from h2o3_tpu.models.kmeans import H2OKMeansEstimator as RefKMeans
from h2o3_tpu.models.pca import \
    H2OPrincipalComponentAnalysisEstimator as RefPCA
from h2o3_tpu.models.svd import \
    H2OSingularValueDecompositionEstimator as RefSVD
from h2o3_tpu_torch.estimators import (
    H2OGeneralizedLinearEstimator, H2OKMeansEstimator,
    H2OPrincipalComponentAnalysisEstimator,
    H2OSingularValueDecompositionEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import estimator_engine as est

from test_torch_deeplearning import one_torch_thread  # noqa: F401

BETA_TOL = 1e-5
CENTER_TOL = SS_TOL = 1e-5            # chip_smoke's UNSUP_SMALL_TOLS
EIG_REL, EVEC_TOL = 1e-5, 1e-4
PATH_TOL, PRED_TOL = 1e-4, 1e-5        # test_torch_glm.py's
MN_BETA_TOL, MN_PROB_TOL = 3e-4, 1e-4  # test_torch_glm_multinomial.py's
SVD_TOL = 1e-4                         # test_torch_pca_svd.py's
N = 3001                               # not a multiple of S: pad rows


def _frame_dict(seed: int):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, 4)) * [1.0, 3.0, 0.5, 2.0] + [0.0, 5.0, -1.0,
                                                         2.0]
    cat = rng.integers(0, 3, size=N)
    eff = 0.9 * X[:, 0] - 0.3 * X[:, 1] + 0.5 * (cat == 1)
    d = {f"x{i}": X[:, i] for i in range(4)}
    d["cat"] = np.asarray([f"k{v}" for v in cat])
    d["yb"] = np.asarray(["no", "yes"])[
        (rng.random(N) < 1 / (1 + np.exp(-eff))).astype(int)]
    d["yg"] = eff + 0.2 * rng.normal(size=N)
    # three classes from a softmax over class scores (none separable)
    score = np.column_stack([X[:, 0], 0.5 * X[:, 1] - X[:, 2], 0 * eff])
    d["ym"] = np.asarray(["a", "b", "c"])[np.argmax(
        score + rng.gumbel(size=(N, 3)), axis=1)]
    return d


def _frames(d):
    types = {"cat": "enum", "yb": "enum", "ym": "enum"}
    return (RefFrame.from_dict(d, column_types=types),
            Frame.from_dict(d, column_types=types))


def _plans():
    p, r = est.est_stats()["plans"][-1], refest.est_stats()["plans"][-1]
    return p, r


@pytest.fixture
def blocks_lane(monkeypatch):
    monkeypatch.setenv("H2O3_EST_SHARD", "1")
    monkeypatch.setenv("H2O3_EST_SHARD_BLOCKS", "8")
    monkeypatch.setenv("H2O3_DATASET_CACHE", "0")


def test_glm_blocks_lane_matches_the_reference(blocks_lane, cloud1,
                                               one_torch_thread):  # noqa: F811
    rf, pf = _frames(_frame_dict(0))
    x = ["x0", "x1", "x2", "x3", "cat"]
    for y, kw in (("yb", dict(family="binomial", lambda_=1e-3, alpha=0.0)),
                  ("yg", dict(family="gaussian", lambda_=1e-2, alpha=0.0,
                              standardize=False)),
                  ("yb", dict(family="binomial", lambda_=0.0,
                              standardize=False))):
        ref = RefGLM(**kw).train(x=x, y=y, training_frame=rf).model
        got = H2OGeneralizedLinearEstimator(device="cpu", **kw).train(
            x=x, y=y, training_frame=pf).model
        p, r = _plans()
        assert p["path"] == r["path"] == "fused_blocks", (p, r)
        assert p["n_shards"] == r["n_shards"] == 8
        want = np.asarray(ref.beta, np.float64)
        tol = BETA_TOL * np.maximum(1.0, np.abs(want))
        assert np.all(np.abs(np.asarray(got.beta) - want) <= tol), (
            kw, np.abs(np.asarray(got.beta) - want).max())


def test_kmeans_and_pca_blocks_lanes_match_the_reference(
        blocks_lane, cloud1, one_torch_thread):  # noqa: F811
    d = _frame_dict(1)
    # separated clusters in x0/x1, so the assignments are not near ties
    g = np.repeat(np.arange(3), -(-N // 3))[:N]
    d["x0"] = d["x0"] + 8.0 * g
    d["x1"] = d["x1"] - 6.0 * g
    rf, pf = _frames(d)
    x = ["x0", "x1", "x2", "x3", "cat"]
    kw = dict(k=3, init="Furthest", seed=11, max_iterations=20)
    ref = RefKMeans(**kw).train(x=x, training_frame=rf).model
    got = H2OKMeansEstimator(device="cpu", **kw).train(
        x=x, training_frame=pf).model
    p, r = _plans()
    assert p["path"] == r["path"] == "fused_blocks", (p, r)
    assert p["n_shards"] == r["n_shards"] == 8
    np.testing.assert_allclose(got.centers_std, np.asarray(ref.centers_std),
                               rtol=0, atol=CENTER_TOL)
    np.testing.assert_allclose(got.training_metrics.tot_withinss,
                               ref.training_metrics.tot_withinss,
                               rtol=SS_TOL)
    for transform in ("STANDARDIZE", "DEMEAN"):
        kw = dict(k=3, transform=transform)
        ref = RefPCA(**kw).train(x=x, training_frame=rf).model
        got = H2OPrincipalComponentAnalysisEstimator(device="cpu", **kw) \
            .train(x=x, training_frame=pf).model
        p, r = _plans()
        assert p["path"] == r["path"] == "fused_blocks", (p, r)
        np.testing.assert_allclose(got.eigenvalues, ref.eigenvalues,
                                   rtol=EIG_REL)
        gv, rv = np.asarray(got.eigenvectors), np.asarray(ref.eigenvectors)
        sign = np.sign((gv * rv).sum(axis=0))
        np.testing.assert_allclose(gv * sign, rv, rtol=0, atol=EVEC_TOL)


def _cols(frame, names):
    return np.column_stack([np.asarray(frame.vec(n).data, np.float64)
                            for n in names])


def test_lambda_search_and_multinomial_blocks_lanes_match_the_reference(
        blocks_lane, cloud1, one_torch_thread):  # noqa: F811
    rf, pf = _frames(_frame_dict(0))
    rv, pv = _frames(_frame_dict(2))
    x = ["x0", "x1", "x2", "x3", "cat"]
    for y, kw, valid in (
            ("yb", dict(family="binomial", alpha=0.5), True),
            ("yg", dict(family="gaussian", alpha=0.5, standardize=False),
             False)):
        kw = dict(kw, lambda_search=True, nlambdas=8)
        ref = RefGLM(**kw).train(x=x, y=y, training_frame=rf,
                                 validation_frame=rv if valid else None)
        got = H2OGeneralizedLinearEstimator(device="cpu", **kw).train(
            x=x, y=y, training_frame=pf,
            validation_frame=pv if valid else None)
        p, r = _plans()
        assert p["path"] == r["path"] == "fused_path", (p, r)
        assert p["iterations"] == r["iterations"] == 8
        assert p["n_shards"] == 8
        rpath = RefGLM.getGLMRegularizationPath(ref.model)
        ppath = H2OGeneralizedLinearEstimator.getGLMRegularizationPath(
            got.model)
        np.testing.assert_allclose(ppath["lambdas"], rpath["lambdas"],
                                   rtol=1e-5)
        assert got.model.lambda_best == pytest.approx(ref.model.lambda_best,
                                                      rel=1e-5)
        for pc, rc in zip(ppath["coefficients"], rpath["coefficients"]):
            np.testing.assert_allclose(list(pc.values()), list(rc.values()),
                                       rtol=PATH_TOL, atol=PATH_TOL)
        np.testing.assert_allclose(got.model.beta, ref.model.beta,
                                   rtol=PATH_TOL, atol=PATH_TOL)
        names = ["yes"] if y == "yb" else ["predict"]
        np.testing.assert_allclose(_cols(got.predict(pv), names),
                                   _cols(ref.predict(rv), names),
                                   rtol=PRED_TOL, atol=PRED_TOL)
    kw = dict(family="multinomial", alpha=0.0, lambda_=1e-3)
    ref = RefGLM(**kw).train(x=x, y="ym", training_frame=rf).model
    got = H2OGeneralizedLinearEstimator(device="cpu", **kw).train(
        x=x, y="ym", training_frame=pf).model
    assert _plans()[0]["n_shards"] == 8
    rb, pb = np.asarray(ref.beta), np.asarray(got.beta)
    np.testing.assert_allclose(pb - pb.mean(axis=0), rb - rb.mean(axis=0),
                               rtol=0, atol=MN_BETA_TOL)
    names = ["a", "b", "c"]
    np.testing.assert_allclose(_cols(got.predict(pv), names),
                               _cols(ref.predict(rv), names), rtol=0,
                               atol=MN_PROB_TOL)


def test_user_points_randomized_and_svd_blocks_lanes_match_the_reference(
        blocks_lane, cloud1, one_torch_thread):  # noqa: F811
    d = _frame_dict(1)
    # separated clusters in x0/x1, so the assignments are not near ties
    g = np.repeat(np.arange(3), -(-N // 3))[:N]
    d["x0"] = d["x0"] + 8.0 * g
    d["x1"] = d["x1"] - 6.0 * g
    rf, pf = _frames(d)
    x = ["x0", "x1", "x2", "x3"]
    pts = np.asarray([[-1.0, 1.0, 0.0, 0.5], [0.2, -0.1, 0.3, -0.5],
                      [1.0, -1.0, -0.2, 0.0]])
    kw = dict(k=3, user_points=pts, max_iterations=30)
    ref = RefKMeans(**kw).train(x=x, training_frame=rf).model
    ref_iters = refest.est_stats()["plans"][-1]["iterations"]
    got = H2OKMeansEstimator(device="cpu", **kw).train(
        x=x, training_frame=pf).model
    p = est.est_stats()["plans"][-1]
    assert p["path"] == "fused_blocks" and p["n_shards"] == 8
    assert got.iterations == ref_iters < 30
    np.testing.assert_allclose(got.centers_std, np.asarray(ref.centers_std),
                               rtol=0, atol=CENTER_TOL)
    np.testing.assert_array_equal(
        got.predict(pf).vec("predict").numeric_np(),
        ref.predict(rf).vec("predict").numeric_np())
    np.testing.assert_allclose(got.training_metrics.tot_withinss,
                               ref.training_metrics.tot_withinss,
                               rtol=SS_TOL)
    x = ["x0", "x1", "x2", "x3", "cat"]
    for transform in ("STANDARDIZE", "DEMEAN"):
        kw = dict(k=3, transform=transform, pca_method="Randomized", seed=5)
        ref = RefPCA(**kw).train(x=x, training_frame=rf).model
        got = H2OPrincipalComponentAnalysisEstimator(device="cpu", **kw) \
            .train(x=x, training_frame=pf).model
        p, r = _plans()
        assert p["path"] == "fused_blocks" and p["n_shards"] == 8
        np.testing.assert_allclose(got.eigenvalues, ref.eigenvalues,
                                   rtol=EIG_REL)
        gv, rv = np.asarray(got.eigenvectors), np.asarray(ref.eigenvectors)
        sign = np.sign((gv * rv).sum(axis=0))
        np.testing.assert_allclose(gv * sign, rv, rtol=0, atol=EVEC_TOL)
    for method in ("GramSVD", "Power", "Randomized"):
        for transform in ("NONE", "DEMEAN"):
            kw = dict(nv=3, svd_method=method, transform=transform, seed=4)
            ref = RefSVD(**kw).train(x=x, training_frame=rf).model
            got = H2OSingularValueDecompositionEstimator(
                device="cpu", **kw).train(x=x, training_frame=pf).model
            p = est.est_stats()["plans"][-1]
            assert p["path"] == "fused_blocks" and p["n_shards"] == 8
            where = (method, transform)
            assert np.all(np.abs(got.d - ref.d) <= SVD_TOL * ref.d), where
            assert np.abs(got.v - ref.v).max() <= SVD_TOL, where
            assert np.abs(got.u - ref.u).max() <= SVD_TOL, where
