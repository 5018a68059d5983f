"""The estimator engine's blocks lane against the reference's, on the CPU.

Under ``H2O3_EST_SHARD=1`` (S = 8 ordered row blocks, their partials
folded left to right) the port and the reference — on a one-device cloud
(`cloud1`) — fit the same numpy-seeded frames:

- GLM, binomial and gaussian (the fused IRLS, its Gram one augmented
  product a block): β within BETA_TOL·max(1, |β|);
- K-Means (Furthest, standardized, a categorical column): centres and the
  training WSS within `UNSUP_SMALL_TOLS`' 1e-5;
- PCA GramSVD (STANDARDIZE and DEMEAN): eigenvalues within 1e-5 relative,
  eigenvectors within 1e-4 up to sign.

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
from h2o3_tpu_torch.estimators import (H2OGeneralizedLinearEstimator,
                                       H2OKMeansEstimator,
                                       H2OPrincipalComponentAnalysisEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import estimator_engine as est

from test_torch_deeplearning import one_torch_thread  # noqa: F401

BETA_TOL = 1e-5
CENTER_TOL = SS_TOL = 1e-5            # chip_smoke's UNSUP_SMALL_TOLS
EIG_REL, EVEC_TOL = 1e-5, 1e-4
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
    return d


def _frames(d):
    types = {"cat": "enum", "yb": "enum"}
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
