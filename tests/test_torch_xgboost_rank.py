"""XGBoost's `rank:ndcg` in the port against the JAX package, on the CPU.

- The lambdarank pass (`_lambdarank_pass`) on the same margins as the
  reference's, with tied margins, a one-document query and pad rows: g and
  h within 1e-6 of the largest |g| and h. The port's size-sorted chunks
  (a small pair bound, many chunks) give the same bits as one chunk of
  every query padded to the largest group (the reference's layout).
- `metrics.ndcg_at_k`, grouped by a stable argsort, is bit-equal to the
  reference's per-query masks on random and on tied scores.
- The reference's own lambdarank fixture (`tests/test_automl.py:36-55`,
  60 queries × 20 documents × 5 features): the first tree equal, the
  predictions within 1e-5, NDCG within 1e-6; 3-fold CV on the re-bin
  path, holdouts within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import xgboost as refxgb
from h2o3_tpu.models.metrics import ndcg_at_k as ref_ndcg
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import xgboost as portxgb
from h2o3_tpu_torch.models.metrics import ndcg_at_k

CPU = torch.device("cpu")


def _groups(seed, nq=60, max_size=40):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_size, nq)
    sizes[3] = 1                                  # a one-document query
    qid = np.repeat(rng.permutation(10 * nq)[:nq], sizes)
    rng.shuffle(qid)
    rel = rng.integers(0, 5, len(qid)).astype(np.float64)
    return rng, qid, rel


def test_lambdarank_pass_matches_the_reference():
    for seed, tied in ((0, True), (1, False)):
        rng, qid, rel = _groups(seed)
        pad = 13
        m = rng.normal(size=len(qid) + pad)
        m = (np.round(m, 1) if tied else m).astype(np.float32)
        gr, hr = refxgb._make_lambdarank(qid, rel, 10)(jnp.asarray(m), None)
        gr, hr = np.asarray(gr), np.asarray(hr)
        g, h = portxgb._make_lambdarank(qid, rel, 10, CPU)(torch.from_numpy(m), None)
        assert g.dtype == h.dtype == torch.float32
        assert g.shape == h.shape == (len(m),)
        np.testing.assert_allclose(g.numpy(), gr, rtol=0,
                                   atol=1e-6 * np.abs(gr).max())
        np.testing.assert_allclose(h.numpy(), hr, rtol=0,
                                   atol=1e-6 * np.abs(hr).max())
        assert np.isfinite(g.numpy()).all() and (h.numpy() >= 1e-6).all()
        np.testing.assert_array_equal(g.numpy()[-pad:], 0.0)
        np.testing.assert_array_equal(h.numpy()[-pad:], np.float32(1e-6))
        # the one-document query has no pairs
        one = np.flatnonzero(np.isin(qid, [q for q in np.unique(qid)
                                           if (qid == q).sum() == 1]))
        assert one.size and (g.numpy()[one] == 0).all()
        # chunking: many size-sorted chunks vs one chunk padded to the
        # largest group, bit for bit
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(portxgb, "PAIR_CHUNK", 300)
            chunks = portxgb.rank_chunks(qid, rel, 10, CPU)
            many = portxgb._make_lambdarank(qid, rel, 10, CPU)
        assert len(chunks) > 10
        assert [c.idx.shape[1] for c in chunks] == sorted(
            c.idx.shape[1] for c in chunks)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(portxgb, "PAIR_CHUNK", 1 << 62)
            mp.setattr(portxgb, "PAD_GROWTH", float("inf"))
            assert len(portxgb.rank_chunks(qid, rel, 10, CPU)) == 1
            single = portxgb._make_lambdarank(qid, rel, 10, CPU)
        gm, hm = many(torch.from_numpy(m), None)
        gs, hs = single(torch.from_numpy(m), None)
        assert torch.equal(gm, g) and torch.equal(hm, h)
        assert torch.equal(gs, g) and torch.equal(hs, h)


def test_ndcg_at_k_is_bit_equal_to_the_reference():
    for seed in range(4):
        rng, qid, rel = _groups(seed, nq=80)
        for score in (rng.normal(size=len(qid)),
                      np.round(rng.normal(size=len(qid)), 1),
                      np.zeros(len(qid))):
            for k in (1, 5, 10):
                assert ndcg_at_k(rel, score, qid, k) == ref_ndcg(rel, score, qid, k)
        fq = qid.astype(np.float64)
        s = rng.normal(size=len(qid))
        assert ndcg_at_k(rel, s, fq, 10) == ref_ndcg(rel, s, fq, 10)


def _fixture():
    """tests/test_automl.py::test_xgboost_lambdarank_ndcg's frame."""
    rng = np.random.default_rng(3)
    nq, per_q = 60, 20
    rows = nq * per_q
    X = rng.normal(size=(rows, 5))
    rel_score = X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=rows)
    rel = np.digitize(rel_score, np.quantile(rel_score, [0.5, 0.75, 0.9])).astype(float)
    qid = np.repeat(np.arange(nq), per_q)
    return {**{f"f{i}": X[:, i] for i in range(5)},
            "qid": qid.astype(float), "rel": rel}


RANK = dict(ntrees=20, max_depth=4, eta=0.3, seed=4, objective="rank:ndcg",
            group_column="qid")


def test_rank_fixture_matches_the_reference():
    d = _fixture()
    x = [f"f{i}" for i in range(5)]
    mesh.init(jax.devices()[:1])
    try:
        rf = RefFrame.from_dict(d)
        ref = refxgb.H2OXGBoostEstimator(**RANK)
        ref.train(y="rel", training_frame=rf, x=x)
        pf = Frame.from_dict(d)
        port = H2OXGBoostEstimator(device="cpu", **RANK)
        port.train(y="rel", training_frame=pf, x=x)
        rm, pm = ref.model, port.model
        assert pm.f0 == rm.f0 == 0.0
        assert pm.x == rm.x == x
        for f in ("feat", "bin", "thr", "is_split"):
            np.testing.assert_array_equal(getattr(pm.forest[0], f).numpy()[0],
                                          np.asarray(getattr(rm.forest[0], f))[0])
        np.testing.assert_allclose(pm.forest[0].value.numpy()[0],
                                   np.asarray(rm.forest[0].value)[0],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(port.predict(pf).vec("predict").numeric_np(),
                                   ref.predict(rf).vec("predict").numeric_np(),
                                   rtol=0, atol=1e-5)
        assert abs(port.ndcg(pf) - ref.ndcg(rf)) <= 1e-6
        assert port.ndcg(pf) > 0.8
        assert pm.training_metrics.description.startswith("NDCG@10=")
        assert pm.training_metrics.description == rm.training_metrics.description
        # ranking folds re-bin their frames and rebuild the query groups;
        # 32 bins, so that no fold tree splits between empty bins (where
        # the two packages' thresholds part holdout rows differently)
        cv = dict(RANK, ntrees=5, nfolds=3, max_bins=32,
                  keep_cross_validation_predictions=True)
        ref = refxgb.H2OXGBoostEstimator(**cv)
        ref.train(y="rel", training_frame=rf, x=x)
        port = H2OXGBoostEstimator(device="cpu", **cv)
        port.train(y="rel", training_frame=pf, x=x)
        assert not port._cv_can_reuse()
        np.testing.assert_allclose(port.model._cv_holdout_pred,
                                   ref.model._cv_holdout_pred, rtol=0, atol=1e-5)
    finally:
        mesh.reset()
    with pytest.raises(ValueError, match="needs group_column"):
        H2OXGBoostEstimator(device="cpu", **dict(RANK, group_column="query")
                            ).train(y="rel", training_frame=pf, x=x)
