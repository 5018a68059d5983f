"""XGBoost's leaf-wise growth (`grow_policy="lossguide"`) in the port
(`h2o3_tpu_torch/models/tree.py::build_tree_lossguide` through
`H2OXGBoostEstimator`) against the reference's, on the CPU.

- Trees equal on tie-free fixtures (64 bins), binomial and regression: the
  split feature, bin, threshold and split flag of every heap node, values
  within LG_TOL = 1e-6, predictions within 1e-6, at `max_leaves` 5 and 12
  under depth caps 3 and 5, and with `reg_alpha`, `gamma` and
  `max_delta_step` (6,000 rows: at 3,000 one deep node of the regularized
  case holds an empty bin whose gain ties its neighbour's, and f32
  residues pick between them). `build_tree_lossguide` alone, on one
  (g, h): equal to the reference's function, and its histogram passes
  counted (one a split).
- The leaf cap and the depth cap (`tests/test_xgboost.py:35-53`), and
  lossguide equal to depthwise when `max_leaves >= 2^depth`
  (`tests/test_xgboost.py:56-68`) within the reference's own tolerance.
- Lossguide with `monotone_constraints` raises the reference's
  `ValueError`; the other parameter checks are in
  `tests/test_torch_xgboost.py`.
- The fit's histogram plan is the reference's `[("lossguide_node", 1)]`,
  the MOJO of a lossguide forest scores within 1e-6 of `predict`, and a
  carried reference forest (`convert.forest_from_numpy`) predicts as the
  reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import tree as reftree
from h2o3_tpu.models.xgboost import H2OXGBoostEstimator as RefXGB
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import tree as treelib
from h2o3_tpu_torch.ops import histogram

from test_torch_deeplearning import one_torch_thread  # noqa: F401

F = 8
X_NAMES = [f"f{i}" for i in range(F)]
LG_TOL = 1e-6


def _data(n, seed, kind):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    noise = rng.normal(size=n)
    d = {f"f{i}": X[:, i] for i in range(F)}
    if kind == "binomial":
        y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * noise) > 0
        d["y"] = y.astype(int).astype(str)
    else:
        d["y"] = (2.0 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] ** 2
                  + 0.3 * noise).astype(np.float32)
    return d


def _frames(d):
    ct = {"y": "enum"} if d["y"].dtype.kind in "UO" else None
    return (RefFrame.from_dict(d, column_types=ct),
            Frame.from_dict(d, column_types=ct))


def _fit(params, d):
    rf, pf = _frames(d)
    ref = RefXGB(**params)
    ref.train(x=X_NAMES, y="y", training_frame=rf)
    port = H2OXGBoostEstimator(device="cpu", **params)
    port.train(x=X_NAMES, y="y", training_frame=pf)
    return ref.model, port.model, rf, pf


def _pred(fr):
    return {n: np.asarray(fr.vec(n).data, np.float64) for n in fr.names
            if fr.vec(n).type != "enum"}


def _assert_forests_equal(pm, rm):
    assert pm.ntrees_built == rm.ntrees_built
    for pf_, rf_ in zip(pm.forest, rm.forest):
        for f in ("feat", "bin", "thr", "is_split"):
            np.testing.assert_array_equal(getattr(pf_, f).numpy(),
                                          np.asarray(getattr(rf_, f)), err_msg=f)
        np.testing.assert_allclose(pf_.value.numpy(), np.asarray(rf_.value),
                                   rtol=0, atol=LG_TOL)


CASES = {
    "binomial_l5_d3": ("binomial", dict(max_leaves=5, max_depth=3)),
    "binomial_l12_d5": ("binomial", dict(max_leaves=12, max_depth=5,
                                         reg_alpha=0.5, gamma=0.1,
                                         max_delta_step=2.0)),
    "regression_l12_d5": ("regression", dict(max_leaves=12, max_depth=5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lossguide_trees_equal(cloud1, case):
    kind, extra = CASES[case]
    params = dict(ntrees=6, seed=3, max_bins=64, grow_policy="lossguide",
                  **extra)
    rm, pm, rf, pf = _fit(params, _data(6000, 1, kind))
    _assert_forests_equal(pm, rm)
    leaves = pm.forest[0].is_split.sum(dim=1) + 1
    assert int(leaves.max()) == extra["max_leaves"]
    got, want = _pred(pm.predict(pf)), _pred(rm.predict(rf))
    for c in want:
        np.testing.assert_allclose(got[c], want[c], rtol=0, atol=LG_TOL)
    assert pm.hist_plan == [("lossguide_node", 1)]


def test_build_tree_lossguide_alone_and_its_passes(cloud1):
    rng = np.random.default_rng(5)
    N, nb = 2000, 33
    codes = rng.integers(0, nb, size=(N, F)).astype(np.uint8)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.uniform(0.2, 1.0, N).astype(np.float32)
    w = (rng.random(N) < 0.9).astype(np.float32)
    edges = np.sort(rng.normal(size=(F, nb - 2)), axis=1).astype(np.float32)
    fm = np.ones(F, np.float32)
    fm[3] = 0.0
    kw = dict(max_depth=4, nbins=nb, max_leaves=9, min_rows=5.0,
              min_split_improvement=0.0, reg_lambda=1.0, reg_alpha=0.1)
    ref = reftree.build_tree_lossguide(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jnp.asarray(fm), jnp.asarray(edges), **kw)
    before = histogram.DISPATCH["segment"]
    got = treelib.build_tree_lossguide(
        torch.from_numpy(codes), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(w), torch.from_numpy(fm), torch.from_numpy(edges),
        **kw)
    splits = int(got[0].is_split.sum())
    assert splits == 8                               # max_leaves − 1
    assert histogram.DISPATCH["segment"] - before == 1 + splits
    for f in ("feat", "bin", "thr", "is_split"):
        np.testing.assert_array_equal(getattr(got[0], f).numpy(),
                                      np.asarray(getattr(ref[0], f)), err_msg=f)
    np.testing.assert_allclose(got[0].value.numpy(), np.asarray(ref[0].value),
                               rtol=0, atol=LG_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-6)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-6)
    assert 3 not in set(got[0].feat[got[0].is_split].tolist())  # masked
    # a budget the data cannot fill stops early, and the tree is the same
    kw2 = dict(kw, max_leaves=16, min_rows=400.0)
    ref2 = reftree.build_tree_lossguide(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jnp.asarray(fm), jnp.asarray(edges), **kw2)
    before = histogram.DISPATCH["segment"]
    got2 = treelib.build_tree_lossguide(
        torch.from_numpy(codes), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(w), torch.from_numpy(fm), torch.from_numpy(edges),
        **kw2)
    splits2 = int(got2[0].is_split.sum())
    assert splits2 < 15
    assert histogram.DISPATCH["segment"] - before == 1 + splits2
    for f in ("feat", "bin", "is_split"):
        np.testing.assert_array_equal(getattr(got2[0], f).numpy(),
                                      np.asarray(getattr(ref2[0], f)))
    np.testing.assert_array_equal(got2[1].numpy(), np.asarray(ref2[1]))


def test_nan_gain_slot_is_dropped_as_the_reference(cloud1):
    """reg_lambda = 0: a split whose left side holds only rows with g = h = 0
    has gain 0/0 = NaN, which the slot pick takes as the maximum. Here only
    the root's right child has such a split (rows with f0 > 12 and f1 < 3).
    The reference does not split that slot, sets its gain to -inf and goes
    on splitting the other slots; the tree must be the same."""
    rng = np.random.default_rng(11)
    N, nb, cut = 3000, 17, 12
    codes = rng.integers(0, nb, size=(N, F)).astype(np.uint8)
    codes[:nb, :] = np.arange(nb, dtype=np.uint8)[:, None]  # every bin used
    right = codes[:, 0] > cut
    zero = right & (codes[:, 1] < 3)
    g = (rng.normal(size=N) + 3.0 * right).astype(np.float32)
    h = rng.uniform(0.2, 1.0, N).astype(np.float32)
    g[zero], h[zero] = 0.0, 0.0
    w = np.ones(N, np.float32)
    edges = np.sort(rng.normal(size=(F, nb - 2)), axis=1).astype(np.float32)
    fm = np.ones(F, np.float32)
    kw = dict(max_depth=4, nbins=nb, max_leaves=10, min_rows=1.0,
              min_split_improvement=0.0, reg_lambda=0.0, reg_alpha=0.0)
    args = (codes, g, h, w, fm, edges)
    ref = reftree.build_tree_lossguide(*map(jnp.asarray, args), **kw)
    got = treelib.build_tree_lossguide(*map(torch.from_numpy, args), **kw)

    def best_gain(rows):
        hist = reftree.build_histograms(
            jnp.asarray(codes), jnp.zeros(N, jnp.int32), jnp.asarray(g),
            jnp.asarray(h), jnp.asarray(w * rows), 1, nb)
        return float(reftree._search_splits(hist, jnp.asarray(fm), nb, 1.0,
                                            0.0, 0.0)[0][0])

    assert np.isfinite(best_gain(np.ones(N, bool)))        # the root
    assert np.isnan(best_gain(right))                      # its right child
    rt = np.asarray(ref[0].is_split)
    assert rt[0] and int(np.asarray(ref[0].feat)[0]) == 0
    assert int(np.asarray(ref[0].bin)[0]) == cut and not rt[2]
    assert rt.sum() > 2                  # the other slots went on splitting
    for f in ("feat", "bin", "thr", "is_split"):
        np.testing.assert_array_equal(getattr(got[0], f).numpy(),
                                      np.asarray(getattr(ref[0], f)), err_msg=f)
    np.testing.assert_allclose(got[0].value.numpy(), np.asarray(ref[0].value),
                               rtol=0, atol=LG_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def _leaf_counts(model):
    return [int(t.sum()) + 1 for k in model.forest for t in k.is_split]


def test_leaf_and_depth_caps(cloud1):
    rf, pf = _frames(_data(4000, 0, "binomial"))
    for cls, fr in ((RefXGB, rf), (H2OXGBoostEstimator, pf)):
        kw = {} if cls is RefXGB else dict(device="cpu")
        a = cls(ntrees=8, max_depth=6, seed=1, grow_policy="lossguide",
                max_leaves=8, **kw)
        a.train(x=X_NAMES, y="y", training_frame=fr)
        leaves = _leaf_counts(a.model)
        assert 2 < max(leaves) <= 8, leaves
        assert float(a.auc()) > 0.85
        b = cls(ntrees=5, max_depth=2, seed=1, grow_policy="lossguide",
                max_leaves=64, **kw)
        b.train(x=X_NAMES, y="y", training_frame=fr)
        assert max(_leaf_counts(b.model)) <= 4


def test_lossguide_equals_depthwise_when_unconstrained(cloud1):
    rf, pf = _frames(_data(2000, 0, "binomial"))
    kw = dict(ntrees=4, max_depth=3, seed=7, min_rows=10)
    a = H2OXGBoostEstimator(device="cpu", **kw)
    a.train(x=X_NAMES, y="y", training_frame=pf)
    b = H2OXGBoostEstimator(device="cpu", grow_policy="lossguide",
                            max_leaves=8, **kw)
    b.train(x=X_NAMES, y="y", training_frame=pf)
    pa, pb = a.predict(pf).vec("1").numeric_np(), b.predict(pf).vec("1").numeric_np()
    np.testing.assert_allclose(pa, pb, rtol=1e-5, atol=1e-6)
    r = RefXGB(grow_policy="lossguide", max_leaves=8, **kw)
    r.train(x=X_NAMES, y="y", training_frame=rf)
    np.testing.assert_allclose(pb, r.predict(rf).vec("1").numeric_np(),
                               rtol=0, atol=LG_TOL)


def test_monotone_raises_mojo_and_convert(cloud1, tmp_path):
    d = _data(1500, 2, "regression")
    rf, pf = _frames(d)
    for est, fr in ((RefXGB(ntrees=2, grow_policy="lossguide", max_leaves=4), rf),
                    (H2OXGBoostEstimator(ntrees=2, grow_policy="lossguide",
                                         max_leaves=4, device="cpu"), pf)):
        est._parms["monotone_constraints"] = {"f0": 1}
        with pytest.raises(ValueError, match="monotone_constraints"):
            est.train(x=X_NAMES, y="y", training_frame=fr)
    rm, pm, rf, pf = _fit(dict(ntrees=5, seed=2, max_bins=64, max_depth=4,
                               grow_policy="lossguide", max_leaves=6), d)
    path = mojo.save_model(pm, str(tmp_path), "lg.h2o3")
    want = pm.predict(pf).vec("predict").numeric_np()
    got = mojo.load_model(path).predict(pf).vec("predict").numeric_np()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rt = rm.forest[0]
    carried = convert.forest_from_numpy(
        feat=np.asarray(rt.feat), bin=np.asarray(rt.bin),
        thr=np.asarray(rt.thr), is_split=np.asarray(rt.is_split),
        value=np.asarray(rt.value), covers=np.asarray(rm.covers[0]),
        f0=rm.f0, edges=rm.bm.edges, max_depth=rm.max_depth, x=X_NAMES,
        y="y", nbins=rm.bm.nbins, problem="regression",
        distribution=rm.distribution, algo="xgboost", device="cpu")
    np.testing.assert_allclose(
        carried.predict(pf).vec("predict").numeric_np(),
        rm.predict(rf).vec("predict").numeric_np(), rtol=0, atol=1e-6)
