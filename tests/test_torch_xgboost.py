"""XGBoost in the port (`h2o3_tpu_torch/models/xgboost.py`) against the JAX
package's `H2OXGBoostEstimator`, on the same numpy-seeded frames, on the CPU.

- gbtree, binomial (the reference test's 4000 × 8 `_frame`, with
  `reg_alpha`, `max_delta_step` and `gamma`) at 256 and at 64 bins, and a
  4000-row 4-class multinomial: the same split features and split nodes,
  every training row in the same leaf of every tree, leaf values and
  predictions within 1e-5. Where no gain ties (64 bins) the bins and
  thresholds are equal too; at 256 bins on 4000 rows deep nodes hold empty
  bins, where f32 residues of sibling subtraction pick among thresholds
  that part the rows alike (so the leaves are compared, and a fresh row
  may differ from the reference's prediction only where it lies between
  two such tied thresholds).
- The leaf totals: on the CPU, as on the card, exact integer sums
  (`tree._fixed_totals`). The multinomial fixture's first-round leaves (a
  leaf of 2,176 rows of one softmax gradient at 4000 rows) are the Newton
  steps of f64 sums within 2e-6 relative, and equal the card's path bit
  for bit.
- DART, both `normalize_type`s: the same, and `skip_drop=1` gives the
  gbtree forest bit for bit.
- gblinear, gaussian / binomial / multinomial: β within 1e-4 of the
  reference's, `reg_alpha` zeroing the same coefficients, the distribution
  mismatch's `ValueError`, and 3-fold CV on the re-bin path.
- The reference's `ValueError` cases (`tests/test_xgboost.py:69-85`) raise
  `ValueError` here; a valid `lossguide` raises `NotImplementedError`
  naming its ROADMAP item.
- The surfaces: 3-fold CV holdouts on the fold-reuse path within 1e-5,
  TreeSHAP of a carried reference model within 1e-12, the MOJO loaded
  across both ways within 1e-5, served predictions equal to `predict`.
- The card's leaf totals (`tree._fixed_totals`), run on CPU tensors: the
  correctly rounded f64 sums, in any row order.
"""

import numpy as np
import pytest

import jax

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.xgboost import H2OXGBoostEstimator as RefXGB
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import tree as treelib
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig
import torch

F = 8
X_NAMES = [f"f{i}" for i in range(F)]


def _data(n, seed, kind):
    """The reference test's `_frame` (binomial); a 4-class and a
    regression response on the same law of X."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    noise = rng.normal(size=n)
    d = {f"f{i}": X[:, i] for i in range(F)}
    if kind == "binomial":
        y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * noise) > 0
        d["y"] = y.astype(int).astype(str)
    elif kind == "multinomial":
        s = X[:, 0] + 0.8 * X[:, 1] - 0.5 * X[:, 3] + 0.3 * noise
        d["y"] = np.asarray(["a", "b", "c", "d"])[np.digitize(s, [-1.0, 0.0, 1.0])]
    else:
        d["y"] = (2.0 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] + 0.3 * noise
                  ).astype(np.float32)
    return d


def _frames(d):
    ct = {"y": "enum"} if d["y"].dtype.kind in "UO" else None
    return (RefFrame.from_dict(d, column_types=ct),
            Frame.from_dict(d, column_types=ct))


def _fit(params, d, **train_kw):
    rf, pf = _frames(d)
    ref = RefXGB(**params)
    ref.train(x=X_NAMES, y="y", training_frame=rf, **train_kw)
    port = H2OXGBoostEstimator(device="cpu", **params)
    port.train(x=X_NAMES, y="y", training_frame=pf, **train_kw)
    return ref, port, rf, pf


def _pred_cols(fr):
    return {n: np.asarray(fr.vec(n).data, np.float64) for n in fr.names
            if fr.vec(n).type != "enum"}


def _assert_preds(port_fr, ref_fr, atol=1e-5):
    got, want = _pred_cols(port_fr), _pred_cols(ref_fr)
    assert list(got) == list(want)
    for c in want:
        np.testing.assert_allclose(got[c], want[c], rtol=0, atol=atol, err_msg=c)


def _assert_forests(port_model, ref_model, d, exact):
    """Split features and split nodes equal, each training row in the same
    leaf of every tree, leaf values within 1e-5; with `exact` the bins and
    thresholds too."""
    X = torch.from_numpy(np.column_stack([d[n] for n in X_NAMES]).astype(np.float64))
    assert port_model.ntrees_built == ref_model.ntrees_built
    assert len(port_model.forest) == len(ref_model.forest)
    for pf, rf in zip(port_model.forest, ref_model.forest):
        rt = treelib.Tree(*[torch.as_tensor(np.asarray(getattr(rf, f)))
                            for f in treelib.Tree._fields])
        assert np.asarray(rf.is_split).sum() > 10
        for f in ("feat", "is_split") + (("bin", "thr") if exact else ()):
            np.testing.assert_array_equal(getattr(pf, f).numpy(),
                                          np.asarray(getattr(rf, f)), err_msg=f)
        depth = ref_model.max_depth
        assert torch.equal(treelib.forest_leaves(pf, X, depth),
                           treelib.forest_leaves(rt, X, depth))
        np.testing.assert_allclose(pf.value.numpy(), np.asarray(rf.value),
                                   rtol=0, atol=1e-5)


def _walk_nodes(tree, X, depth):
    """(ntrees, N, depth) the heap node each row's walk reaches at each
    level of each tree (held at a leaf), on f32 rows as `predict` routes."""
    feat, thr = tree.feat.numpy(), tree.thr.numpy()
    split = tree.is_split.numpy()
    rows = np.arange(X.shape[0])
    out = np.zeros((feat.shape[0], X.shape[0], depth), np.int64)
    for t in range(feat.shape[0]):
        node = np.zeros(X.shape[0], np.int64)
        for lv in range(depth):
            out[t, :, lv] = node
            x = X[rows, feat[t][node]]
            right = np.isnan(x) | (x > thr[t][node])
            node = np.where(split[t][node], 2 * node + 1 + right, node)
    return out


def _assert_preds_up_to_ties(port_model, ref_model, d, dt, port_fr, ref_fr):
    """Fresh rows where the forests equal by leaves (not by thresholds):
    every split node whose two thresholds differ must part the training
    rows alike (no training row reaching it lies between the two: a gain
    tie in exact arithmetic, broken by f32 residues of sibling
    subtraction), and a fresh row may differ from the reference's
    prediction by more than 1e-5 only where it reaches such a node with its
    value between the two thresholds."""
    Xtr = np.column_stack([d[n] for n in X_NAMES]).astype(np.float32)
    Xte = np.column_stack([dt[n] for n in X_NAMES]).astype(np.float32)
    depth = ref_model.max_depth
    tied = np.zeros(len(Xte), bool)
    for pf, rf in zip(port_model.forest, ref_model.forest):
        pthr, rthr = pf.thr.numpy(), np.asarray(rf.thr)
        at_tr, at_te = (_walk_nodes(pf, Xtr, depth),
                        _walk_nodes(pf, Xte, depth))
        for t, k in zip(*np.nonzero(pf.is_split.numpy() & (pthr != rthr))):
            lo, hi = sorted((pthr[t, k], rthr[t, k]))
            f = int(pf.feat[t, k])
            v = Xtr[(at_tr[t] == k).any(axis=1), f]
            assert not ((v > lo) & (v <= hi)).any(), (t, k)
            tied |= ((at_te[t] == k).any(axis=1) & (Xte[:, f] > lo)
                     & (Xte[:, f] <= hi))
    got, want = _pred_cols(port_fr), _pred_cols(ref_fr)
    assert list(got) == list(want)
    off = np.zeros(len(Xte), bool)
    for c in want:
        off |= np.abs(got[c] - want[c]) > 1e-5
    assert not (off & ~tied).any(), np.nonzero(off & ~tied)[0]


GBTREE = dict(ntrees=5, max_depth=4, seed=1, reg_alpha=0.5,
              max_delta_step=0.7, gamma=0.1)
GBTREE_CASES = {
    "binomial_256": ("binomial", 4000, GBTREE, False),
    "binomial_64": ("binomial", 4000, dict(GBTREE, max_bins=64), True),
    "multinomial": ("multinomial", 4000, dict(ntrees=4, max_depth=3, seed=2,
                                              max_bins=64), True),
}


@pytest.fixture(scope="module")
def gbtree_fits():
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for case, (kind, n, params, exact) in GBTREE_CASES.items():
            d = _data(n, 0, kind)
            ref, port, rf, pf = _fit(params, d)
            dt = _data(700, 1, kind)
            rt, pt = _frames(dt)
            out[case] = dict(ref=ref, port=port, d=d, dt=dt, exact=exact,
                             rt=rt,
                             pt=pt, ref_pred=ref.predict(rt),
                             port_pred=port.predict(pt))
    finally:
        mesh.reset()
    return out


@pytest.mark.parametrize("case", list(GBTREE_CASES))
def test_gbtree_matches_the_reference(gbtree_fits, case):
    fx = gbtree_fits[case]
    ref, port = fx["ref"].model, fx["port"].model
    assert port.algo == ref.algo == "xgboost"
    _assert_forests(port, ref, fx["d"], fx["exact"])
    np.testing.assert_allclose(np.asarray(port.f0), np.asarray(ref.f0),
                               rtol=0, atol=1e-7)
    if case.startswith("binomial"):
        # reg_alpha reaches `build_tree`, and max_delta_step caps every
        # leaf at 0.7 × learn rate
        assert fx["port"]._tree_params()["reg_alpha"] == 0.5
        assert float(port.forest[0].value.abs().max()) <= 0.7 * 0.3 + 1e-6
    if fx["exact"]:
        _assert_preds(fx["port_pred"], fx["ref_pred"])
    else:
        _assert_preds_up_to_ties(port, ref, fx["d"], fx["dt"],
                                 fx["port_pred"], fx["ref_pred"])
    mp, mr = port.training_metrics, ref.training_metrics
    assert abs(float(mp.logloss) - float(mr.logloss)) <= 1e-5


def test_dart_matches_the_reference():
    """Dropout draws come from the reference's numpy generator in the same
    order, so both packages drop the same rounds; skip_drop=1 never drops
    and gives gbtree's forest bit for bit."""
    d = _data(2000, 0, "binomial")
    base = dict(ntrees=8, max_depth=3, seed=11, max_bins=64)
    mesh.init(jax.devices()[:1])
    try:
        for nt in ("tree", "forest"):
            params = dict(base, booster="dart", rate_drop=0.3, one_drop=True,
                          normalize_type=nt)
            ref, port, rf, pf = _fit(params, d)
            _assert_forests(port.model, ref.model, d, exact=True)
            _assert_preds(port.predict(pf), ref.predict(rf))
            assert abs(port.auc() - ref.auc()) <= 1e-5
            # the incrementally kept margins agree with the baked forest
            assert abs(port.auc() - port.model.model_performance(pf).auc) < 1e-3
    finally:
        mesh.reset()
    _, pf = _frames(d)
    gb = H2OXGBoostEstimator(device="cpu", **base)
    gb.train(x=X_NAMES, y="y", training_frame=pf)
    dart = H2OXGBoostEstimator(device="cpu", booster="dart", rate_drop=0.5,
                               skip_drop=1.0, **base)
    dart.train(x=X_NAMES, y="y", training_frame=pf)
    for a, b in zip(gb.model.forest[0], dart.model.forest[0]):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(gb.predict(pf).vec("1").numeric_np(),
                                  dart.predict(pf).vec("1").numeric_np())


def _beta(model):
    return np.asarray(model.beta, np.float64)


def test_gblinear_matches_the_reference():
    mesh.init(jax.devices()[:1])
    try:
        for kind in ("regression", "binomial", "multinomial"):
            d = _data(3000, 4, kind)
            params = dict(booster="gblinear", ntrees=30, reg_lambda=0.5)
            ref, port, rf, pf = _fit(params, d)
            assert port.model.algo == "xgboost"
            assert port.model.family == ref.model.family
            np.testing.assert_allclose(_beta(port.model), _beta(ref.model),
                                       rtol=0, atol=1e-4, err_msg=kind)
            _assert_preds(port.predict(pf), ref.predict(rf))
        # reg_alpha soft-thresholds: the same coefficients are exactly 0
        d = _data(3000, 4, "regression")
        ref, port, rf, pf = _fit(dict(booster="gblinear", ntrees=20,
                                      reg_alpha=400.0), d)
        zp, zr = _beta(port.model) == 0, _beta(ref.model) == 0
        assert zr[:-1].sum() >= 3
        np.testing.assert_array_equal(zp, zr)
        np.testing.assert_allclose(_beta(port.model), _beta(ref.model),
                                   rtol=0, atol=1e-4)
        # CV on the re-bin path (gblinear folds need the fold frame)
        d = _data(1500, 5, "binomial")
        cv = dict(booster="gblinear", ntrees=15, nfolds=3, seed=3,
                  keep_cross_validation_predictions=True)
        ref, port, rf, pf = _fit(cv, d)
        assert not port._cv_can_reuse()
        np.testing.assert_allclose(port.model._cv_holdout_pred,
                                   ref.model._cv_holdout_pred, rtol=0, atol=1e-5)
        assert abs(port.model.cross_validation_metrics.auc
                   - ref.model.cross_validation_metrics.auc) <= 1e-5
    finally:
        mesh.reset()
    _, pf = _frames(_data(300, 0, "binomial"))
    with pytest.raises(ValueError, match="inconsistent with the response"):
        H2OXGBoostEstimator(device="cpu", booster="gblinear",
                            distribution="gaussian").train(
            x=X_NAMES, y="y", training_frame=pf)


REF_VALUE_ERRORS = [
    dict(rate_drop=0.1),                       # DART param without dart
    dict(one_drop=True),
    dict(skip_drop=0.5),
    dict(booster="dart", rate_drop=1.5),       # out of range
    dict(booster="gbforest"),                  # unknown booster
    dict(booster="dart", normalize_type="bogus"),
    dict(grow_policy="bogus"),
    dict(max_leaves=16),                       # needs lossguide
    dict(grow_policy="lossguide", max_depth=0),
    dict(grow_policy="lossguide", max_leaves=1),
    dict(booster="gblinear", objective="rank:ndcg"),
    dict(booster="gblinear", distribution="poisson"),
]


def test_parameter_checks_raise_as_the_reference():
    d = _data(500, 0, "binomial")
    rf, pf = _frames(d)
    for params in REF_VALUE_ERRORS:
        with pytest.raises(ValueError):
            RefXGB(ntrees=2, **params).train(x=X_NAMES, y="y", training_frame=rf)
        with pytest.raises(ValueError):
            H2OXGBoostEstimator(ntrees=2, device="cpu", **params).train(
                x=X_NAMES, y="y", training_frame=pf)
    with pytest.raises(NotImplementedError, match="item 10: build_tree_lossguide"):
        H2OXGBoostEstimator(ntrees=2, device="cpu", grow_policy="lossguide",
                            max_leaves=8).train(x=X_NAMES, y="y",
                                                training_frame=pf)
    with pytest.raises(TypeError, match="unknown parameter"):
        H2OXGBoostEstimator(nbins=20)


def _cfg(**kw):
    return ServingConfig(**{**dict(
        max_batch_rows=4096, max_wait_ms=20.0, request_timeout_s=30.0,
        idle_worker_s=2.0, max_queue=64, model_inflight=64,
        retry_after_s=1.0, cache_capacity=8), **kw})


def test_surfaces_match_the_reference(tmp_path):
    """3-fold CV on the fold-reuse path, TreeSHAP of a carried reference
    model, the MOJO loaded across both ways (gbtree and gblinear), and the
    serving engine."""
    d = _data(2000, 7, "binomial")
    dt = _data(400, 8, "binomial")
    rt, pt = _frames(dt)
    mesh.init(jax.devices()[:1])
    try:
        params = dict(ntrees=6, max_depth=3, seed=9, max_bins=64, nfolds=3,
                      keep_cross_validation_predictions=True)
        ref, port, rf, pf = _fit(params, d)
        lin_ref, lin_port, _, _ = _fit(dict(booster="gblinear", ntrees=20), d)
        assert port._cv_can_reuse()
        np.testing.assert_allclose(port.model._cv_holdout_pred,
                                   ref.model._cv_holdout_pred, rtol=0, atol=1e-5)
        for cp, cr in zip(port.model.cross_validation_models,
                          ref.model.cross_validation_models):
            for f in ("feat", "bin", "is_split"):
                np.testing.assert_array_equal(getattr(cp.forest[0], f).numpy(),
                                              np.asarray(getattr(cr.forest[0], f)))
        # TreeSHAP of the reference's own forest, carried across
        m = ref.model
        carried = convert.forest_from_numpy(
            **{f: np.asarray(getattr(m.forest[0], f))
               for f in ("feat", "bin", "thr", "is_split", "value")},
            covers=np.asarray(m.covers[0]), f0=m.f0, edges=m.bm.edges,
            max_depth=m.max_depth, x=m.x, y=m.y, nbins=m.bm.nbins,
            domain=m.domain, problem=m.problem, distribution=m.distribution,
            mode=m.mode, algo=m.algo, device="cpu")
        assert carried.algo == "xgboost"
        want = m.predict_contributions(rt)
        got = carried.predict_contributions(pt)
        assert got.names == want.names
        for n in want.names:
            np.testing.assert_allclose(np.asarray(got.vec(n).data, np.float64),
                                       np.asarray(want.vec(n).data, np.float64),
                                       rtol=0, atol=1e-12, err_msg=n)
        # MOJO: each package loads the other's artifact
        for pm, rm in ((port.model, ref.model),
                       (lin_port.model, lin_ref.model)):
            pp = mojo.save_model(pm, str(tmp_path), f"port_{id(pm)}.h2o3")
            rp = refmojo.save_model(rm, str(tmp_path), f"ref_{id(rm)}.h2o3")
            assert mojo.load_model(pp).algo == refmojo.load_model(rp).algo == "xgboost"
            _assert_preds(refmojo.load_model(pp).predict(rt), pm.predict(pt))
            _assert_preds(mojo.load_model(rp).predict(pt), rm.predict(rt))
    finally:
        mesh.reset()
    eng = ScoringEngine(_cfg())
    try:
        for key, model in (("gbtree", port.model), ("gblinear", lin_port.model)):
            for lo, hi in ((0, 37), (37, 300), (300, 400)):
                sub = pt.take(np.arange(lo, hi))
                got = eng.score(key, model, sub)
                _assert_preds(got, model.predict(sub), atol=1e-6)
        snap = eng.snapshot()
        assert snap["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()


def test_card_leaf_totals_are_exact_and_order_free():
    """The card's leaf totals (`tree._fixed_totals`, int64 fixed point, run
    here on CPU tensors) equal the correctly rounded f64 sums and do not
    depend on the order of the rows: a card fit repeats bit for bit."""
    from h2o3_tpu_torch.models.tree import _fixed_totals

    rng = np.random.default_rng(3)
    n = 50_000
    ids = torch.from_numpy(rng.integers(0, 64, n))
    vals = torch.from_numpy(np.stack([
        (rng.random(n) < 0.7).astype(np.float32),
        rng.normal(size=n).astype(np.float32) * 1e3,
        rng.random(n).astype(np.float32)]))
    f64 = torch.zeros((64, 3), dtype=torch.float64).index_add_(
        0, ids, vals.t().double())
    got = _fixed_totals(ids, vals, 64)
    assert got.dtype == torch.float32
    assert torch.equal(got, f64.float())
    perm = torch.from_numpy(rng.permutation(n))
    assert torch.equal(_fixed_totals(ids[perm], vals[:, perm], 64), got)
    vals[1, 7] = float("nan")
    bad = _fixed_totals(ids, vals, 64)
    assert torch.isnan(bad[:, 1]).all() and torch.equal(bad[:, [0, 2]],
                                                         got[:, [0, 2]])


@pytest.mark.parametrize("n", [2000, 4000])
def test_cpu_leaf_values_are_f64_sums(n):
    """The 4-class fixture at eta 0.3 (its 4000 rows put 2,176 rows of one
    softmax gradient in a leaf of the first tree): each first-round leaf
    value on the CPU is the Newton step of the f64 sums of the rows' f32
    gradients, within 2e-6 relative (f32 `index_add_`, row by row, was
    3.8e-5 away there), and equals bit for bit what the card's exact
    totals (`tree._fixed_totals`) give on the same rows."""
    from h2o3_tpu_torch.models import distributions
    from h2o3_tpu_torch.models.tree import _fixed_totals

    d = _data(n, 0, "multinomial")
    port = H2OXGBoostEstimator(device="cpu", ntrees=1, max_depth=3, seed=2,
                               max_bins=64)
    port.train(x=X_NAMES, y="y", training_frame=Frame.from_dict(
        d, column_types={"y": "enum"}))
    model = port.model
    lam = port._tree_params()["reg_lambda"]
    eta = np.float32(0.3)
    X = torch.from_numpy(np.column_stack([d[c] for c in X_NAMES]))
    codes = torch.from_numpy(np.searchsorted(["a", "b", "c", "d"], d["y"]))
    onehot = torch.nn.functional.one_hot(codes, 4).float()
    margins = torch.as_tensor(np.asarray(model.f0, np.float32)).repeat(n, 1)
    biggest = 0
    for k, forest in enumerate(model.forest):
        # class k sees the margins that classes < k already moved
        p = distributions.softmax(margins)[:, k]
        g, h = p - onehot[:, k], p * (1 - p)
        leaf = treelib.forest_leaves(forest, X, model.max_depth)[0]
        value = forest.value[0]
        margins[:, k] += value[leaf]
        w = torch.ones(n)
        vals = torch.stack([w, g * w, h * w])
        f64 = torch.zeros((value.numel(), 3), dtype=torch.float64).index_add_(
            0, leaf, vals.t().double())
        hit = f64[:, 0] > 0
        want = -f64[:, 1] / (f64[:, 2] + lam + 1e-12) * float(eta)
        np.testing.assert_allclose(value[hit].double().numpy(),
                                   want[hit].numpy(), rtol=2e-6, atol=0)
        fixed = _fixed_totals(leaf, vals, value.numel())
        card = (-fixed[:, 1] / (fixed[:, 2] + lam + 1e-12)) * torch.tensor(eta)
        assert torch.equal(value[hit], card[hit])
        biggest = max(biggest, int(f64[:, 0].max()))
    assert biggest > (2000 if n == 4000 else 1000)
