"""The GBM/DRF class and constraint parameters of the port against the JAX
package, on the CPU: monotone constraints, per-class sample rates, class
balancing with its prior correction, and Platt/isotonic calibration
(`h2o3_tpu_torch/models/tree.py`, `shared_tree.py`).

Every case builds one numpy-seeded frame of at most 3,000 rows, fits it
through both packages (the reference on a one-device cloud) and states its
tolerance:

- monotone GBMs at depth 4 and at depth 14 under ``H2O3_COMPACT_CAP=256``
  (compaction stays off): split feature, bin and flag equal at every node,
  leaf values and predictions within 1e-5, no tree whose constrained
  splits break their order and no violation in a 64-point sweep of each
  constrained column; `_fused_level_best` with bounds bit-equal to the
  reference's on histograms of a 1/16 grid (every sum exact);
- per-class rates on a binomial GBM and a 3-class DRF with its out-of-bag
  metrics, within 1e-5;
- balancing: the fit's weights bit-equal (default factors, given factors,
  a binding cap), predictions, metrics and 3-fold CV holdouts within 1e-5;
- calibration: `cal_` columns within 1e-5, Platt's (a, b) and the isotonic
  knots bit-equal when fitted on the reference's p1, the reference's
  `ValueError`s;
- a reference model's new state carried by `forest_from_numpy` (1e-6), the
  MOJO member for member, and a served failover batch equal to `predict`
  (1e-6);
- a streamed fit with balancing and per-class rates equal to the blocks
  lane bit for bit;
- the parameters the reference never reads raise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import dataset_cache as ref_cache
from h2o3_tpu.models import shared_tree as ref_shared_tree
from h2o3_tpu.models import tree as ref_tree
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.automl import H2OAutoML
from h2o3_tpu_torch.estimators import (H2OGeneralizedLinearEstimator,
                                       H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import dataset_cache
from h2o3_tpu_torch.models import shared_tree
from h2o3_tpu_torch.models import tree as treelib
from h2o3_tpu_torch.runtime import faults
from h2o3_tpu_torch.serving import ScoringEngine, ServingConfig
from h2o3_tpu_torch.serving.model_cache import build_fallback_scorer

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

TOL = 1e-5
NAMES = ["a", "b", "c", "d", "y"]
MONO = {"a": 1, "b": -1}


@pytest.fixture(autouse=True)
def _clean():
    dataset_cache.clear()
    ref_cache.clear()
    mesh.init(jax.devices()[:1])
    yield
    mesh.reset()
    dataset_cache.clear()
    ref_cache.clear()
    faults.reset()


def _data(n, seed, kind):
    """(n, 5) columns a-d and a response: "regression" rises with a (with
    dips) and falls with b; "binomial" a rare class (about 12 %) of a and
    b; "multinomial" three classes of a and c."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    if kind == "regression":
        y = X[:, 0] + 0.6 * np.sin(4 * X[:, 0]) - 0.5 * X[:, 1] \
            + 0.3 * rng.normal(size=n)
    elif kind == "binomial":
        y = (X[:, 0] - 0.7 * X[:, 1] + 0.5 * rng.normal(size=n) > 1.5)
    else:
        s = X[:, 0] + 0.5 * X[:, 2] + 0.4 * rng.normal(size=n)
        y = np.digitize(s, [-0.8, 0.9])
    return np.column_stack([X, y.astype(np.float64)])


def _frames(d, kind):
    rf, pf = RefFrame.from_numpy(d, names=NAMES), Frame.from_numpy(d, names=NAMES)
    if kind != "regression":
        rf, pf = rf.asfactor("y"), pf.asfactor("y")
    return rf, pf


def _fit_both(algo, d, kind, ref_kw=None, **params):
    rf, pf = _frames(d, kind)
    ref_cls, port_cls = ((RefGBM, H2OGradientBoostingEstimator) if algo == "gbm"
                         else (RefDRF, H2ORandomForestEstimator))
    ref = ref_cls(**dict(params, **(ref_kw or {}).get("ref", {})))
    ref.train(y="y", training_frame=rf)
    port = port_cls(device="cpu", **dict(params, **(ref_kw or {}).get("port", {})))
    port.train(y="y", training_frame=pf)
    return ref.model, port.model, rf, pf


def _assert_forests(ref, port, tol=TOL):
    assert port.ntrees_built == ref.ntrees_built
    for k in range(len(port.forest)):
        rt, pt = ref.forest[k], port.forest[k]
        for f in ("feat", "bin", "is_split"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          np.asarray(getattr(rt, f)), err_msg=f)
        np.testing.assert_allclose(pt.value.numpy(), np.asarray(rt.value),
                                   rtol=0, atol=tol)


def _assert_predictions(ref, port, rf, pf, tol=TOL):
    rp, pp = ref.predict(rf), port.predict(pf)
    assert pp.names == rp.names
    for c in pp.names[1:] if pp.names[0] == "predict" and len(pp.names) > 1 \
            else pp.names:
        np.testing.assert_allclose(np.asarray(pp.vec(c).data, np.float64),
                                   np.asarray(rp.vec(c).data, np.float64),
                                   rtol=0, atol=tol, err_msg=c)
    return rp, pp


def sweep_violations(model, X, col, sign, points=64) -> int:
    """Rows whose prediction moves against `sign` along a sweep of column
    `col` over its range, the other columns held at the row's values."""
    grid = np.linspace(X[:, col].min(), X[:, col].max(), points)
    rows = np.repeat(X, points, axis=0)
    rows[:, col] = np.tile(grid, X.shape[0])
    fr = Frame.from_numpy(rows, names=NAMES[:X.shape[1]])
    p = np.asarray(model.predict(fr).vec("predict").data, np.float64)
    return int((sign * np.diff(p.reshape(X.shape[0], points), axis=1) < 0).sum())


def _fused_bounds_equal_the_reference():
    """`_fused_level_best` with monotone bounds on random histograms: every
    output bit-equal to the reference's (jit, λ and α traced as in its
    fit); the values lie on a 1/16 grid so every bin sum is exact."""
    rng = np.random.default_rng(3)
    L, F, B = 8, 6, 12
    ref_fn = jax.jit(lambda h, ok, fm, lam, al, g, hh, w, mono, lo, hi:
                     ref_tree._fused_level_best(
                         h, ok, fm, None, B, 1.0, lam, al, g, hh, w,
                         monotone=mono, lo_lvl=lo, hi_lvl=hi))
    for trial in range(12):
        hist = np.round(rng.normal(size=(L, F, B, 3)) * 16) / 16
        hist[..., 0] = rng.integers(0, 6, (L, F, B))
        hist[..., 2] = np.abs(hist[..., 2])
        hist = hist.astype(np.float32)
        tot = hist.sum(axis=2)[:, 0]
        ok = rng.random(L) < 0.9
        fm = (rng.random(F) < 0.9).astype(np.float32)
        mono = rng.integers(-1, 2, F).astype(np.float32)
        lo = (rng.normal(size=L) - 1).astype(np.float32)
        hi = (lo + 2 * np.abs(rng.normal(size=L))).astype(np.float32)
        if trial % 3 == 0:
            lo[:], hi[:] = -3.4e38, 3.4e38
        want = ref_fn(*map(jnp.asarray, (hist, ok, fm, np.float32(1.0),
                                         np.float32(0.1), tot[:, 1], tot[:, 2],
                                         tot[:, 0], mono, lo, hi)))
        t = torch.from_numpy
        got = treelib._fused_level_best(
            t(hist), t(ok), t(fm), None, B, 1.0, 1.0, 0.1, t(tot[:, 1]),
            t(tot[:, 2]), t(tot[:, 0]), monotone=t(mono), lo=t(lo), hi=t(hi))
        assert len(got) == len(want) == 5
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("depth", [4, 14])
def test_monotone_gbm_matches_the_reference(monkeypatch, depth):
    """A +1 and a −1 constraint: the forests agree node for node, every
    tree keeps its constraints, and a sweep of each constrained column
    never moves against it. At depth 14 the fit is dense whatever
    ``H2O3_COMPACT_CAP`` says (both packages read it)."""
    if depth == 4:
        _fused_bounds_equal_the_reference()
    monkeypatch.setenv("H2O3_COMPACT_CAP", "256")
    d = _data(1500, 7, "regression")
    ref, port, rf, pf = _fit_both(
        "gbm", d, "regression", ntrees=10 if depth == 4 else 3,
        max_depth=depth, seed=1, monotone_constraints=MONO)
    assert port.compact_cap == 0 and port.dense_rebuilds == 0
    _assert_forests(ref, port)
    _assert_predictions(ref, port, rf, pf)
    mono = [1.0, -1.0, 0.0, 0.0]
    assert treelib.monotone_violations(port.forest[0], mono) == 0
    X = d[:200, :4]
    assert sweep_violations(port, X, 0, 1) == 0
    assert sweep_violations(port, X, 1, -1) == 0
    # the unconstrained fit does break them, so the checks can fail
    free = H2OGradientBoostingEstimator(ntrees=10, max_depth=4, seed=1,
                                        device="cpu")
    free.train(y="y", training_frame=pf)
    assert treelib.monotone_violations(free.model.forest[0], mono) > 0


def test_sample_rate_per_class_matches_the_reference():
    """Per-class rates on a binomial GBM and on a 3-class DRF, whose
    training metrics are out-of-bag."""
    d = _data(2000, 11, "binomial")
    ref, port, rf, pf = _fit_both("gbm", d, "binomial", ntrees=8,
                                  max_depth=4, seed=3,
                                  sample_rate_per_class=[0.4, 1.0])
    _assert_forests(ref, port)
    _assert_predictions(ref, port, rf, pf)
    d = _data(2000, 12, "multinomial")
    ref, port, rf, pf = _fit_both("drf", d, "multinomial", ntrees=6,
                                  max_depth=6, seed=5,
                                  sample_rate_per_class=[0.5, 0.8, 1.0])
    _assert_forests(ref, port)
    _assert_predictions(ref, port, rf, pf)
    for k in ("logloss", "mse"):
        np.testing.assert_allclose(float(getattr(port.training_metrics, k)),
                                   float(getattr(ref.training_metrics, k)),
                                   rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="requires a categorical response"):
        H2OGradientBoostingEstimator(
            ntrees=1, device="cpu", sample_rate_per_class=[0.5, 1.0]).train(
                y="y", training_frame=Frame.from_numpy(
                    _data(100, 1, "regression"), names=NAMES))


def _record_weights(mp, module):
    """The weights each binomial fit of `module` starts from (its
    `init_margin` call)."""
    seen = []
    real = module.dist_mod.init_margin

    def rec(dist, y, w, **kw):
        seen.append(np.array(w))
        return real(dist, y, w, **kw)

    mp.setattr(module.dist_mod, "init_margin", rec)
    return seen


def test_balance_classes_matches_the_reference(monkeypatch):
    """The balanced weights bit-equal (default factors, given factors, a
    cap that binds), and a balanced binomial GBM with 3-fold CV and a
    balanced 3-class GBM within 1e-5: forests, corrected predictions,
    metrics and CV holdouts."""
    d = _data(2000, 21, "binomial")
    ref_w = _record_weights(monkeypatch, ref_shared_tree)
    port_w = _record_weights(monkeypatch, shared_tree)
    for extra in (dict(), dict(class_sampling_factors=[1.0, 3.0]),
                  dict(max_after_balance_size=0.25)):
        _fit_both("gbm", d, "binomial", ntrees=1, max_depth=1, seed=1,
                  balance_classes=True, **extra)
    assert len(ref_w) == len(port_w) == 3
    for a, b in zip(ref_w, port_w):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b[:len(a)], a)
    # the cap binds: the minority's factor stops at 0.25·n/count
    n1 = int(d[:, 4].sum())
    assert port_w[2].max() == np.float32(0.25 * 2000 / n1) < port_w[0].max()

    ref, port, rf, pf = _fit_both("gbm", d, "binomial", ntrees=8, max_depth=4,
                                  seed=1, balance_classes=True, nfolds=3)
    _assert_forests(ref, port)
    _assert_predictions(ref, port, rf, pf)
    for a, b in zip(port.balance_dists, ref.balance_dists):
        np.testing.assert_array_equal(a, b)
    for k in ("auc", "logloss"):
        np.testing.assert_allclose(float(getattr(port.training_metrics, k)),
                                   float(getattr(ref.training_metrics, k)),
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(port._cv_holdout_pred, ref._cv_holdout_pred,
                               rtol=0, atol=TOL)
    mp, mr = port._make_metrics(pf), ref._make_metrics(rf)
    np.testing.assert_allclose(float(mp.logloss), float(mr.logloss), rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError, match="balance_classes"):
        port.staged_predict_proba(pf)
    d = _data(2000, 22, "multinomial")
    ref, port, rf, pf = _fit_both("gbm", d, "multinomial", ntrees=4,
                                  max_depth=3, seed=2, balance_classes=True)
    _assert_forests(ref, port)
    _assert_predictions(ref, port, rf, pf)


def ref_calibrator(cal) -> dict:
    """The reference's calibration closure as `Calibrator` fields: Platt's
    (a, b) or the isotonic knots (tx, ty), read from its cells."""
    cells = {n: c.cell_contents
             for n, c in zip(cal.__code__.co_freevars, cal.__closure__)}
    if "a" in cells:
        return dict(method="PlattScaling", a=cells["a"], b=cells["b"])
    return dict(method="IsotonicRegression", knots_x=cells["tx"],
                knots_y=cells["ty"])


def test_calibration_matches_the_reference():
    """Platt scaling and isotonic regression on a 900-row calibration
    frame: the `cal_` columns within 1e-5; fitted on the reference's own
    p1, the port's (a, b) and knots equal the reference's bit for bit;
    the reference's `ValueError`s."""
    d = _data(3000, 31, "binomial")
    cal = d[2100:]
    rc, pc = _frames(cal, "binomial")
    for method in ("PlattScaling", "IsotonicRegression"):
        ref, port, rf, pf = _fit_both(
            "gbm", d[:2100], "binomial", ntrees=10, max_depth=4, seed=1,
            calibrate_model=True, calibration_method=method,
            ref_kw=dict(ref=dict(calibration_frame=rc),
                        port=dict(calibration_frame=pc)))
        _, pp = _assert_predictions(ref, port, rc, pc)
        assert pp.names == ["predict", "0", "1", "cal_0", "cal_1"]
        assert port.calibrator.method == method
        want = ref_calibrator(ref.calibrator)
        p1 = ref._score_probs(ref._matrix(rc))[:, 1]
        y = np.asarray(rc.vec("y").data, np.float64)
        refit = shared_tree.Calibrator.fit(method, p1, y)
        for k, v in want.items():
            if k != "method":
                np.testing.assert_array_equal(getattr(refit, k), v, err_msg=k)
                np.testing.assert_allclose(getattr(port.calibrator, k), v,
                                           rtol=0, atol=TOL, err_msg=k)
    reg = _frames(_data(200, 1, "regression"), "regression")[1]
    binom = _frames(_data(200, 1, "binomial"), "binomial")[1]
    for frame, kw, match in (
            (reg, {}, "only supported for binomial"),
            (binom, dict(calibration_method="Beta"),
             "unknown calibration_method 'Beta'")):
        with pytest.raises(ValueError, match=match):
            H2OGradientBoostingEstimator(
                ntrees=1, calibrate_model=True, calibration_frame=pc,
                device="cpu", **kw).train(y="y", training_frame=frame)


def test_new_state_carries_across_mojo_and_serving(tmp_path):
    """A reference GBM with balancing and Platt calibration carried across
    by `forest_from_numpy` predicts like the reference (1e-6, `cal_`
    columns included); the port's own model exports the reference's MOJO
    member for member (no correction, no calibrator, as the reference's);
    a served batch and a forced failover batch equal `predict` (1e-6)."""
    d = _data(2000, 41, "binomial")
    cal = _data(600, 42, "binomial")
    rc, pc = _frames(cal, "binomial")
    ref, port, rf, pf = _fit_both(
        "gbm", d, "binomial", ntrees=6, max_depth=4, seed=1,
        balance_classes=True, calibrate_model=True,
        ref_kw=dict(ref=dict(calibration_frame=rc),
                    port=dict(calibration_frame=pc)))
    st = ref.forest[0]
    carried = convert.forest_from_numpy(
        feat=np.asarray(st.feat), bin=np.asarray(st.bin),
        thr=np.asarray(st.thr), is_split=np.asarray(st.is_split),
        value=np.asarray(st.value), covers=np.asarray(ref.covers[0]),
        f0=ref.f0, edges=ref.bm.edges, max_depth=ref.max_depth, x=ref.x,
        y=ref.y, nbins=ref.bm.nbins, domain=ref.domain, problem=ref.problem,
        distribution=ref.distribution, balance_dists=ref.balance_dists,
        calibrator=ref_calibrator(ref.calibrator), device="cpu")
    got, want = carried.predict(pc), ref.predict(rc)
    assert got.names == want.names == ["predict", "0", "1", "cal_0", "cal_1"]
    for c in got.names[1:]:
        np.testing.assert_allclose(np.asarray(got.vec(c).data),
                                   np.asarray(want.vec(c).data),
                                   rtol=0, atol=1e-6, err_msg=c)

    ref_names, ref_meta, ref_arrays = _members(
        refmojo.save_model(ref, str(tmp_path), "ref.h2o3"))
    names, meta, arrays = _members(mojo.save_model(port, str(tmp_path),
                                                   "port.h2o3"))
    assert names == ref_names and sorted(arrays) == sorted(ref_arrays)
    meta.pop("model_id"), ref_meta.pop("model_id")
    assert meta == ref_meta

    fn, kind = build_fallback_scorer(port, "predict")
    assert kind == "mojo-cpu"
    eng = ScoringEngine(ServingConfig(max_wait_ms=1.0, breaker_reset_s=30.0))
    want = port.predict(pc)
    outs = [fn(pc), eng.score("bal", port, pc)]
    faults.arm("serving.scorer", error="device", rate=1.0)
    outs.append(eng.score("bal", port, pc))
    assert eng.snapshot()["totals"]["fallback_scores"] >= 1
    eng.shutdown()
    for out in outs:
        assert out.names == want.names
        assert list(out.vec("predict").to_numpy()) == \
            list(want.vec("predict").to_numpy())
        for c in want.names[1:]:
            np.testing.assert_allclose(np.asarray(out.vec(c).data),
                                       np.asarray(want.vec(c).data),
                                       rtol=0, atol=1e-6, err_msg=c)


def test_streamed_fit_with_balance_and_rates_equals_the_blocks_lane(monkeypatch):
    """``H2O3_TREE_OOC=1`` at S = 4 with balanced weights and per-class
    rates (a GBM) and per-class rates with out-of-bag metrics (a DRF)
    equals the blocks lane at S = 4 bit for bit."""
    stream = {"H2O3_TREE_OOC": "1", "H2O3_STREAM_BLOCKS": "4",
              "H2O3_STREAM_BUDGET_MB": "0.02"}
    blocks = {"H2O3_TREE_OOC": "0", "H2O3_TREE_SHARD": "1",
              "H2O3_TREE_SHARD_BLOCKS": "4"}
    _, pf = _frames(_data(1500, 51, "binomial"), "binomial")
    for cls, kw in ((H2OGradientBoostingEstimator,
                     dict(ntrees=6, max_depth=4, balance_classes=True,
                          sample_rate_per_class=[0.5, 1.0])),
                    (H2ORandomForestEstimator,
                     dict(ntrees=5, max_depth=6,
                          sample_rate_per_class=[0.4, 0.9]))):
        models = []
        for env in (stream, blocks):
            for k in set(stream) | set(blocks):
                monkeypatch.delenv(k, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            dataset_cache.clear()
            est = cls(seed=9, device="cpu", **kw)
            est.train(y="y", training_frame=pf)
            models.append(est.model)
        s, b = models
        assert s._stream_stats["blocks"] == 4
        assert not hasattr(b, "_stream_stats")
        for f in s.forest[0]._fields:
            assert torch.equal(getattr(s.forest[0], f),
                               getattr(b.forest[0], f)), f
        assert float(s.training_metrics.logloss) == \
            float(b.training_metrics.logloss)
        assert np.array_equal(np.asarray(s.predict(pf).vec("1").data),
                              np.asarray(b.predict(pf).vec("1").data))


def test_never_read_parameters_raise():
    """GLM's three balance parameters, AutoML's `balance_classes` and DRF's
    `binomial_double_trees` raise at any value but the default, naming the
    parameter: the reference accepts them and never reads them."""
    _, pf = _frames(_data(200, 61, "binomial"), "binomial")
    for kw in (dict(balance_classes=True),
               dict(class_sampling_factors=[1.0, 2.0]),
               dict(max_after_balance_size=2.0)):
        (k, v), = kw.items()
        with pytest.raises(NotImplementedError,
                           match=f"{k}=.*reference's GLM accepts it and never "
                                 "reads it"):
            H2OGeneralizedLinearEstimator(family="binomial", device="cpu",
                                          **kw).train(y="y", training_frame=pf)
    with pytest.raises(NotImplementedError,
                       match="balance_classes=True: the reference's AutoML"):
        H2OAutoML(max_models=1, balance_classes=True)
    with pytest.raises(NotImplementedError,
                       match="binomial_double_trees=True: the reference's DRF"):
        H2ORandomForestEstimator(ntrees=1, binomial_double_trees=True,
                                 device="cpu").train(y="y", training_frame=pf)
    # the defaults fit
    H2OGeneralizedLinearEstimator(family="binomial", device="cpu",
                                  balance_classes=False).train(
        y="y", training_frame=pf)
