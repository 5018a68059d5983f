"""The isolation forests of the port against the reference's, on the CPU.

The same numpy-seeded frames go through the JAX package on a one-device
cloud and through the port with `device="cpu"`:

- IsolationForest (with NaNs in a column, and with `sample_rate`): the host
  build's trees equal the reference's bit for bit, and the path lengths and
  scores of the port's torch walk agree within IF_TOL = 1e-12;
- ExtendedIsolationForest at extension levels 0, 2 and p − 1 (the last on a
  frame with a categorical column): the directions bit for bit, the
  thresholds bit for bit at level 0 (one non-zero component: the
  projection is exact, and the intercept rounds once, as XLA's fused
  multiply-add) and within EIF_THR_TOL = 1e-6 relative above it, splits
  and node counts equal, scores and mean lengths within EIF_TOL = 1e-6;
- the reference's `ValueError` and the port's `NotImplementedError`s for
  the parameters the reference never reads;
- MOJO payloads member for member, loading across both ways, the numpy
  scorers; `convert.isoforest_from_numpy` and `eif_from_numpy`; a served
  batch of each equal to `predict` with no fallback.
"""

import numpy as np
import pytest

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import extended_isolation_forest as refeif
from h2o3_tpu.models import isolation_forest as refif
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import (H2OExtendedIsolationForestEstimator,
                                       H2OIsolationForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import isolation_forest as pif
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

IF_TOL = 1e-12
EIF_TOL = 1e-6
EIF_THR_TOL = 1e-6


def _outliers(n=500, f=3, seed=7, nan_every=0, cat=False):
    """Normal inliers and 10 rows shifted by 8; with `nan_every`, every
    such row's second column is NaN; with `cat`, a 3-level column."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(size=(n, f)),
                        rng.normal(loc=8.0, size=(10, f))])
    if nan_every:
        X[::nan_every, 1] = np.nan
    names = [f"c{i}" for i in range(f)]
    if cat:
        X = np.column_stack([X, rng.integers(0, 3, len(X))])
        names = names + ["g"]
    rf = RefFrame.from_numpy(X, names=names)
    pf = Frame.from_numpy(X, names=names)
    if cat:
        rf, pf = rf.asfactor("g"), pf.asfactor("g")
    return rf, pf, names


def _col(frame, name):
    return frame.vec(name).numeric_np()


def _fit_if(rf, pf, **params):
    ref = refif.H2OIsolationForestEstimator(**params)
    ref.train(training_frame=rf)
    port = H2OIsolationForestEstimator(device="cpu", **params)
    port.train(training_frame=pf)
    return ref.model, port.model


def _fit_eif(rf, pf, names, **params):
    ref = refeif.H2OExtendedIsolationForestEstimator(**params)
    ref.train(x=names, training_frame=rf)
    port = H2OExtendedIsolationForestEstimator(device="cpu", **params)
    port.train(x=names, training_frame=pf)
    return ref.model, port.model


@pytest.mark.parametrize("params", [
    dict(ntrees=40, sample_size=128, seed=8),
    dict(ntrees=15, sample_rate=0.3, max_depth=6, seed=3)],
    ids=["sample_size", "sample_rate"])
def test_isolation_forest_matches_the_reference(cloud1, params):
    rf, pf, _ = _outliers(nan_every=37)
    rm, pm = _fit_if(rf, pf, **params)
    assert pm.sample_size == rm.sample_size and len(pm.trees) == len(rm.trees)
    for t, (a, b) in enumerate(zip(rm.trees, pm.trees)):
        for name, u, v in zip(("feat", "thr", "is_split", "leaf_n"), a, b):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes(), (t, name)
    want, got = rm.predict(rf), pm.predict(pf)
    assert got.names == want.names == ["predict", "mean_length"]
    for name in want.names:
        assert np.abs(_col(got, name) - _col(want, name)).max() <= IF_TOL
    assert (pm.training_metrics.description
            == rm.training_metrics.description)
    assert pm.training_metrics.nobs == rm.training_metrics.nobs
    # the reference's own bars (tests/test_unsupervised.py)
    s = _col(got, "predict")
    assert s[-10:].mean() > s[:-10].mean() + 0.1
    assert (s[-10:] > np.quantile(s, 0.95)).mean() > 0.8


@pytest.mark.parametrize("ext,cat", [(0, False), (2, False), (5, True)],
                         ids=["ext0", "ext2", "ext_max_cat"])
def test_extended_isolation_forest_matches_the_reference(cloud1, ext, cat):
    rf, pf, names = _outliers(f=4 if not cat else 3, seed=4, cat=cat)
    rm, pm = _fit_eif(rf, pf, names, ntrees=30, sample_size=128,
                      extension_level=ext, seed=9)
    assert pm.depth == rm.depth and pm.sample_size == rm.sample_size
    assert pm.dinfo.coef_names == rm.dinfo.coef_names and pm.dinfo.use_all
    rd = np.asarray(rm.dirs)
    assert pm.dirs.numpy().tobytes() == rd.tobytes()
    rt, pt = np.asarray(rm.thrs), pm.thrs.numpy()
    if ext == 0:
        assert pt.tobytes() == rt.tobytes()
    else:
        assert np.abs(pt - rt).max() <= EIF_THR_TOL * max(1.0, np.abs(rt).max())
    assert np.array_equal(pm.splits.numpy(), np.asarray(rm.splits))
    assert np.array_equal(pm.counts.numpy(), np.asarray(rm.counts))
    want, got = rm.predict(rf), pm.predict(pf)
    assert got.names == want.names == ["anomaly_score", "mean_length"]
    for name in want.names:
        assert np.abs(_col(got, name) - _col(want, name)).max() <= EIF_TOL
    s = _col(got, "anomaly_score")
    assert (s[-10:] > np.quantile(s, 0.95)).mean() > 0.8


def test_errors_and_unread_parameters(cloud1):
    rf, pf, names = _outliers(n=100)
    msg = r"extension_level must be in \[0, 2\]"
    with pytest.raises(ValueError, match=msg):
        refeif.H2OExtendedIsolationForestEstimator(
            extension_level=3).train(x=names, training_frame=rf)
    with pytest.raises(ValueError, match=msg):
        H2OExtendedIsolationForestEstimator(
            extension_level=3, device="cpu").train(x=names, training_frame=pf)
    for est, bad in ((H2OIsolationForestEstimator, dict(mtries=2)),
                     (H2OIsolationForestEstimator, dict(contamination=0.1)),
                     (H2OIsolationForestEstimator, dict(score_tree_interval=5)),
                     (H2OExtendedIsolationForestEstimator,
                      dict(disable_training_metrics=False))):
        name = next(iter(bad))
        with pytest.raises(NotImplementedError, match=f"{name}.*item 10"):
            est(device="cpu", **bad).train(x=names, training_frame=pf)


def _straddlers(trees, X, depth):
    """Rows whose path length changes when the f64 thresholds are rounded
    to the payload's f32: rows within one f32 rounding of a threshold."""
    f32 = [(f, t.astype(np.float32).astype(np.float64), s, n)
           for f, t, s, n in trees]
    return (pif.forest_path_lengths(trees, X, depth)
            != pif.forest_path_lengths(f32, X, depth))


def test_mojo_convert_and_serving(cloud1, tmp_path):
    rf, pf, names = _outliers(seed=5, nan_every=41)
    rm, pm = _fit_if(rf, pf, ntrees=20, sample_size=64, seed=4)
    erf, epf, enames = _outliers(f=3, seed=6, cat=True)
    erm, epm = _fit_eif(erf, epf, enames, ntrees=12, sample_size=64,
                        extension_level=0, seed=2)
    cases = dict(isoforest=(rm, pm, rf, pf, "predict"),
                 eif=(erm, epm, erf, epf, "anomaly_score"))
    for kind, (ref, port, rfr, pfr, col) in cases.items():
        pp = mojo.save_model(port, str(tmp_path), f"port_{kind}.h2o3")
        rp = refmojo.save_model(ref, str(tmp_path), f"ref_{kind}.h2o3")
        pn, pmeta, parr = _members(pp)
        rn, rmeta, rarr = _members(rp)
        assert pn == rn and sorted(parr) == sorted(rarr), kind
        assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
            k: v for k, v in rmeta.items() if k != "model_id"}, kind
        for name in rarr:
            assert parr[name].dtype == rarr[name].dtype, (kind, name)
            assert parr[name].tobytes() == rarr[name].tobytes(), (kind, name)
        want = refmojo.load_model(rp).predict(rfr)
        for scored in (mojo.load_model(pp).predict(pfr),
                       mojo.load_model(rp).predict(pfr),
                       refmojo.load_model(pp).predict(rfr)):
            assert scored.names == want.names, kind
            for name in want.names:
                assert np.array_equal(_col(scored, name), _col(want, name))
        # the scorer against the live model: equal within 1e-5 on every
        # row that no threshold's f32 rounding moves
        live = port.predict(pfr)
        diff = np.abs(_col(live, col) - _col(want, col))
        if kind == "isoforest":
            X = np.column_stack([_col(pfr, n) for n in port.x])
            near = _straddlers(port.trees, X, port.max_depth)
            assert not (diff[~near] > 1e-5).any()
        else:
            assert diff.max() <= 1e-5
        again = mojo.save_model(mojo.load_model(pp), str(tmp_path),
                                f"again_{kind}.h2o3")
        assert _members(again)[1] == pmeta

    carried = convert.isoforest_from_numpy(
        feat=[t[0] for t in rm.trees], thr=[t[1] for t in rm.trees],
        is_split=[t[2] for t in rm.trees], leaf_n=[t[3] for t in rm.trees],
        sample_size=rm.sample_size, max_depth=rm.max_depth, x=rm.x,
        device="cpu")
    for name in ("predict", "mean_length"):
        assert np.abs(_col(carried.predict(pf), name)
                      - _col(rm.predict(rf), name)).max() <= IF_TOL
    di = erm.dinfo
    carried = convert.eif_from_numpy(
        dirs=np.asarray(erm.dirs), thrs=np.asarray(erm.thrs),
        splits=np.asarray(erm.splits), counts=np.asarray(erm.counts),
        depth=erm.depth, sample_size=erm.sample_size, x=erm.x, spec=di._spec,
        coef_names=di.coef_names, col_means=di.col_means, use_all=di.use_all,
        device="cpu")
    for name in ("anomaly_score", "mean_length"):
        assert np.abs(_col(carried.predict(epf), name)
                      - _col(erm.predict(erf), name)).max() <= EIF_TOL

    eng = ScoringEngine(ServingConfig())
    try:
        for key, model, fr in (("if", pm, pf), ("eif", epm, epf)):
            sub = fr.take(np.arange(13, 300))
            served, own = eng.score(key, model, sub), model.predict(sub)
            assert served.names == own.names
            for name in own.names:
                assert np.array_equal(_col(served, name), _col(own, name))
        assert eng.snapshot()["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()
