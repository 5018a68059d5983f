"""K-Means of the port against the reference's, on the CPU.

The same numpy-seeded frames go through the JAX package on a one-device
cloud and through the port with `device="cpu"`:

- the host matrix equals the reference's byte for byte, and the PlusPlus,
  Furthest and Random seeding draws the same centres bit for bit;
- on separated blobs (numeric, and with a categorical column) the engine
  path's centres agree within CENTER_TOL = 1e-5, the assignments and the
  iteration counts are equal, and WSS, totss and betweenss agree within
  SS_TOL = 1e-5 relative. The one-hot cluster sums add in another order
  than jax's, so centres are compared within a tolerance, never bit for
  bit (the reference pins its fused path to its legacy path at 1e-4);
- the `H2O3_EST_LEGACY=1` host loop and `user_points` likewise;
- the reference's `ValueError`s, the port's `NotImplementedError` for
  `estimate_k`, which the reference never reads;
- `convert.kmeans_from_numpy` of a reference model predicts as the
  reference; the MOJOs hold the same members and load across both ways; a
  served batch equals `predict` with no fallback.
"""

import numpy as np
import pytest

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import estimator_engine as refest
from h2o3_tpu.models import kmeans as refkm
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import H2OKMeansEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import estimator_engine as est
from h2o3_tpu_torch.models import kmeans as km
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

CENTER_TOL = 1e-5
SS_TOL = 1e-5


def _blobs(n=900, k=3, f=4, seed=0, cat=False):
    """Separated Gaussian blobs; with `cat`, a 3-level column that names
    the blob for 90 % of the rows."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (k, f))
    X = np.concatenate([c + rng.normal(size=(n // k, f)) for c in centers])
    names = [f"c{i}" for i in range(f)]
    if cat:
        g = np.repeat(np.arange(k), n // k)
        flip = rng.random(len(g)) < 0.1
        g[flip] = rng.integers(0, k, flip.sum())
        X = np.column_stack([X, g])
        names = names + ["g"]
    return X, names


def _frames(X, names, cat=False):
    rf = RefFrame.from_numpy(X, names=names)
    pf = Frame.from_numpy(X, names=names)
    if cat:
        rf, pf = rf.asfactor("g"), pf.asfactor("g")
    return rf, pf


def _fit_both(rf, pf, **params):
    ref = refkm.H2OKMeansEstimator(**params)
    ref.train(training_frame=rf)
    ref_iters = refest.est_stats()["plans"][-1]["iterations"]
    port = H2OKMeansEstimator(device="cpu", **params)
    port.train(training_frame=pf)
    return ref, ref_iters, port


def _check_fit(ref, ref_iters, port, rf, pf, where):
    rm, pm = ref.model, port.model
    assert np.abs(rm.centers() - pm.centers()).max() <= CENTER_TOL * max(
        1.0, np.abs(rm.centers()).max()), where
    assert pm.iterations == ref_iters, where
    ra = rm.predict(rf).vec("predict").numeric_np()
    pa = pm.predict(pf).vec("predict").numeric_np()
    assert np.array_equal(ra, pa), where
    for name in ("tot_withinss", "totss", "betweenss"):
        r, p = getattr(rm, name)(), getattr(pm, name)()
        assert abs(r - p) <= SS_TOL * abs(r), (where, name, r, p)


def test_seeding_draws_the_references_centres(cloud1):
    """The host matrix byte for byte, and each init's draws bit for bit."""
    X, names = _blobs(600, 4, 5, seed=3, cat=True)
    rf, pf = _frames(X, names, cat=True)
    _, Xr = refest.host_matrix(rf, names, standardize=True, use_all=True)
    dinfo, Xp = est.host_matrix(pf, names, standardize=True, use_all=True)
    assert Xp.dtype == Xr.dtype and Xp.tobytes() == np.asarray(Xr).tobytes()
    assert dinfo.use_all
    for init in ("PlusPlus", "Furthest"):
        for seed in (0, 7):
            a = refkm._seed_centers(Xr, 4, init, np.random.default_rng(seed))
            b = km._seed_centers(Xp, 4, init, np.random.default_rng(seed))
            assert a.tobytes() == b.tobytes(), (init, seed)


@pytest.mark.parametrize("cat", [False, True])
def test_fits_match_the_reference(cloud1, cat):
    X, names = _blobs(seed=2, cat=cat)
    rf, pf = _frames(X, names, cat=cat)
    for init in ("PlusPlus", "Furthest", "Random"):
        for std in (True, False):
            ref, it, port = _fit_both(rf, pf, k=3, max_iterations=20, seed=1,
                                      init=init, standardize=std)
            _check_fit(ref, it, port, rf, pf, (init, std))
            assert est.est_stats()["plans"][-1]["path"] == "fused"
    # a fit that stops at max_iterations before it converges, k > blobs
    ref, it, port = _fit_both(rf, pf, k=5, max_iterations=2, seed=4,
                              init="PlusPlus")
    _check_fit(ref, it, port, rf, pf, "capped")
    assert it == 2
    # a validation frame is scored by the same metrics
    X2, _ = _blobs(300, seed=5, cat=cat)
    rv, pv = _frames(X2, names, cat=cat)
    ref = refkm.H2OKMeansEstimator(k=3, seed=1)
    ref.train(training_frame=rf, validation_frame=rv)
    port = H2OKMeansEstimator(k=3, seed=1, device="cpu")
    port.train(training_frame=pf, validation_frame=pv)
    r, p = ref.model.validation_metrics, port.model.validation_metrics
    assert abs(r.tot_withinss - p.tot_withinss) <= SS_TOL * r.tot_withinss
    assert abs(r.totss - p.totss) <= SS_TOL * r.totss


def test_legacy_and_user_points_match_the_reference(cloud1, monkeypatch):
    X, names = _blobs(seed=6)
    rf, pf = _frames(X, names)
    monkeypatch.setenv("H2O3_EST_LEGACY", "1")
    for init in ("PlusPlus", "Random"):
        ref, it, port = _fit_both(rf, pf, k=3, max_iterations=20, seed=2,
                                  init=init)
        assert refest.est_stats()["plans"][-1]["path"] == "legacy"
        assert est.est_stats()["plans"][-1]["path"] == "legacy"
        _check_fit(ref, it, port, rf, pf, ("legacy", init))
    monkeypatch.delenv("H2O3_EST_LEGACY")
    # user points (in the standardized space) take the host loop too
    pts = np.asarray([[-1.0, 0.5, 0.0, 1.0], [1.0, -1.0, 0.5, 0.0],
                      [0.0, 1.0, -1.0, -0.5]])
    ref, it, port = _fit_both(rf, pf, k=3, max_iterations=20, seed=2,
                              user_points=pts)
    assert est.est_stats()["plans"][-1]["path"] == "legacy"
    _check_fit(ref, it, port, rf, pf, "user_points")
    # and as a frame
    port2 = H2OKMeansEstimator(k=3, max_iterations=20, seed=2, device="cpu",
                               user_points=Frame.from_numpy(pts))
    port2.train(training_frame=pf)
    assert np.array_equal(port2.model.centers(), port.model.centers())


def test_errors_carried_model_mojo_and_serving(cloud1, tmp_path):
    X, names = _blobs(seed=8, cat=True)
    rf, pf = _frames(X, names, cat=True)
    for bad, msg in ((dict(k=0), "k must be >= 1"),
                     (dict(max_iterations=0), "max_iterations must be >= 1")):
        with pytest.raises(ValueError, match=msg):
            refkm.H2OKMeansEstimator(**bad).train(training_frame=rf)
        with pytest.raises(ValueError, match=msg):
            H2OKMeansEstimator(device="cpu", **bad).train(training_frame=pf)
    with pytest.raises(NotImplementedError, match="estimate_k.*item 8"):
        H2OKMeansEstimator(k=3, estimate_k=True,
                           device="cpu").train(training_frame=pf)

    ref, _, port = _fit_both(rf, pf, k=3, max_iterations=20, seed=3,
                             init="PlusPlus")
    rm, pm = ref.model, port.model
    di = rm.dinfo
    carried = convert.kmeans_from_numpy(
        centers_std=np.asarray(rm.centers_std), x=rm.x, spec=di._spec,
        coef_names=di.coef_names, means=di.means, stds=di.stds,
        col_means=di.col_means, standardize=di.standardize,
        use_all=di.use_all, device="cpu")
    test = X[::7].copy()
    test[::5, 1] = np.nan                      # NAs at scoring time
    rt, pt = _frames(test, names, cat=True)
    want = rm.predict(rt).vec("predict").numeric_np()
    assert np.array_equal(carried.predict(pt).vec("predict").numeric_np(),
                          want)
    assert np.array_equal(carried.centers(), rm.centers())

    pp = mojo.save_model(pm, str(tmp_path), "port_km.h2o3")
    rp = refmojo.save_model(rm, str(tmp_path), "ref_km.h2o3")
    pn, pmeta, parr = _members(pp)
    rn, rmeta, rarr = _members(rp)
    assert pn == rn and sorted(parr) == sorted(rarr)
    assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
        k: v for k, v in rmeta.items() if k != "model_id"}
    for name in rarr:
        assert parr[name].dtype == rarr[name].dtype, name
    own = pm.predict(pt).vec("predict").numeric_np()
    assert np.array_equal(own, want)
    for scored in (mojo.load_model(pp).predict(pt),
                   mojo.load_model(rp).predict(pt),
                   refmojo.load_model(pp).predict(rt)):
        assert np.array_equal(scored.vec("predict").numeric_np(), want)
    # a reloaded artifact re-exports losslessly
    again = mojo.save_model(mojo.load_model(pp), str(tmp_path), "again.h2o3")
    assert _members(again)[1] == pmeta

    eng = ScoringEngine(ServingConfig())
    try:
        sub = pf.take(np.arange(11, 270))
        served = eng.score("km", pm, sub).vec("predict").numeric_np()
        assert np.array_equal(served,
                              pm.predict(sub).vec("predict").numeric_np())
        assert eng.snapshot()["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()
