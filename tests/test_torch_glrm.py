"""GLRM of the port against the reference's, on the CPU.

The same numpy-seeded low-rank frames with missing cells go through the
JAX package on a one-device cloud and through the port with
`device="cpu"`:

- the masked expansion (A, M and the `DataInfo` stats) equals the
  reference's bit for bit (the starting point, the host SVD of A or
  Random's draws, is the reference's numpy code on it);
- fits under STANDARDIZE, NONE and DEMEAN, with the SVD and the Random
  start, with γ > 0, and against the reference's `H2O3_EST_LEGACY=1` host
  loop (the port has one path), converge to the reference's objective within OBJ_TOL = 1e-4 relative, and their
  reconstructions and `transform` agree within FIT_TOL = 1e-3. The stop
  rule's 1e-8 is in effect an equality test on f32 objectives, so
  iteration counts are not compared;
- `max_iterations` is capped at 300 in both packages;
- the port's batched `transform` equals the reference's per-row loop run
  on the same archetypes within PROJECT_TOL = 1e-6;
- `convert.glrm_from_numpy` of a reference model reconstructs as the
  reference; the MOJOs hold the same members and load across both ways;
- the `NotImplementedError`s for the parameters the reference never
  reads and for regularizers other than its quadratic penalty.
"""

import numpy as np
import pytest

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import estimator_engine as refest
from h2o3_tpu.models import glrm as refglrm
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import H2OGeneralizedLowRankEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import glrm

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

OBJ_TOL = 1e-4
FIT_TOL = 1e-3
PROJECT_TOL = 1e-6


def _low_rank(n=400, p=8, k=3, seed=0, missing=0.1):
    """Rank k plus noise, offset and scaled per column, `missing` of the
    cells NaN at random."""
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(n, k)) @ rng.normal(size=(k, p))
         + 0.05 * rng.normal(size=(n, p)))
    A = A * np.linspace(1, 3, p) + np.arange(p)
    A[rng.random(A.shape) < missing] = np.nan
    return A, [f"a{i}" for i in range(p)]


def _frames(A, names):
    return (RefFrame.from_numpy(A, names=names),
            Frame.from_numpy(A, names=names))


def _mat(fr):
    return np.column_stack([fr.vec(n).numeric_np() for n in fr.names])


def _fit_both(rf, pf, **params):
    ref = refglrm.H2OGeneralizedLowRankEstimator(**params)
    ref.train(training_frame=rf)
    port = H2OGeneralizedLowRankEstimator(device="cpu", **params)
    port.train(training_frame=pf)
    return ref.model, port.model


def _check(rm, pm, rf, pf, where):
    assert abs(rm.objective - pm.objective) <= OBJ_TOL * abs(rm.objective), (
        where, rm.objective, pm.objective)
    rr, pr = _mat(rm.reconstruct(rf)), _mat(pm.reconstruct(pf))
    assert np.abs(rr - pr).max() <= FIT_TOL * max(1, np.abs(rr).max()), where
    rt, pt = _mat(rm.transform(rf)), _mat(pm.transform(pf))
    assert np.abs(rt - pt).max() <= FIT_TOL * max(1, np.abs(rt).max()), where
    assert np.abs(np.asarray(rm.X) @ np.asarray(rm.Y)
                  - pm.X @ pm.Y).max() <= FIT_TOL * max(1, np.abs(rr).max())


def test_fit_matches_the_reference(cloud1, monkeypatch):
    A, names = _low_rank(seed=1)
    rf, pf = _frames(A, names)
    for tr in ("STANDARDIZE", "NONE", "DEMEAN"):
        r = refglrm.H2OGeneralizedLowRankEstimator._expand_masked(
            refglrm.H2OGeneralizedLowRankEstimator(), rf, names, tr)
        p = H2OGeneralizedLowRankEstimator._expand_masked(pf, names, tr)
        for a, b in zip(r[1:], p[1:]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), tr
        for field in ("means", "stds", "coef_names", "_spec", "use_all"):
            a, b = getattr(r[0], field), getattr(p[0], field)
            assert np.array_equal(np.asarray(a), np.asarray(b)), (tr, field)
    cases = [dict(transform="STANDARDIZE"), dict(transform="NONE"),
             dict(transform="DEMEAN"), dict(transform="STANDARDIZE",
                                           init="Random"),
             dict(transform="STANDARDIZE", gamma_x=0.5, gamma_y=0.2,
                  regularization_x="Quadratic",
                  regularization_y="Quadratic")]
    for params in cases:
        rm, pm = _fit_both(rf, pf, k=3, seed=2, max_iterations=200, **params)
        _check(rm, pm, rf, pf, params)
    # the reference's host loop against the port's one path
    monkeypatch.setenv("H2O3_EST_LEGACY", "1")
    rm, pm = _fit_both(rf, pf, k=3, seed=2, max_iterations=200,
                       transform="STANDARDIZE")
    assert refest.est_stats()["plans"][-1]["path"] == "legacy"
    _check(rm, pm, rf, pf, "legacy")
    monkeypatch.delenv("H2O3_EST_LEGACY")
    # the silent cap: 1000 iterations asked, at most 300 run, in both
    rm, pm = _fit_both(rf, pf, k=3, seed=2, max_iterations=1000,
                       init="Random", transform="STANDARDIZE")
    assert refest.est_stats()["plans"][-1]["iterations"] <= 300
    assert pm.iterations <= 300
    # the batched projection against the reference's per-row loop on the
    # port's own archetypes
    want = refglrm.GLRMModel._project(pm, rf)
    assert np.abs(pm._project(pf) - want).max() <= PROJECT_TOL * max(
        1, np.abs(want).max())


def test_carried_model_mojo_and_raises(cloud1, tmp_path):
    A, names = _low_rank(seed=3)
    rf, pf = _frames(A, names)
    rm, pm = _fit_both(rf, pf, k=3, seed=4, max_iterations=100,
                       transform="STANDARDIZE")
    di = rm.dinfo
    carried = convert.glrm_from_numpy(
        X=np.asarray(rm.X), Y=np.asarray(rm.Y), objective=rm.objective,
        x=rm.x, spec=di._spec, coef_names=di.coef_names, means=di.means,
        stds=di.stds, standardize=di.standardize, device="cpu")
    test = A[::9].copy()
    test[::3, 4] = np.nan
    rt, pt = _frames(test, names)
    want = _mat(rm.reconstruct(rt))
    assert np.abs(_mat(carried.reconstruct(pt)) - want).max() <= PROJECT_TOL
    assert np.array_equal(carried.archetypes(), np.asarray(rm.Y))

    pp = mojo.save_model(pm, str(tmp_path), "port_glrm.h2o3")
    rp = refmojo.save_model(rm, str(tmp_path), "ref_glrm.h2o3")
    pn, pmeta, parr = _members(pp)
    rn, rmeta, rarr = _members(rp)
    assert pn == rn and sorted(parr) == sorted(rarr)
    assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
        k: v for k, v in rmeta.items() if k != "model_id"}
    for name in rarr:
        assert parr[name].dtype == rarr[name].dtype, name
    own = _mat(pm.predict(pt))
    own_t = _mat(pm.transform(pt))
    for path in (pp, rp):
        for scorer, frame in ((mojo.load_model(path), pt),
                              (refmojo.load_model(path), rt)):
            ref_side = path == rp
            base, base_t = ((want, _mat(rm.transform(rt))) if ref_side
                            else (own, own_t))
            assert np.abs(_mat(scorer.predict(frame)) - base).max() <= 1e-5
            assert np.abs(_mat(scorer.transform(frame)) - base_t).max() <= 1e-5

    for bad in (dict(loss="Absolute"), dict(multi_loss="Ordinal"),
                dict(loss_by_col=["Absolute"]), dict(max_updates=10),
                dict(init_step_size=0.5), dict(min_step_size=1e-3),
                dict(svd_method="GramSVD"), dict(impute_original=True),
                dict(recover_svd=True), dict(period=2),
                dict(regularization_x="L1"),
                dict(regularization_y="NonNegative"),
                dict(gamma_x=0.5)):
        with pytest.raises(NotImplementedError, match="item 8"):
            H2OGeneralizedLowRankEstimator(
                k=2, device="cpu", **bad).train(training_frame=pf)
    # the quadratic regularizer fits
    H2OGeneralizedLowRankEstimator(
        k=2, device="cpu", gamma_y=0.1, regularization_y="Quadratic",
        max_iterations=5).train(training_frame=pf)
    assert glrm._QUADRATIC == ("None", "Quadratic")
