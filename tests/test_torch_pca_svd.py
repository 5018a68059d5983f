"""PCA and SVD of the port against the reference's, on the CPU.

The same numpy-seeded frames (well separated spectra, so that each
eigenvector is determined up to its sign) go through the JAX package on
a one-device cloud and through the port with `device="cpu"`:

- PCA, every `pca_method` (GramSVD, and Power and GLRM down the same
  path; Randomized with its power iterations) under NONE, DEMEAN and
  STANDARDIZE, on a numeric frame and on one with a categorical column:
  eigenvectors within
  EIG_ABS = 1e-4 after the sign rule, eigenvalues within EIG_REL = 1e-5
  relative, scores within SCORE_TOL = 1e-4;
- SVD, every `svd_method` (GramSVD, Power, Randomized) under NONE, DEMEAN,
  DESCALE and STANDARDIZE: d (relative), v and u within SVD_TOL = 1e-4;
- `convert.pca_from_numpy` and `convert.svd_from_numpy` of reference
  models predict as the reference; the MOJOs hold the same members and
  load across both ways (the artifact's f64 expansion within MOJO_TOL =
  1e-5 of `predict`'s f32 rows); a PCA model served equals `predict`;
- the reference's DEMEAN faults, pinned on both packages: the PCA payload
  keeps no DEMEAN means, so its MOJO scores un-centred rows where
  `predict` centres them, and SVD's DEMEAN is applied at fit, so `u`
  differs from `predict` of the training rows (ROADMAP §C);
- the `NotImplementedError`s for the parameters the reference's PCA
  never reads.
"""

import numpy as np
import pytest

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import pca as refpca
from h2o3_tpu.models import svd as refsvd
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import (H2OPrincipalComponentAnalysisEstimator,
                                       H2OSingularValueDecompositionEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

EIG_ABS = 1e-4
EIG_REL = 1e-5
SCORE_TOL = 1e-4
SVD_TOL = 1e-4
MOJO_TOL = 1e-5     # the f64 expansion of the artifact against f32 rows


def _spectrum(n=600, seed=0, cat=False):
    """Columns with standard deviations 6, 4, 2.5, 1.5, 0.8, 0.3 (mixed by
    a fixed rotation) plus an offset, and with `cat` a 3-level column."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, 6)) * np.asarray([6, 4, 2.5, 1.5, 0.8, 0.3])
    Q, _ = np.linalg.qr(np.random.default_rng(99).normal(size=(6, 6)))
    X = Z @ Q.T + np.arange(1.0, 7.0)
    names = [f"x{i}" for i in range(6)]
    if cat:
        X = np.column_stack([X, (Z[:, 0] > 0).astype(int) + (Z[:, 1] > 2)])
        names.append("g")
    return X, names


def _frames(X, names, cat=False):
    rf = RefFrame.from_numpy(X, names=names)
    pf = Frame.from_numpy(X, names=names)
    if cat:
        rf, pf = rf.asfactor("g"), pf.asfactor("g")
    return rf, pf


def _mat(fr):
    return np.column_stack([fr.vec(n).numeric_np() for n in fr.names])


def _check_pca(rm, pm, rf, pf, where):
    rv, pv = np.asarray(rm.eigenvectors), np.asarray(pm.eigenvectors)
    assert rv.shape == pv.shape and rv.dtype == pv.dtype, where
    assert np.abs(rv - pv).max() <= EIG_ABS, where
    re, pe = np.asarray(rm.eigenvalues), np.asarray(pm.eigenvalues)
    assert np.all(np.abs(re - pe) <= EIG_REL * np.abs(re) + 1e-12), where
    rs, ps = _mat(rm.predict(rf)), _mat(pm.predict(pf))
    assert np.abs(rs - ps).max() <= SCORE_TOL * max(1.0, np.abs(rs).max()), where
    for key in ("Standard deviation", "Cumulative Proportion"):
        assert np.allclose(rm.importance[key], pm.importance[key],
                           rtol=EIG_REL), where


@pytest.mark.parametrize("cat", [False, True])
def test_pca_matches_the_reference(cloud1, cat):
    X, names = _spectrum(seed=1, cat=cat)
    rf, pf = _frames(X, names, cat)
    for method in ("GramSVD", "Randomized", "Power", "GLRM"):
        for tr in ("NONE", "DEMEAN", "STANDARDIZE"):
            params = dict(k=3, pca_method=method, transform=tr, seed=6,
                          use_all_factor_levels=cat)
            ref = refpca.H2OPrincipalComponentAnalysisEstimator(**params)
            ref.train(training_frame=rf)
            port = H2OPrincipalComponentAnalysisEstimator(device="cpu",
                                                          **params)
            port.train(training_frame=pf)
            _check_pca(ref.model, port.model, rf, pf, (method, tr))
    # k above the width is cut to it
    port = H2OPrincipalComponentAnalysisEstimator(k=50, device="cpu")
    port.train(training_frame=pf)
    assert port.model.k == len(port.model.dinfo.coef_names)


def test_svd_matches_the_reference(cloud1):
    X, names = _spectrum(seed=2)
    rf, pf = _frames(X, names)
    for method in ("GramSVD", "Power", "Randomized"):
        for tr in ("NONE", "DEMEAN", "DESCALE", "STANDARDIZE"):
            params = dict(nv=3, svd_method=method, transform=tr, seed=4)
            ref = refsvd.H2OSingularValueDecompositionEstimator(**params)
            ref.train(training_frame=rf)
            port = H2OSingularValueDecompositionEstimator(device="cpu",
                                                          **params)
            port.train(training_frame=pf)
            rm, pm = ref.model, port.model
            where = (method, tr)
            assert np.all(np.abs(rm.d - pm.d) <= SVD_TOL * rm.d), where
            assert np.abs(rm.v - pm.v).max() <= SVD_TOL, where
            assert np.abs(rm.u - pm.u).max() <= SVD_TOL, where
            assert np.abs(_mat(rm.u_frame) - _mat(pm.u_frame)).max() <= SVD_TOL
            rs, ps = _mat(rm.predict(rf)), _mat(pm.predict(pf))
            assert np.abs(rs - ps).max() <= SVD_TOL * max(1, np.abs(rs).max())
    port = H2OSingularValueDecompositionEstimator(nv=2, keep_u=False,
                                                  device="cpu")
    port.train(training_frame=pf)
    assert port.model.u is None and port.model.u_frame is None


def test_carried_models_mojo_serving_and_faults(cloud1, tmp_path):
    X, names = _spectrum(seed=3, cat=True)
    rf, pf = _frames(X, names, cat=True)
    test = X[::5].copy()
    test[::4, 2] = np.nan                      # NAs at scoring time
    rt, pt = _frames(test, names, cat=True)
    for tr in ("STANDARDIZE", "DEMEAN"):
        params = dict(k=3, transform=tr)
        ref = refpca.H2OPrincipalComponentAnalysisEstimator(**params)
        ref.train(training_frame=rf)
        port = H2OPrincipalComponentAnalysisEstimator(device="cpu", **params)
        port.train(training_frame=pf)
        rm, pm = ref.model, port.model
        di = rm.dinfo
        carried = convert.pca_from_numpy(
            eigenvectors=rm.eigenvectors, eigenvalues=rm.eigenvalues,
            x=rm.x, spec=di._spec, coef_names=di.coef_names,
            demean_mu=getattr(rm, "_demean_mu", None), means=di.means,
            stds=di.stds, col_means=di.col_means,
            standardize=di.standardize, use_all=di.use_all, device="cpu")
        want = _mat(rm.predict(rt))
        assert np.abs(_mat(carried.predict(pt)) - want).max() <= 1e-10
        assert np.abs(_mat(pm.predict(pt)) - want).max() <= SCORE_TOL
        pp = mojo.save_model(pm, str(tmp_path), f"port_pca_{tr}.h2o3")
        rp = refmojo.save_model(rm, str(tmp_path), f"ref_pca_{tr}.h2o3")
        _same_members(pp, rp)
        ref_mojo = _mat(refmojo.load_model(rp).predict(rt))
        for scored in (mojo.load_model(pp).predict(pt),
                       mojo.load_model(rp).predict(pt),
                       refmojo.load_model(pp).predict(rt)):
            assert np.abs(_mat(scored) - ref_mojo).max() <= SCORE_TOL
        if tr == "STANDARDIZE":
            assert np.abs(ref_mojo - want).max() <= MOJO_TOL
        else:
            # the reference's fault: the artifact scores un-centred rows
            shift = np.asarray(rm._demean_mu) @ np.asarray(rm.eigenvectors)
            assert np.abs(ref_mojo - want - shift).max() <= MOJO_TOL
            assert np.abs(shift).max() > 0.5
    # the STANDARDIZE model (predict and MOJO agree) served
    eng = ScoringEngine(ServingConfig())
    try:
        ref = refpca.H2OPrincipalComponentAnalysisEstimator(
            k=3, transform="STANDARDIZE")
        ref.train(training_frame=rf)
        port = H2OPrincipalComponentAnalysisEstimator(
            k=3, transform="STANDARDIZE", device="cpu")
        port.train(training_frame=pf)
        sub = pf.take(np.arange(5, 300))
        served = _mat(eng.score("pca", port.model, sub))
        assert np.abs(served - _mat(port.model.predict(sub))).max() <= 1e-12
        assert eng.snapshot()["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()

    for tr in ("NONE", "DEMEAN"):
        params = dict(nv=3, transform=tr)
        ref = refsvd.H2OSingularValueDecompositionEstimator(**params)
        ref.train(training_frame=rf)
        port = H2OSingularValueDecompositionEstimator(device="cpu", **params)
        port.train(training_frame=pf)
        rm, pm = ref.model, port.model
        di = rm.dinfo
        carried = convert.svd_from_numpy(
            d=rm.d, v=rm.v, u=rm.u, x=rm.x, spec=di._spec,
            coef_names=di.coef_names, means=di.means, stds=di.stds,
            col_means=di.col_means, standardize=di.standardize,
            use_all=di.use_all, device="cpu")
        want = _mat(rm.predict(rt))
        assert np.abs(_mat(carried.predict(pt)) - want).max() <= 1e-10
        assert np.array_equal(carried.u, rm.u)
        pp = mojo.save_model(pm, str(tmp_path), f"port_svd_{tr}.h2o3")
        rp = refmojo.save_model(rm, str(tmp_path), f"ref_svd_{tr}.h2o3")
        _same_members(pp, rp)
        for scored in (mojo.load_model(pp).predict(pt),
                       mojo.load_model(rp).predict(pt),
                       refmojo.load_model(pp).predict(rt)):
            assert np.abs(_mat(scored) - want).max() <= SVD_TOL
        # DEMEAN is applied at fit and not by predict, in both packages
        gap = np.abs(_mat(pm.predict(pf)) - pm.u).max()
        rgap = np.abs(_mat(rm.predict(rf)) - rm.u).max()
        if tr == "NONE":
            assert gap <= SVD_TOL and rgap <= SVD_TOL
        else:
            assert gap > 1e-2 and rgap > 1e-2

    for bad in (dict(compute_metrics=False), dict(impute_missing=False),
                dict(max_iterations=5)):
        with pytest.raises(NotImplementedError, match="item 8"):
            H2OPrincipalComponentAnalysisEstimator(
                device="cpu", **bad).train(training_frame=pf)


def _same_members(pp, rp):
    pn, pmeta, parr = _members(pp)
    rn, rmeta, rarr = _members(rp)
    assert pn == rn and sorted(parr) == sorted(rarr)
    assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
        k: v for k, v in rmeta.items() if k != "model_id"}
    for name in rarr:
        assert parr[name].dtype == rarr[name].dtype, name
