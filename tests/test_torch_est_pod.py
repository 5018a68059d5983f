"""The estimator engine across processes: GLM, K-Means, PCA, SVD and
cross-validation on gloo ranks on the CPU, each against the one-rank
blocks lane at the same S.

Ranks are fresh interpreters started through the port's launcher, as in
`test_torch_multiprocess.py` (whose `_launch`-style harness this file
shares: a `FileStore` under the test's temporary directory, one torch
thread and one BLAS thread a rank — the host eigen-solves' bits depend on
the BLAS thread count —, every launch side by side under one hard
deadline, every child killed on failure). A rank draws the frame from the seed, keeps only
its own ingest shard of the rows (uneven, so the canonical exchange moves
rows) and builds its `Frame` from those rows alone. The one-rank
comparator is the launcher with no flags under ``H2O3_EST_SHARD=1``
(and ``H2O3_TREE_SHARD=1``, ``H2O3_CV_REBIN=1`` for the CV cases) at the
same S.

- GLM on the reference's pod fixture (`tests/test_multiprocess.py`'s
  `_write_glm_clean_csv`: 4,000 rows, three numeric columns and an enum,
  binomial, λ 0.05, α 0, `standardize=False`, no missing values): β and
  the iteration count bit for bit on 2 ranks (S = 8) and on 3 ranks
  (S = 24), `record_fit`'s path `fused_mesh` against `fused_blocks`.
- A binomial fit at λ 0 with p-values: β, standard errors and p-values
  bit for bit.
- `standardize=True` on the frame with missing values: β within
  1e-5·max(1, |β|); the `DataInfo` means, standard deviations and
  imputation means within 1e-12 relative of the one-rank fit's.
- K-Means (PlusPlus, `standardize=False`): centres, the loop's WSS and the
  iteration count bit for bit; PCA GramSVD under NONE and DEMEAN:
  eigenvalues and eigenvectors bit for bit.
- CV: a 3-fold GBM and a 3-fold GLM, fold forests / fold β, each rank's
  holdout rows and the CV metrics bit for bit.
- λ search (binomial, α 0.5, 8 λ) with a validation frame of its own
  seeded rows, split unevenly over the ranks: the λ list, each λ's path β
  and deviance, the IRLS iterations, λ_best and β bit for bit; and a 3-fold
  λ-search GLM: fold β, each rank's holdout rows and the CV metrics.
- The multinomial GLM (3 classes, a ridge): β, the L-BFGS steps and
  function evaluations, and each rank's probabilities (η by columns, as
  the CV holdouts score) bit for bit.
- K-Means from `user_points` (path `fused_mesh`): centres, WSS and
  iterations; PCA Randomized (DEMEAN, the tall-skinny QR sketch):
  eigenvalues and eigenvectors; SVD GramSVD, Power (DEMEAN) and Randomized
  (DESCALE) with `keep_u`: d, v and each rank's rows of u, all bit for
  bit; and a STANDARDIZE Randomized SVD (global moments) within 1e-5.
- The lane cases (`LANE_CASES`: all but the p-values, the standardized
  GLM and the 3-fold GBM and GLM) run on 2 ranks at S = 8 and on 3 ranks
  at S = 24; the rest on 2 ranks.
- The guard: on 2 ranks DeepLearning, NaiveBayes and GLRM raise
  `NotImplementedError` naming item 9 on both ranks, a λ-search GLM fits,
  and neither rank hangs.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
N_ROWS = 4000
SPLITS = {1: [0, N_ROWS], 2: [0, 1993, N_ROWS], 3: [0, 1301, 2702, N_ROWS]}
TIMEOUT_S = 240
BETA_TOL = 1e-5
STAT_RTOL = 1e-12
# the cases fitted at S = 8 on 2 ranks and at S = 24 (suffix "24") on 3
LANE_CASES = ["glm", "km", "pca", "pcad", "ls", "cvls", "mn", "kmup",
              "pcar", "svd"]
CASES = LANE_CASES + ["glmpv", "glmstd", "cvgbm", "cvglm"]
CASES24 = [c + "24" for c in LANE_CASES]
# (case suffix, ranks, S) of the two pod launches
LANES = (("", 2, 8), ("24", 3, 24))

RANK_SCRIPT = textwrap.dedent('''
    import os, sys, json
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from h2o3_tpu_torch import set_device
    from h2o3_tpu_torch.estimators import (
        H2ODeepLearningEstimator, H2OGeneralizedLinearEstimator,
        H2OGeneralizedLowRankEstimator, H2OGradientBoostingEstimator,
        H2OKMeansEstimator, H2ONaiveBayesEstimator,
        H2OPrincipalComponentAnalysisEstimator,
        H2OSingularValueDecompositionEstimator)
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models import dataset_cache
    from h2o3_tpu_torch.models import estimator_engine as est
    from h2o3_tpu_torch.parallel import distdata, mesh

    out_dir, cases = sys.argv[1], sys.argv[2].split(",")
    splits, n = json.loads(sys.argv[3]), int(sys.argv[4])
    set_device("cpu")
    c = mesh.cloud()
    # the reference's `_write_glm_clean_csv` (its values through a CSV at
    # six decimals)
    rng = np.random.default_rng(29)
    X = np.round(rng.normal(size=(n, 3)), 6)
    cat = rng.integers(0, 3, size=n)
    eff = 1.1 * X[:, 0] - 0.6 * X[:, 1] + 0.4 * (cat == 2)
    y = (rng.random(n) < 1 / (1 + np.exp(-eff))).astype(int)
    Xm = X.copy()
    mrng = np.random.default_rng(3)
    Xm[mrng.random(n) < 0.07, 0] = np.nan
    Xm[mrng.random(n) < 0.05, 2] = np.nan
    # a 3-class response from its own seed, and a validation frame of
    # NV rows drawn like the training rows
    crng = np.random.default_rng(41)
    score = np.column_stack([X[:, 0], X[:, 1] - X[:, 0], -X[:, 2]])
    m = np.argmax(2.0 * score + crng.gumbel(size=(n, 3)), axis=1)
    vrng = np.random.default_rng(31)
    NV = 1500
    Xv = np.round(vrng.normal(size=(NV, 3)), 6)
    catv = vrng.integers(0, 3, size=NV)
    effv = 1.1 * Xv[:, 0] - 0.6 * Xv[:, 1] + 0.4 * (catv == 2)
    yv = (vrng.random(NV) < 1 / (1 + np.exp(-effv))).astype(int)
    lo, hi = splits[str(c.size)][c.self_idx:c.self_idx + 2]
    vlo, vhi = {1: (0, NV), 2: (0, 611, NV), 3: (0, 402, 1013, NV)}[
        c.size][c.self_idx:c.self_idx + 2]

    def frame(M, C, Y, lo, hi, mc=None):
        d = {f"x{i + 1}": M[lo:hi, i] for i in range(3)}
        d["cat"] = np.asarray([f"g{v}" for v in C[lo:hi]])
        d["y"] = np.asarray(["yes" if v else "no" for v in Y[lo:hi]])
        types = {"cat": "enum", "y": "enum"}
        if mc is not None:
            d["m"] = np.asarray([f"c{v}" for v in mc[lo:hi]])
            types["m"] = "enum"
        return Frame.from_dict(d, column_types=types)

    fr, frm = frame(X, cat, y, lo, hi, m), frame(Xm, cat, y, lo, hi)
    fv = frame(Xv, catv, yv, vlo, vhi)
    x = ["x1", "x2", "x3", "cat"]
    LS = dict(family="binomial", alpha=0.5, lambda_search=True, nlambdas=8,
              standardize=False, device="cpu")
    # user points in the design's space (x1-x3, unstandardized)
    PTS = np.asarray([[-1.0, 0.5, 0.0], [1.0, -1.0, 0.5], [0.0, 1.0, -1.0]])
    KMUP_ITERS = 200
    GLM = dict(family="binomial", lambda_=0.05, alpha=0.0,
               standardize=False, device="cpu")
    out = {}

    def plan():
        return est.est_stats()["plans"][-1]

    for case in cases:
        base = case[:-2] if case.endswith("24") else case
        if c.size == 1:
            os.environ["H2O3_EST_SHARD_BLOCKS"] = \\
                "24" if case.endswith("24") else "8"
        rec = {}
        if base == "glm":
            m = H2OGeneralizedLinearEstimator(**GLM).train(
                x=x, y="y", training_frame=fr).model
            rec = dict(beta=m.beta, iters=m.fitplan["iterations"],
                       path=plan()["path"], n_shards=plan()["n_shards"])
        elif case == "glmpv":
            m = H2OGeneralizedLinearEstimator(
                **dict(GLM, lambda_=0.0, compute_p_values=True)).train(
                x=x, y="y", training_frame=fr).model
            t = m.coef_with_p_values()
            rec = dict(beta=m.beta, stderr=m.stderr,
                       pv=np.asarray([r["p_value"] for r in t]),
                       path=plan()["path"])
        elif case == "glmstd":
            m = H2OGeneralizedLinearEstimator(
                **dict(GLM, standardize=True)).train(
                x=x, y="y", training_frame=frm).model
            rec = dict(beta=m.beta, means=m.dinfo.means, stds=m.dinfo.stds,
                       col_means=np.asarray([m.dinfo.col_means[k]
                                             for k in ("x1", "x2", "x3")]),
                       path=plan()["path"])
        elif base == "km":
            m = H2OKMeansEstimator(k=3, init="PlusPlus", standardize=False,
                                   seed=7, max_iterations=20,
                                   device="cpu").train(
                x=x, training_frame=fr).model
            rec = dict(centers=m.centers_std, wss=m.fit_wss,
                       iters=m.iterations, path=plan()["path"])
        elif base in ("pca", "pcad", "pcar"):
            m = H2OPrincipalComponentAnalysisEstimator(
                k=3, transform="NONE" if base == "pca" else "DEMEAN",
                pca_method="Randomized" if base == "pcar" else "GramSVD",
                seed=3, device="cpu").train(x=x, training_frame=fr).model
            rec = dict(evals=m.eigenvalues, evecs=m.eigenvectors,
                       path=plan()["path"])
        elif base == "ls":
            m = H2OGeneralizedLinearEstimator(**LS).train(
                x=x, y="y", training_frame=fr, validation_frame=fv).model
            rec = dict(beta=m.beta, lambda_best=m.lambda_best,
                       lambdas=np.asarray([lv for lv, _ in m.full_path]),
                       path_beta=np.stack([b for _, b in m.full_path]),
                       devs=np.asarray(m.fitplan["path_deviances"]),
                       best=m.fitplan["best_index"],
                       iters=m.fitplan["irls_iterations"],
                       path=plan()["path"], n_shards=plan()["n_shards"])
        elif base == "mn":
            m = H2OGeneralizedLinearEstimator(
                family="multinomial", alpha=0.0, lambda_=1e-3,
                standardize=False, device="cpu").train(
                x=x, y="m", training_frame=fr).model
            rec = dict(beta=m.beta, iters=m.fitplan["iterations"],
                       evals=m.fitplan["func_evals"],
                       probs=m._score(fr, by_columns=True),
                       n_shards=plan()["n_shards"])
        elif base == "kmup":
            m = H2OKMeansEstimator(k=3, user_points=PTS, standardize=False,
                                   max_iterations=KMUP_ITERS,
                                   device="cpu").train(
                x=x[:3], training_frame=fr).model
            rec = dict(centers=m.centers_std, wss=m.fit_wss,
                       iters=m.iterations, path=plan()["path"])
        elif base == "svd":
            for method, tr in (("GramSVD", "NONE"), ("Power", "DEMEAN"),
                               ("Randomized", "DESCALE"),
                               ("Randomized", "STANDARDIZE")):
                m = H2OSingularValueDecompositionEstimator(
                    nv=3, svd_method=method, transform=tr, seed=4,
                    device="cpu").train(x=x, training_frame=fr).model
                rec.update({f"{k}_{method}_{tr}": v for k, v in (
                    ("d", m.d), ("v", m.v), ("u", m.u))})
                rec[f"path_{method}_{tr}"] = plan()["path"]
        elif base in ("cvgbm", "cvglm", "cvls"):
            if base == "cvgbm":
                e = H2OGradientBoostingEstimator(
                    ntrees=5, max_depth=3, seed=5, nfolds=3, device="cpu")
            elif base == "cvls":
                e = H2OGeneralizedLinearEstimator(nfolds=3, seed=5, **LS)
            else:
                e = H2OGeneralizedLinearEstimator(nfolds=3, seed=5, **GLM)
            m = e.train(x=x, y="y", training_frame=fr).model
            folds = m.cross_validation_models
            if base == "cvgbm":
                for i, fm in enumerate(folds):
                    for j, t in enumerate(fm.forest[0]):
                        rec[f"fold{i}_{j}"] = t.cpu().numpy()
            else:
                for i, fm in enumerate(folds):
                    rec[f"fold{i}_beta"] = fm.beta
            xm = m.cross_validation_metrics
            rec.update(holdout=m._cv_holdout_pred,
                       xval=np.asarray([xm.auc, xm.logloss]),
                       fold_auc=np.asarray([fm.validation_metrics.auc
                                            for fm in folds]))
        elif case == "guard":
            sup = dict(x=x, y="y", training_frame=fr)
            for name, fit in (
                    ("dl", lambda: H2ODeepLearningEstimator(
                        epochs=1, device="cpu").train(**sup)),
                    ("nb", lambda: H2ONaiveBayesEstimator(
                        device="cpu").train(**sup)),
                    ("glrm", lambda: H2OGeneralizedLowRankEstimator(
                        k=2, device="cpu").train(x=x, training_frame=fr)),
                    ("glm_search", lambda: H2OGeneralizedLinearEstimator(
                        lambda_search=True, nlambdas=4,
                        device="cpu").train(**sup))):
                try:
                    fit()
                    rec[name] = "fitted"
                except NotImplementedError as err:
                    rec[name] = str(err)
        out[case] = rec
        np.savez(os.path.join(out_dir, f"{case}_{c.size}_{c.self_idx}.npz"),
                 row_off=distdata.row_offset(fr.nrow), nrow=fr.nrow,
                 **{k: np.asarray(v) for k, v in rec.items()})
        dataset_cache.clear()
    print("rank", c.self_idx, "of", c.size, "ok", flush=True)
''')


def _launch(tmp: Path, nprocs: int, cases, env=None):
    """Start `nprocs` ranks (the launcher with no flags for one), each
    running RANK_SCRIPT over `cases`; returns the Popen handles."""
    import json

    tmp.mkdir(exist_ok=True)
    script = tmp / "rank.py"
    if not script.exists():
        script.write_text(RANK_SCRIPT)
    e = {k: v for k, v in os.environ.items()
         if not k.startswith("H2O3_")}
    e.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
             H2O3_DATASET_CACHE="1")
    e.update(env or {})
    args = [str(tmp), ",".join(cases), json.dumps(
        {str(k): v for k, v in SPLITS.items()}), str(N_ROWS)]
    store = tmp / f"store_{nprocs}"
    procs = []
    for r in range(nprocs):
        cmd = [sys.executable, "-m", "h2o3_tpu_torch.parallel.launcher"]
        if nprocs > 1:
            cmd += ["--coordinator", f"file://{store}", "--nprocs",
                    str(nprocs), "--rank", str(r)]
        log = open(tmp / f"log_{nprocs}_{r}.txt", "w")
        procs.append((subprocess.Popen(cmd + [str(script)] + args, cwd=ROOT,
                                       env=e, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def _join(launches):
    """Wait for every launch under one hard deadline; kill every child
    still alive, whatever happened; raise with the log of a rank that
    failed."""
    deadline = time.monotonic() + TIMEOUT_S
    every = [p for procs in launches for p, _ in procs]
    try:
        while any(p.poll() is None for p in every):
            if any(p.poll() not in (None, 0) for p in every):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after {TIMEOUT_S} s")
            time.sleep(0.1)
    finally:
        for procs in launches:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
    bad = [(p.args, Path(log.name).read_text()[-3000:])
           for procs in launches for p, log in procs if p.returncode != 0]
    if bad:
        raise AssertionError(f"a rank failed: {bad[0][0]}\n{bad[0][1]}")


@pytest.fixture(scope="module")
def est_runs(tmp_path_factory):
    """One launch each, side by side: two ranks (every case and the
    guard), three ranks (the lane cases at S = 24) and the one-rank
    blocks-lane comparator of every case."""
    tmp = tmp_path_factory.mktemp("estpod")
    one_env = {"H2O3_EST_SHARD": "1", "H2O3_TREE_SHARD": "1",
               "H2O3_CV_REBIN": "1"}
    launches = [
        _launch(tmp, 2, CASES + ["guard"]),
        _launch(tmp, 3, CASES24),
        _launch(tmp, 1, CASES + CASES24, env=one_env),
    ]
    _join(launches)

    def load(case, size, rank):
        return np.load(tmp / f"{case}_{size}_{rank}.npz")

    return load


def _equal(one, pod, keys):
    for k in keys:
        np.testing.assert_array_equal(pod[k], one[k], err_msg=k)


def _rows(one, pod, key):
    """A rank's rows of a per-row output against the same rows of the
    one-rank fit's."""
    off, nr = int(pod["row_off"]), int(pod["nrow"])
    assert pod[key].shape[0] == nr, key
    np.testing.assert_array_equal(pod[key], one[key][off:off + nr],
                                  err_msg=key)


def _check_glm(load, case, nranks, n_shards):
    one = load(case, 1, 0)
    assert str(one["path"]) == "fused_blocks"
    assert int(one["n_shards"]) == n_shards
    for r in range(nranks):
        pod = load(case, nranks, r)
        assert str(pod["path"]) == "fused_mesh"
        assert int(pod["n_shards"]) == n_shards
        _equal(one, pod, ("beta", "iters"))


def _check_p_values(load):
    one = load("glmpv", 1, 0)
    for r in range(2):
        _equal(one, load("glmpv", 2, r), ("beta", "stderr", "pv"))
    assert np.isfinite(one["stderr"]).all()


def _check_standardized(load):
    """Global moments: the pod's statistics are f64 sums over the ranks,
    not the one-process `np.nanmean` bits."""
    one = load("glmstd", 1, 0)
    for r in range(2):
        pod = load("glmstd", 2, r)
        tol = BETA_TOL * np.maximum(1.0, np.abs(one["beta"]))
        assert np.all(np.abs(pod["beta"] - one["beta"]) <= tol)
        for k in ("means", "stds", "col_means"):
            np.testing.assert_allclose(pod[k], one[k], rtol=STAT_RTOL,
                                       atol=0, err_msg=k)


def _check_unsupervised(load):
    """K-Means (drawn and user centres) and PCA (GramSVD, Randomized):
    the pod's paths `fused_mesh` against `fused_blocks`, every output bit
    for bit."""
    for suffix, nranks, _ in LANES:
        for base, keys in (("km", ("centers", "wss", "iters")),
                           ("kmup", ("centers", "wss", "iters")),
                           ("pca", ("evals", "evecs")),
                           ("pcad", ("evals", "evecs")),
                           ("pcar", ("evals", "evecs"))):
            one = load(base + suffix, 1, 0)
            assert str(one["path"]) == "fused_blocks"
            if base == "kmup":
                # the f64 stop test fired (the cap is 200)
                assert int(one["iters"]) < 200
            for r in range(nranks):
                pod = load(base + suffix, nranks, r)
                assert str(pod["path"]) == "fused_mesh"
                _equal(one, pod, keys)


def _check_lambda_search(load):
    """The λ path with a validation frame: every λ, path β, deviance and
    the choice, then the f64 re-solve."""
    for suffix, nranks, n_shards in LANES:
        one = load("ls" + suffix, 1, 0)
        assert str(one["path"]) == "fused_path"
        assert int(one["n_shards"]) == n_shards
        assert np.isfinite(one["devs"]).all() and len(one["lambdas"]) == 8
        for r in range(nranks):
            pod = load("ls" + suffix, nranks, r)
            _equal(one, pod, ("beta", "lambda_best", "lambdas", "path_beta",
                              "devs", "best", "iters", "path", "n_shards"))


def _check_multinomial(load):
    for suffix, nranks, n_shards in LANES:
        one = load("mn" + suffix, 1, 0)
        assert int(one["n_shards"]) == n_shards
        assert one["beta"].shape == (3, 6)
        for r in range(nranks):
            pod = load("mn" + suffix, nranks, r)
            _equal(one, pod, ("beta", "iters", "evals", "n_shards"))
            _rows(one, pod, "probs")


def _check_svd(load):
    """d, v and u of each method bit for bit; the STANDARDIZE fit, whose
    moments are global f64 sums, within BETA_TOL."""
    for suffix, nranks, _ in LANES:
        one = load("svd" + suffix, 1, 0)
        for r in range(nranks):
            pod = load("svd" + suffix, nranks, r)
            for method, tr in (("GramSVD", "NONE"), ("Power", "DEMEAN"),
                               ("Randomized", "DESCALE")):
                tag = f"{method}_{tr}"
                assert str(one[f"path_{tag}"]) == "fused_blocks"
                assert str(pod[f"path_{tag}"]) == "fused_mesh"
                _equal(one, pod, (f"d_{tag}", f"v_{tag}"))
                _rows(one, pod, f"u_{tag}")
            tag = "Randomized_STANDARDIZE"
            off, nr = int(pod["row_off"]), int(pod["nrow"])
            for k, want in ((f"d_{tag}", one[f"d_{tag}"]),
                            (f"v_{tag}", one[f"v_{tag}"]),
                            (f"u_{tag}", one[f"u_{tag}"][off:off + nr])):
                assert np.all(np.abs(pod[k] - want)
                              <= BETA_TOL * np.maximum(1.0, np.abs(want))), k


def _check_cv(load, case, nranks=2):
    one = load(case, 1, 0)
    folds = [k for k in one.files if k.startswith("fold") and k != "fold_auc"]
    assert len(folds) >= 3
    for r in range(nranks):
        pod = load(case, nranks, r)
        _equal(one, pod, folds + ["xval", "fold_auc"])
        _rows(one, pod, "holdout")


def test_pod_fits_equal_the_blocks_lane(est_runs):
    """Every pod fit against the one-rank blocks lane at its S."""
    _check_glm(est_runs, "glm", 2, 8)
    _check_glm(est_runs, "glm24", 3, 24)
    _check_p_values(est_runs)
    _check_standardized(est_runs)
    _check_unsupervised(est_runs)
    _check_lambda_search(est_runs)
    _check_multinomial(est_runs)
    _check_svd(est_runs)
    for case in ("cvgbm", "cvglm", "cvls"):
        _check_cv(est_runs, case)
    _check_cv(est_runs, "cvls24", 3)


def test_fits_without_a_pod_lane_raise_on_every_rank(est_runs):
    """DeepLearning, NaiveBayes and GLRM have no pod lane: each raises on
    both ranks, naming item 9, and the ranks went on to exit (the launch
    joined). A λ-search GLM, which has the lane, fits on both."""
    for r in range(2):
        g = est_runs("guard", 2, r)
        for name, cls in (("dl", "H2ODeepLearningEstimator"),
                          ("nb", "H2ONaiveBayesEstimator"),
                          ("glrm", "H2OGeneralizedLowRankEstimator")):
            msg = str(g[name])
            assert cls in msg and "ROADMAP queue A, item 9" in msg, msg
        assert str(g["glm_search"]) == "fitted"
