"""Tree fits across processes: the port's pod lane on gloo ranks on the CPU.

Each rank is a fresh interpreter started through the port's launcher
(`python -m h2o3_tpu_torch.parallel.launcher --coordinator file://…
--nprocs N --rank r`), rendezvousing through a `FileStore` under the
test's temporary directory, so parallel test workers never share a port.
A rank draws the frame from the seed, keeps only its own ingest shard of
the rows (an uneven split, so the canonical exchange moves rows), builds
its `Frame` from those rows alone and fits. The one-rank comparator is
the launcher with no flags under ``H2O3_TREE_SHARD=1`` (the blocks lane)
at the same S. Every launch is joined with a hard timeout, and every
child is killed on failure or timeout.

- (1) A 2-rank GBM on the reference's pod fixture (`tests/
  test_multiprocess.py`'s `pod_gbm_runs`: 5,000 rows, six numeric
  columns and an enum, 30 trees at depth 4, `score_each_iteration`, an
  early stop that fires), built from numpy: the forest, varimp, scoring
  history, tree count and each rank's `predict` on its own rows equal the
  one-rank blocks-lane fit at S = 8 bit for bit. Each rank's peaks meet
  the reference's pins: the memory ledger's host watermark ≤ 0.80× the
  one-rank fit's, and the resident code matrix on the fit's device (the
  dataset cache's device layer; on the CPU it is host memory, on the card
  `test_torch_cuda.py` pins the allocator's peak) ≤ 0.75×. The one-rank
  fit is held against the reference's blocks-lane fit on the same frame
  with the tolerances of `test_torch_tree_stream.py`.
- (2) Three ranks with uneven shards: S = lcm(8, 3) = 24, equal to the
  blocks lane at S = 24.
- (3) A 2-rank DRF with row sampling, mtries and out-of-bag scoring
  events, and a 2-rank QuantilesGlobal GBM (its edges from the global
  quantile collective), each equal to the blocks lane at S = 8.
- (4) The GBM of (1) on four ranks and 8,000 rows: S = 8, two blocks a
  rank, slices that are no multiple of the CPU's SIMD step.
- (5) A 2-rank GBM with a validation frame split over the ranks.
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
LEAF_RTOL, LEAF_ATOL, PRED_TOL = 1e-5, 1e-6, 1e-6
N_ROWS = 5000
# each rank's first ingest row: uneven shards
SPLITS = {1: [0, N_ROWS], 2: [0, 2493, N_ROWS], 3: [0, 1601, 3370, N_ROWS]}
# (4): 8,000 rows on four ranks, 2,000-row slices
N4 = 8000
SPLITS4 = {1: [0, N4], 4: [0, 1999, 4003, 6000, N4]}
TIMEOUT_S = 240

RANK_SCRIPT = textwrap.dedent('''
    import os, sys, json
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from h2o3_tpu_torch import set_device
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models import dataset_cache
    from h2o3_tpu_torch.parallel import distdata, mesh
    from h2o3_tpu_torch.runtime import memory_ledger

    out_dir, cases = sys.argv[1], sys.argv[2].split(",")
    splits, n, device = json.loads(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    if device == "cpu":
        set_device("cpu")
    c = mesh.cloud()
    if c.size > 1:
        # the launcher's topology again answers with the live cloud; a
        # conflicting one raises instead of re-forming the group
        coord, nprocs, rank = mesh._dist_topology
        assert mesh.init(coord, nprocs, rank) is c
        try:
            mesh.init(coord, nprocs + 1, rank)
            raise AssertionError("a conflicting topology did not raise")
        except RuntimeError:
            pass
    rng = np.random.default_rng(7)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    cat = rng.integers(0, 3, size=n)
    eff = X[:, 0] + 0.8 * X[:, 1] * X[:, 2] + 0.6 * (cat == 1)
    y = (eff + 0.3 * rng.normal(size=n) > 0).astype(int)
    lo, hi = splits[str(c.size)][c.self_idx:c.self_idx + 2]
    d = {f"x{i}": X[lo:hi, i] for i in range(6)}
    d["c"] = np.asarray([f"k{v}" for v in cat[lo:hi]])
    d["y"] = y[lo:hi].astype(str)
    fr = Frame.from_dict(d, column_types={"c": "enum", "y": "enum"})
    x = [f"x{i}" for i in range(6)] + ["c"]
    # (5)'s validation rows, split like the training rows
    vrng = np.random.default_rng(8)
    nv = 2000
    Xv = vrng.normal(size=(nv, 6)).astype(np.float32)
    catv = vrng.integers(0, 3, size=nv)
    yv = (Xv[:, 0] + 0.8 * Xv[:, 1] * Xv[:, 2] + 0.6 * (catv == 1) > 0)
    vlo, vhi = (c.self_idx * nv // c.size, (c.self_idx + 1) * nv // c.size)
    dv = {f"x{i}": Xv[vlo:vhi, i] for i in range(6)}
    dv["c"] = np.asarray([f"k{v}" for v in catv[vlo:vhi]])
    dv["y"] = yv[vlo:vhi].astype(int).astype(str)
    fv = Frame.from_dict(dv, column_types={"c": "enum", "y": "enum"})
    FITS = dict(
        gbm=(H2OGradientBoostingEstimator, dict(
            ntrees=30, max_depth=4, seed=5, score_each_iteration=True,
            stopping_rounds=2, stopping_tolerance=0.05)),
        gbm3=(H2OGradientBoostingEstimator, dict(
            ntrees=30, max_depth=4, seed=5, score_each_iteration=True,
            stopping_rounds=2, stopping_tolerance=0.05)),
        drf=(H2ORandomForestEstimator, dict(
            ntrees=8, max_depth=8, seed=11, score_tree_interval=2)),
        gbmv=(H2OGradientBoostingEstimator, dict(
            ntrees=10, max_depth=4, seed=5, score_tree_interval=5)),
        qg=(H2OGradientBoostingEstimator, dict(
            ntrees=10, max_depth=4, seed=3, nbins=16, score_tree_interval=5,
            histogram_type="QuantilesGlobal")),
    )
    for case in cases:
        if c.size == 1:
            os.environ["H2O3_TREE_SHARD_BLOCKS"] = \\
                "24" if case == "gbm3" else "8"
        cls, kw = FITS[case]
        est = cls(device=device if device == "cpu" else None, **kw)
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        est.train(x=x, y="y", training_frame=fr,
                  validation_frame=fv if case == "gbmv" else None)
        m = est.model
        peak = memory_ledger.peak()
        alloc = (torch.cuda.max_memory_allocated() - base
                 if device != "cpu" else 0)
        dev_layer = sum(o["host_bytes"] + o["device_bytes"]
                        for o in memory_ledger.owners("dataset_cache")
                        if o["type"] == "device")
        f = [t.cpu() for t in m.forest[0]]
        hist = m.scoring_history
        np.savez(os.path.join(out_dir, f"{case}_{c.size}_{c.self_idx}.npz"),
                 feat=f[0].numpy(), bin=f[1].numpy(), thr=f[2].numpy(),
                 split=f[3].numpy(), value=f[4].numpy(),
                 ntrees=m.ntrees_built,
                 sh_nt=np.asarray([e["number_of_trees"] for e in hist]),
                 sh_loss=np.asarray([e["training_deviance"] for e in hist],
                                    np.float64),
                 sh_vloss=np.asarray([e.get("validation_logloss", np.nan)
                                      for e in hist], np.float64),
                 vi_names=np.asarray([r[0] for r in m.varimp_table]),
                 vi_gain=np.asarray([r[1] for r in m.varimp_table],
                                    np.float64),
                 p1=np.asarray(m.predict(fr).vec("1").data, np.float64),
                 row_off=distdata.row_offset(fr.nrow),
                 peak_host=peak["host_bytes"], dev_layer=dev_layer,
                 dev_alloc=alloc,
                 n_shards=getattr(m, "_pod", {}).get("n_shards", 0))
        dataset_cache.clear()
    print("rank", c.self_idx, "of", c.size, "ok", flush=True)
''')


def _launch(tmp: Path, nprocs: int, cases, env=None, n=N_ROWS,
            splits=None, device="cpu"):
    """Start `nprocs` ranks (the launcher with no flags for one), each
    running RANK_SCRIPT over `cases` on `n` rows cut at `splits` (rank
    count → first rows); returns the Popen handles."""
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
        {str(k): v for k, v in (splits or SPLITS).items()}), str(n), device]
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


def _join(tmp: Path, launches):
    """Wait for every launch under one hard deadline; kill every child
    that is still alive, whatever happened; raise with the logs of a rank
    that failed."""
    deadline = time.monotonic() + TIMEOUT_S
    every = [p for procs in launches for p, _ in procs]
    try:
        # a rank that fails leaves its peers waiting in a collective: stop
        # at the first failure instead of at the deadline
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
def pod_runs(tmp_path_factory):
    """One launch each: two ranks (GBM, DRF, QuantilesGlobal GBM), three
    ranks (GBM at S = 24), four ranks (the GBM) and the one-rank
    blocks-lane comparator of all four fits, run side by side."""
    tmp = tmp_path_factory.mktemp("pod")
    launches = [
        _launch(tmp, 2, ["gbm", "drf", "qg", "gbmv"]),
        _launch(tmp, 3, ["gbm3"]),
        _launch(tmp / "n4", 4, ["gbm"], n=N4, splits=SPLITS4),
        _launch(tmp / "n4", 1, ["gbm"], n=N4, splits=SPLITS4,
                env={"H2O3_TREE_SHARD": "1"}),
        _launch(tmp, 1, ["gbm", "drf", "qg", "gbmv", "gbm3"],
                env={"H2O3_TREE_SHARD": "1"}),
    ]
    _join(tmp, launches)

    def load(case, size, rank, sub=""):
        return np.load(tmp / sub / f"{case}_{size}_{rank}.npz")

    return load


def _assert_pod_equals_blocks(load, case, nranks, n_shards, splits=SPLITS):
    one = load(case, 1, 0)
    for r in range(nranks):
        pod = load(case, nranks, r)
        assert int(pod["n_shards"]) == n_shards
        assert int(pod["ntrees"]) == int(one["ntrees"])
        for k in ("feat", "bin", "thr", "split", "value"):
            np.testing.assert_array_equal(pod[k], one[k], err_msg=k)
        for k in ("sh_nt", "sh_loss", "vi_names", "vi_gain"):
            np.testing.assert_array_equal(pod[k], one[k], err_msg=k)
        # this rank's predictions == the same ingest rows of the one-rank
        # fit's, bit for bit
        off, nr = int(pod["row_off"]), len(pod["p1"])
        assert off == splits[nranks][r] and nr == (splits[nranks][r + 1]
                                                   - splits[nranks][r])
        np.testing.assert_array_equal(pod["p1"], one["p1"][off:off + nr])


def _check_pod_gbm(pod_runs):
    one = pod_runs("gbm", 1, 0)
    assert int(one["ntrees"]) < 30          # the early stop fired
    _assert_pod_equals_blocks(pod_runs, "gbm", 2, 8)


def _check_pod_gbm_memory(pod_runs):
    """No rank stages the global matrix: its ledger peaks are about half
    the one-rank fit's (replicated model state keeps them above)."""
    one = pod_runs("gbm", 1, 0)
    for r in range(2):
        pod = pod_runs("gbm", 2, r)
        assert int(pod["peak_host"]) <= 0.80 * int(one["peak_host"]), (
            r, int(pod["peak_host"]), int(one["peak_host"]))
        assert 0 < int(pod["dev_layer"]) <= 0.75 * int(one["dev_layer"]), (
            r, int(pod["dev_layer"]), int(one["dev_layer"]))


def _check_three_ranks(pod_runs):
    _assert_pod_equals_blocks(pod_runs, "gbm3", 3, 24)


def _check_four_ranks(pod_runs):
    """Four ranks at S = 8 on 8,000 rows: 2,000-row slices, not a multiple
    of the CPU's SIMD step, so the ranks' per-row exp and log run on
    aligned padding (`shared_tree._aligned_rows`)."""
    _assert_pod_equals_blocks(
        lambda c, s, r: pod_runs(c, s, r, "n4"), "gbm", 4, 8, SPLITS4)


def _check_drf_or_qg(pod_runs, case):
    _assert_pod_equals_blocks(pod_runs, case, 2, 8)
    if case == "drf":
        # out-of-bag scoring events every other tree
        np.testing.assert_array_equal(pod_runs(case, 2, 0)["sh_nt"],
                                      [2, 4, 6, 8])


def _check_validation(pod_runs):
    """(5) A validation frame split over two ranks: the trees are the
    one-rank fit's, the validation events fold the ranks' sums (the same
    on both ranks, the one-rank mean within 1e-6)."""
    one = pod_runs("gbmv", 1, 0)
    a, b = pod_runs("gbmv", 2, 0), pod_runs("gbmv", 2, 1)
    for k in ("feat", "bin", "thr", "split", "value", "sh_loss"):
        np.testing.assert_array_equal(a[k], one[k], err_msg=k)
    np.testing.assert_array_equal(a["sh_vloss"], b["sh_vloss"])
    assert np.isfinite(a["sh_vloss"]).all() and len(a["sh_vloss"]) == 2
    np.testing.assert_allclose(a["sh_vloss"], one["sh_vloss"], rtol=1e-6)


def test_pod_fits_bit_identical_to_the_blocks_lane(pod_runs):
    """(1)-(5), each check a function of its own. Two test ids in all: a
    new file with few ids sits at the end of xdist's loadfile queue (files
    ordered by test count), so the suite's other files keep their order."""
    _check_pod_gbm(pod_runs)
    _check_pod_gbm_memory(pod_runs)
    _check_three_ranks(pod_runs)
    _check_four_ranks(pod_runs)
    for case in ("drf", "qg"):
        _check_drf_or_qg(pod_runs, case)
    _check_validation(pod_runs)


def test_one_rank_blocks_lane_matches_the_reference(pod_runs, monkeypatch):
    """The oracle's own anchor: the one-rank blocks-lane GBM against the
    reference's blocks lane (``H2O3_TREE_SHARD=1`` on one device) on the
    same frame."""
    import jax

    from h2o3_tpu.frame.frame import Frame as RefFrame
    from h2o3_tpu.models import dataset_cache as ref_cache
    from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
    from h2o3_tpu.parallel import mesh

    one = pod_runs("gbm", 1, 0)
    rng = np.random.default_rng(7)
    X = rng.normal(size=(N_ROWS, 6)).astype(np.float32)
    cat = rng.integers(0, 3, size=N_ROWS)
    eff = X[:, 0] + 0.8 * X[:, 1] * X[:, 2] + 0.6 * (cat == 1)
    y = (eff + 0.3 * rng.normal(size=N_ROWS) > 0).astype(int)
    d = {f"x{i}": X[:, i] for i in range(6)}
    d["c"] = np.asarray([f"k{v}" for v in cat])
    d["y"] = y.astype(str)
    fr = RefFrame.from_dict(d, column_types={"c": "enum", "y": "enum"})
    monkeypatch.setenv("H2O3_TREE_SHARD", "1")
    monkeypatch.setenv("H2O3_TREE_SHARD_BLOCKS", "8")
    ref_cache.clear()
    mesh.init(jax.devices()[:1])
    try:
        ref = RefGBM(ntrees=30, max_depth=4, seed=5,
                     score_each_iteration=True, stopping_rounds=2,
                     stopping_tolerance=0.05)
        ref.train(x=[f"x{i}" for i in range(6)] + ["c"], y="y",
                  training_frame=fr)
        ref_p1 = np.asarray(ref.model.predict(fr).vec("1").data)
    finally:
        mesh.reset()
        ref_cache.clear()
    rf = ref.model.forest[0]
    assert int(one["ntrees"]) == ref.model.ntrees_built
    for k, rk in (("feat", "feat"), ("bin", "bin"), ("split", "is_split")):
        np.testing.assert_array_equal(one[k], np.asarray(getattr(rf, rk)),
                                      err_msg=k)
    np.testing.assert_allclose(one["value"], np.asarray(rf.value),
                               rtol=LEAF_RTOL, atol=LEAF_ATOL)
    np.testing.assert_allclose(one["p1"], ref_p1, rtol=0, atol=PRED_TOL)
