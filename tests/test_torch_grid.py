"""Grid search and the train pool of the port against the reference's, on
the CPU.

- Cartesian and RandomDiscrete walks give the reference's combos in its
  order (numpy's shuffle, as in the reference);
- a RandomDiscrete grid of GBMs trains the same models: each model's
  training AUC and logloss within METRIC_TOL = 1e-5 of the reference's
  and `get_grid("auc")` in its order; `parallelism=2` gives the grid of
  `parallelism=1` bit for bit;
- recovery: the state file and the artifacts round-trip through `load`,
  `save` and the automatic resume, which trains only the combos a killed
  sweep left (the `resumed` counter counts the rest), and a grid the
  reference saved loads into the port;
- a combo that fails is recorded and the walk goes on;
- jobs: a cancelled parent job skips the candidates not started, a
  cancel reaches a running tree or DeepLearning fit at its next safe
  point, and the watchdog deadline records a runaway candidate failed;
- retries: a device fault injected at ``trainpool.candidate`` is retried
  once and the candidate is built; a permanent fault is not retried.
"""

import os

import numpy as np
import pytest

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.models.grid import H2OGridSearch as RefGrid
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.estimators import (H2ODeepLearningEstimator,
                                       H2OGradientBoostingEstimator,
                                       H2OGridSearch)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import Job, JobCancelled
from h2o3_tpu_torch.runtime import faults, trainpool

from conftest import make_classification
from test_torch_deeplearning import one_torch_thread  # noqa: F401

METRIC_TOL = 1e-5
HP = {"max_depth": [2, 3, 4, 5], "learn_rate": [0.05, 0.1, 0.2, 0.3]}
SC = {"strategy": "RandomDiscrete", "max_models": 3, "seed": 7}
NAMES = [f"x{i}" for i in range(5)] + ["y"]


def _data(n=800, seed=6):
    X, y = make_classification(n, 5, seed)
    return np.column_stack([X, y])


def _frames(d):
    return (RefFrame.from_numpy(d, names=NAMES).asfactor("y"),
            Frame.from_numpy(d, names=NAMES).asfactor("y"))


def _port_grid(**kw):
    return H2OGridSearch(
        H2OGradientBoostingEstimator(ntrees=5, seed=1, device="cpu"), HP,
        search_criteria=dict(SC), **kw)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """The reference's RandomDiscrete grid (saved with a recovery dir) and
    the port's, fitted once on a one-device cloud."""
    rf, pf = _frames(_data())
    ref_dir = str(tmp_path_factory.mktemp("ref_grid"))
    mesh.init(jax.devices()[:1])
    try:
        ref = RefGrid(RefGBM(ntrees=5, seed=1), HP, grid_id="g",
                      search_criteria=dict(SC), recovery_dir=ref_dir)
        ref.train(y="y", training_frame=rf)
    finally:
        mesh.reset()
    port = _port_grid(grid_id="g")
    port.train(y="y", training_frame=pf)
    return dict(ref=ref, port=port, rf=rf, pf=pf, ref_dir=ref_dir)


def test_combos_match_the_reference():
    for sc in (None, {"strategy": "Cartesian"}, SC,
               {"strategy": "RandomDiscrete", "seed": 11}):
        ref = RefGrid(RefGBM, HP, search_criteria=sc)._combos()
        port = H2OGridSearch(H2OGradientBoostingEstimator, HP,
                             search_criteria=sc)._combos()
        assert port == ref
    assert len(port) == 16


def test_grid_matches_the_reference(grids):
    ref, port = grids["ref"], grids["port"]
    assert [m._grid_combo for m in port] == [m._grid_combo for m in ref]
    for p, r in zip(port, ref):
        assert abs(p.auc() - r.auc()) <= METRIC_TOL
        assert abs(p.logloss() - r.logloss()) <= METRIC_TOL
    ref.get_grid("auc")
    port.get_grid("auc")
    assert [m._grid_combo for m in port] == [m._grid_combo for m in ref]
    aucs = [m.auc() for m in port]
    assert aucs == sorted(aucs, reverse=True)
    assert [s["max_depth"] for s in port.summary()] == \
        [m._grid_combo["max_depth"] for m in port]
    # two candidates in flight give the same grid, model for model
    par = _port_grid(grid_id="g_par", parallelism=2)
    par.train(y="y", training_frame=grids["pf"])
    assert trainpool.snapshot()["last_pool"]["parallelism"] == 2
    seq = _port_grid(grid_id="g_seq")
    seq.train(y="y", training_frame=grids["pf"])
    assert [m._grid_combo for m in par] == [m._grid_combo for m in seq]
    for a, b in zip(par, seq):
        np.testing.assert_array_equal(
            np.asarray(a.predict(grids["pf"]).vec("1").data),
            np.asarray(b.predict(grids["pf"]).vec("1").data))


def test_recovery_round_trips(grids, tmp_path):
    pf = grids["pf"]
    rec = str(tmp_path / "rec")
    g = _port_grid(grid_id="gr", recovery_dir=rec)
    g.train(y="y", training_frame=pf)
    assert os.path.exists(os.path.join(rec, "gr.grid.json"))
    want = {str(m._grid_combo): np.asarray(m.predict(pf).vec("1").data)
            for m in g}
    back = H2OGridSearch.load(rec, "gr")
    assert len(back) == 3 and back._combos() == g._combos()
    for m in back:
        np.testing.assert_allclose(
            np.asarray(m.predict(pf).vec("1").data),
            want[str(m._grid_combo)], rtol=0, atol=1e-6)
        assert m.auc() == pytest.approx(
            next(x for x in g if x._grid_combo == m._grid_combo).auc())
    # a sweep killed after its first combo: the re-submitted sweep
    # restores that combo and trains the other two
    import json
    path = os.path.join(rec, "gr.grid.json")
    state = json.load(open(path))
    state["done_combos"] = state["done_combos"][:1]
    json.dump(state, open(path, "w"))
    before = trainpool.snapshot()["totals"]
    again = _port_grid(grid_id="gr", recovery_dir=rec)
    again.train(y="y", training_frame=pf)
    after = trainpool.snapshot()["totals"]
    assert after["resumed"] - before["resumed"] == 1
    assert after["submitted"] - before["submitted"] == 2
    assert sorted(str(m._grid_combo) for m in again) == sorted(want)
    # save() into another directory, loaded as a whole
    out = again.save(str(tmp_path / "saved"))
    assert len(H2OGridSearch.load(out, "gr")) == 3
    # the reference's saved grid loads into the port and scores as it does
    ref_back = H2OGridSearch.load(grids["ref_dir"], "g")
    assert ref_back.model_class is H2OGradientBoostingEstimator
    assert len(ref_back) == 3
    ref_pred = {str(m._grid_combo): np.asarray(m.predict(grids["rf"])
                                               .vec("1").data)
                for m in grids["ref"]}
    for m in ref_back:
        np.testing.assert_allclose(np.asarray(m.predict(pf).vec("1").data),
                                   ref_pred[str(m._grid_combo)],
                                   rtol=0, atol=1e-6)


def test_failed_combo_is_recorded_and_the_walk_goes_on(grids):
    g = H2OGridSearch(
        H2OGradientBoostingEstimator(ntrees=2, seed=1, device="cpu"),
        {"distribution": ["bernoulli", "no_such_family"],
         "max_depth": [2, 3]})
    g.train(y="y", training_frame=grids["pf"])
    assert [m._grid_combo for m in g] == [
        {"distribution": "bernoulli", "max_depth": 2},
        {"distribution": "bernoulli", "max_depth": 3}]
    assert [f["params"]["max_depth"] for f in g.failed] == [2, 3]
    assert all("no_such_family" in f["error"] for f in g.failed)
    with pytest.raises(NotImplementedError, match="item 11"):
        g._remote_train(None, "y", grids["pf"])


def test_jobs_cancel_at_safe_points(grids):
    pf = grids["pf"]
    # a cancel of the sweep's job: the running candidate finishes, the
    # ones not started are skipped
    parent = Job(dest="sweep").start()

    def first(job):
        est = H2OGradientBoostingEstimator(ntrees=3, device="cpu")
        est._external_job = job
        est.train(y="y", training_frame=pf)
        parent.cancel()
        return est

    def never(job):
        raise AssertionError("a cancelled sweep started a candidate")

    recs = trainpool.TrainPool(1, parent_job=parent).run(
        [("a", first), ("b", never), ("c", never)])
    assert [r.status for r in recs] == ["done", "cancelled", "cancelled"]
    assert recs[0].result.job.status == "DONE"
    assert set(recs[0].phases) >= {"host_prep", "h2d", "compute", "metrics"}
    # a pending cancel stops a fit at its first safe point
    for est in (H2OGradientBoostingEstimator(ntrees=30, device="cpu"),
                H2ODeepLearningEstimator(hidden=[4], epochs=1,
                                         device="cpu")):
        job = Job(dest="one").start()
        job.cancel()
        est._external_job = job
        with pytest.raises(JobCancelled):
            est.train(y="y", training_frame=pf)
        assert job.status == "CANCELLED"
    # the watchdog cancels a runaway candidate at its next chunk end and
    # records it failed
    w0 = trainpool.snapshot()["totals"]["watchdog_cancelled"]

    def slow(job):
        est = H2OGradientBoostingEstimator(ntrees=50, device="cpu")
        est._external_job = job
        return est.train(y="y", training_frame=pf)

    (rec,) = trainpool.TrainPool(1, candidate_deadline_s=1e-3).run(
        [("slow", slow)])
    assert rec.status == "failed" and "watchdog" in rec.error
    assert trainpool.snapshot()["totals"]["watchdog_cancelled"] == w0 + 1


def test_candidate_retries_a_device_fault():
    built = []

    def fn(job):
        built.append(job)
        return "model"

    r0 = trainpool.snapshot()["totals"]["retried"]
    faults.reset()
    try:
        # the first check of "first" raises a device error: one retry
        faults.arm("trainpool.candidate", error="device", count=1,
                   match="first")
        recs = trainpool.TrainPool(1).run([("first", fn), ("second", fn)])
        assert [(r.status, r.retries, r.result) for r in recs] == [
            ("done", 1, "model"), ("done", 0, "model")]
        assert len(built) == 2
        assert trainpool.snapshot()["totals"]["retried"] == r0 + 1
        # a device fault at every attempt: one retry, then failed
        faults.arm("trainpool.candidate", error="device", rate=1.0)
        (rec,) = trainpool.TrainPool(1).run([("third", fn)])
        assert (rec.status, rec.retries) == ("failed", 1)
        assert "injected" in rec.error
        # a permanent fault fails on the first attempt
        faults.arm("trainpool.candidate", error="crash", count=1)
        (rec,) = trainpool.TrainPool(1).run([("fourth", fn)])
        assert (rec.status, rec.retries) == ("failed", 0)
        assert len(built) == 2
    finally:
        faults.reset()
