"""Scoring history and early stopping: `ScoreKeeper` against the
reference's, the event positions, and fits through the JAX package
(one-device cloud) and the port on the CPU that stop early — with and
without `score_tree_interval`, with and without a validation frame, GBM and
DRF (whose training events are out-of-bag), and a `weights_column` fit.

On each fixture the stop fires well before `ntrees`, and both packages
must stop at the same iteration, with the same forest structure, the same
history rows (`number_of_trees` and keys exactly) and metric values within
1e-5. The stopping iteration must also equal `ScoreKeeper` replayed on the
history the fit recorded.
"""

import math

import numpy as np
import pytest

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.models.model_base import ScoreKeeper as RefScoreKeeper
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import ScoreKeeper, ScoringHistory
from h2o3_tpu_torch.models.shared_tree import score_events

from test_torch_gbm import make_higgs_like

F = 8
NAMES = [f"f{i}" for i in range(F)] + ["label", "w"]
TOL = 1e-5

GBM4 = dict(max_depth=4, learn_rate=0.3, stopping_rounds=2, seed=42)
# case -> (algo, uses the validation frame, parameters, iterations it stops at)
CASES = {
    "gbm_valid_interval": ("gbm", True, dict(
        GBM4, ntrees=40, stopping_tolerance=0.01, score_tree_interval=3), 30),
    "gbm_valid": ("gbm", True, dict(
        GBM4, ntrees=60, learn_rate=0.5, stopping_tolerance=0.01), 40),
    "gbm_train_interval": ("gbm", False, dict(
        GBM4, ntrees=40, stopping_tolerance=0.05, score_tree_interval=3), 18),
    "gbm_train": ("gbm", False, dict(
        GBM4, ntrees=60, stopping_tolerance=0.2), 40),
    "drf_oob_interval": ("drf", False, dict(
        ntrees=40, max_depth=8, seed=42, stopping_rounds=2,
        stopping_tolerance=0.01, score_tree_interval=3), 24),
    "drf_valid_interval": ("drf", True, dict(
        ntrees=40, max_depth=8, seed=42, stopping_rounds=2,
        stopping_tolerance=0.01, score_tree_interval=3), 15),
    "gbm_weighted_valid": ("gbm", True, dict(
        GBM4, ntrees=30, max_depth=3, learn_rate=0.5, stopping_tolerance=0.01,
        score_tree_interval=3, weights_column="w"), 18),
}


def _data(n, seed):
    X, y = make_higgs_like(n, n_feat=F, seed=seed)
    w = np.random.default_rng(seed + 4).choice([0.5, 1.0, 2.0], n)
    return np.column_stack([X, y, w])


@pytest.fixture(scope="module")
def fits():
    train, valid = _data(2000, 0), _data(1000, 1)
    frames = {}
    for tag, d in (("train", train), ("valid", valid)):
        frames[tag] = (RefFrame.from_numpy(d, names=NAMES).asfactor("label"),
                       Frame.from_numpy(d, names=NAMES).asfactor("label"))
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for case, (algo, use_valid, params, _) in CASES.items():
            Ref, Port = ((RefGBM, H2OGradientBoostingEstimator) if algo == "gbm"
                         else (RefDRF, H2ORandomForestEstimator))
            if "weights_column" not in params:
                params = dict(params, ignored_columns=["w"])
            ref, port = Ref(**params), Port(device="cpu", **params)
            ref.train(y="label", training_frame=frames["train"][0],
                      validation_frame=frames["valid"][0] if use_valid else None)
            port.train(y="label", training_frame=frames["train"][1],
                       validation_frame=frames["valid"][1] if use_valid else None)
            out[case] = (ref, port)
    finally:
        mesh.reset()
    return out


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("metric", ["logloss", "auc"])
def test_score_keeper_matches_the_reference(k, metric):
    rng = np.random.default_rng(k)
    for tol in (0.0, 1e-3, 0.05):
        seq = np.cumsum(rng.normal(scale=0.05, size=40)) + 1.0
        a, b = ScoreKeeper(k, metric, tol), RefScoreKeeper(k, metric, tol)
        assert a.more == b.more == (metric == "auc")
        for v in seq:
            assert a.record(v) == b.record(v)


def test_score_keeper_cases():
    sk = ScoreKeeper(2, "logloss", 0.01)
    # needs 2k events; then stops when the last k average no better than
    # the best before them by more than tol·|best|
    assert [sk.record(v) for v in (0.6, 0.5, 0.45, 0.44)] == [False] * 4
    assert sk.record(0.5)                # avg(0.44, 0.5) ≥ 0.45·0.99
    assert not ScoreKeeper(0, "logloss", 0.0).record(1.0)
    up = ScoreKeeper(1, "AUC", 0.0)
    assert [up.record(v) for v in (0.7, 0.8, 0.8)] == [False, False, True]


@pytest.mark.parametrize("args,want", [
    ((50, 5, True), list(range(5, 51, 5))),        # AutoML: interval 5
    ((12, 5, True), [5, 10]),                      # a partial last chunk
    ((25, 0, True), [10, 20, 25]),                 # a stopper alone: 10s
    ((4, 0, True), [4]),                           # min(10, ntrees)
    ((7, 3, False), [3, 6]),                       # interval, no stopper
    ((7, 0, False, True), list(range(1, 8))),      # score_each_iteration
    ((30, 0, False), []),                          # no event at all
])
def test_score_events(args, want):
    assert score_events(*args) == want


@pytest.mark.parametrize("case", list(CASES))
def test_stops_at_the_reference_iteration(fits, case):
    ref, port = fits[case]
    want = CASES[case][3]
    assert port.model.ntrees_built == ref.model.ntrees_built == want
    assert want < CASES[case][2]["ntrees"]            # the stop fired
    rf, pf = ref.model.forest[0], port.model.forest[0]
    for f in ("feat", "bin", "is_split"):
        assert np.array_equal(getattr(pf, f).numpy(), np.asarray(getattr(rf, f))), f
    np.testing.assert_allclose(pf.value.numpy(), np.asarray(rf.value),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_scoring_history_matches(fits, case):
    ref, port = fits[case]
    rh, ph = ref.model.scoring_history, port.model.scoring_history
    assert isinstance(ph, ScoringHistory) and port.scoring_history is ph
    assert ([r["number_of_trees"] for r in ph]
            == [r["number_of_trees"] for r in rh])
    for a, b in zip(ph, rh):
        assert sorted(a) == sorted(b)
        for key, v in b.items():
            if key == "timestamp":
                continue
            if isinstance(v, float) and math.isnan(v):
                assert math.isnan(a[key]), key
            else:
                assert abs(a[key] - v) <= TOL, (key, a[key], v)
    table = ph()
    assert table.nrow == len(ph)
    np.testing.assert_array_equal(table.vec("number_of_trees").numeric_np(),
                                  [r["number_of_trees"] for r in ph])


@pytest.mark.parametrize("case", list(CASES))
def test_stop_equals_score_keeper_replayed_on_the_history(fits, case):
    _, port = fits[case]
    params, use_valid = CASES[case][2], CASES[case][1]
    sk = ScoreKeeper(params["stopping_rounds"], "logloss",
                     params["stopping_tolerance"])
    key = "validation_logloss" if use_valid else "logloss"
    stops = [r["number_of_trees"] for r in port.model.scoring_history
             if sk.record(r[key])]
    assert stops[0] == port.model.ntrees_built


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if v[1]])
def test_validation_metrics_match(fits, case):
    ref, port = fits[case]
    rm, pm = ref.model.validation_metrics, port.model.validation_metrics
    assert pm is not None and port.model_performance(valid=True) is pm
    for name in ("auc", "logloss", "mse"):
        assert abs(getattr(pm, name) - getattr(rm, name)) <= TOL, name
    assert abs(port.auc(valid=True) - ref.auc(valid=True)) <= TOL


def test_weights_column_fit_matches(fits):
    ref, port = fits["gbm_weighted_valid"]
    assert "w" not in port.model.x and port.model.x == ref.model.x
    assert port.model.f0 == pytest.approx(ref.model.f0, abs=1e-7)
    unweighted = fits["gbm_valid_interval"][1].model.f0
    assert port.model.f0 != pytest.approx(unweighted, abs=1e-4)
    assert abs(port.auc() - ref.auc()) <= TOL
    assert abs(port.logloss() - ref.logloss()) <= TOL


def test_unported_parameters_still_raise():
    d = _data(100, 0)
    fr = Frame.from_numpy(d, names=NAMES).asfactor("label")
    # CV is ported: nfolds=1 raises the reference's check in its place
    for kw, error, match in (
            (dict(nfolds=1), ValueError, r"nfolds must be 0 \(no CV\) or >= 2"),
            (dict(checkpoint="m"), NotImplementedError,
             "queue A, item 5: checkpoints")):
        with pytest.raises(error, match=match):
            H2OGradientBoostingEstimator(device="cpu", **kw).train(
                y="label", training_frame=fr)
