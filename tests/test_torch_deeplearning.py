"""DeepLearning of the port against the reference's, on the CPU.

The same numpy-seeded frames go through the JAX package on a one-device
cloud and through the port with `device="cpu"`:

- the initial weights (`_init_params`) equal the reference's bit for bit;
- after one chunk (one epoch: one permutation of the rows, walked in
  batches), the parameters of each activation and optimizer agree within
  CHUNK_TOL = 1e-6 (measured ≤ 1.8e-7): Rectifier, Tanh with momentum SGD
  and l1/l2, Maxout and RectifierWithDropout with input dropout,
  ADADELTA with max_w2 and l1, a multinomial, a gaussian and a weighted
  poisson regression, and the autoencoder. The permutations and dropout
  masks are jax's bit for bit (`tests/test_torch_prng.py`), so what is
  left is f32 summation order;
- full fits of the reference's own single-device cases
  (`tests/test_deeplearning.py`: binomial, regression, Tanh multinomial,
  dropout and Maxout, momentum SGD, the autoencoder) meet the reference's
  accuracy targets, and their predictions agree with the reference's:
  probabilities and reconstructions within FIT_TOL = 1e-5 (measured ≤
  1.5e-6). The regression case is the exception: a ReLU pre-activation of
  3.2e-8 at epoch 18 (of 40) falls on the other side of zero in one
  package, and from there the two trajectories part (parameters 1.5e-7
  apart through epoch 17, 2.5e-3 at the end): its predictions agree
  within REG_TOL = 2e-2 (the response's standard deviation is 2.26;
  measured 1.2e-2) and its training MSE within 1e-3 relative;
- the reference's `ValueError`s with its messages, and the port's
  `NotImplementedError`s where the reference accepts a parameter and
  ignores it;
- `convert.dl_from_numpy` of a reference model scores as the reference;
  the MOJO loads across both ways; a served batch equals `predict`;
- 3-fold CV's holdout predictions equal the reference's within FIT_TOL.

The scoring history's length depends on the wall clock under the default
`train_samples_per_iteration=-2` (the duty-cycle skip), in both packages,
so histories are compared only where early stopping keeps every event.
"""

import numpy as np
import pytest
import torch

import jax

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import deeplearning as refdl
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import deeplearning as dl
from h2o3_tpu_torch.serving import ScoringEngine
from h2o3_tpu_torch.serving.config import ServingConfig

from conftest import make_classification, make_regression
from test_torch_mojo import _members

CHUNK_TOL = 1e-6
FIT_TOL = 1e-5
REG_TOL = 2e-2


def _classification(n, f, seed):
    X, y = make_classification(n, f, seed=seed)
    return np.column_stack([X, y]), [f"x{i}" for i in range(f)] + ["y"], "y"


def _regression(n, f, seed):
    X, y = make_regression(n, f, seed=seed, noise=0.05)
    return np.column_stack([X, y]), [f"x{i}" for i in range(f)] + ["y"], None


def _angles():
    """The reference test's 3-class frame: the class is the sector of the
    angle of (a, b)."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(2000, 4)).astype(np.float32)
    y = (np.arctan2(X[:, 0], X[:, 1]) // (2 * np.pi / 3) + 1).astype(int) % 3
    return np.column_stack([X, y]), ["a", "b", "c", "d", "y"], "y"


def _planted():
    """The reference test's autoencoder frame: five planted outliers."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 6)).astype(np.float32)
    X[:5] += 8.0
    return X, [f"c{i}" for i in range(6)], "x"


def _weighted_counts():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(900, 5))
    y = rng.poisson(np.exp(0.4 * X[:, 0] - 0.3 * X[:, 1]))
    w = rng.uniform(0.5, 2.0, 900)
    return (np.column_stack([X, y, w]),
            [f"x{i}" for i in range(5)] + ["y", "w"], None)


def _frames(data):
    """(reference frame, port frame, train kwargs) of a fixture: `kind`
    "y" for a categorical response, None for a numeric one, "x" for the
    autoencoder (no response)."""
    arr, names, kind = data
    rf, pf = RefFrame.from_numpy(arr, names=names), Frame.from_numpy(
        arr, names=names)
    if kind == "y":
        rf, pf = rf.asfactor("y"), pf.asfactor("y")
    kw = dict(x=names) if kind == "x" else dict(y="y")
    return rf, pf, kw


def _fit_both(data, params):
    rf, pf, kw = _frames(data)
    ref = refdl.H2ODeepLearningEstimator(**params)
    ref.train(training_frame=rf, **kw)
    port = dl.H2ODeepLearningEstimator(device="cpu", **params)
    port.train(training_frame=pf, **kw)
    return ref, port, rf, pf


def _param_diff(ref_model, port_model):
    return max(float(np.abs(np.asarray(t) - u.numpy()).max())
               for (W, b), (V, c) in zip(ref_model.net_params,
                                         port_model.net_params)
               for t, u in ((W, V), (b, c)))


def _cols(fr):
    return {n: np.asarray(fr.vec(n).data, np.float64) for n in fr.names
            if fr.vec(n).type != "enum"}


def _pred_diff(ref_fr, port_fr):
    assert ref_fr.names == port_fr.names
    a, b = _cols(ref_fr), _cols(port_fr)
    return max(float(np.abs(a[c] - b[c]).max()) for c in a)


def test_init_params_are_the_references(cloud1):
    for sizes, act in (([8, 32, 32, 2], "Rectifier"), ([6, 32, 2], "Maxout"),
                       ([717, 200, 200, 10], "Tanh"), ([6, 3, 6], "Tanh")):
        key = jax.random.fold_in(jax.random.PRNGKey(1234), len(sizes))
        want = refdl._init_params(key, sizes, act)
        got = dl._init_params(tuple(int(v) for v in np.asarray(key)), sizes,
                              act, "cpu")
        assert len(got) == len(want)
        for (W, b), (V, c) in zip(want, got):
            assert V.dtype == torch.float32 and V.shape == W.shape
            assert np.array_equal(np.asarray(W).view(np.uint32),
                                  V.numpy().view(np.uint32))
            assert not c.any() and c.shape == b.shape


CHUNK_CASES = [
    (_classification(2000, 8, 0), dict(hidden=[32, 32], seed=1)),
    (_classification(1200, 6, 6),
     dict(hidden=[32], activation="Tanh", seed=7, adaptive_rate=False,
          rate=0.01, momentum_start=0.5, momentum_stable=0.9, l1=1e-4,
          l2=1e-4)),
    (_classification(1200, 6, 4),
     dict(hidden=[32], activation="Maxout", seed=5,
          input_dropout_ratio=0.1)),
    (_classification(1200, 6, 4),
     dict(hidden=[32, 16], activation="RectifierWithDropout", seed=5,
          input_dropout_ratio=0.2, hidden_dropout_ratios=[0.3, 0.1])),
    (_classification(1200, 6, 4),
     dict(hidden=[32], seed=7, max_w2=2.0, l1=1e-3, mini_batch_size=64)),
    (_angles(), dict(hidden=[32], activation="TanhWithDropout", seed=3)),
    (_regression(1500, 6, 1), dict(hidden=[32, 32], seed=2)),
    (_weighted_counts(), dict(hidden=[16], distribution="poisson",
                              weights_column="w", seed=4)),
    (_planted(), dict(autoencoder=True, hidden=[3], seed=1,
                      mini_batch_size=64)),
]


def test_one_chunk_matches_the_reference(cloud1):
    """One epoch under each activation, optimizer and problem."""
    for data, params in CHUNK_CASES:
        params = dict(dict(epochs=1, mini_batch_size=128), **params)
        ref, port, _, _ = _fit_both(data, params)
        assert _param_diff(ref.model, port.model) <= CHUNK_TOL, params
        assert port.model.iterations == -(-data[0].shape[0]
                                          // params["mini_batch_size"])


# the reference's single-device cases (tests/test_deeplearning.py) and
# their accuracy targets
FULL_CASES = {
    "binomial": (_classification(2000, 8, 0),
                 [dict(hidden=[32, 32], epochs=30, seed=1,
                       mini_batch_size=128)]),
    "regression": (_regression(1500, 6, 1),
                   [dict(hidden=[64, 64], epochs=40, seed=2,
                         mini_batch_size=128)]),
    "multinomial_tanh": (_angles(),
                         [dict(hidden=[32], activation="Tanh", epochs=30,
                               seed=3, mini_batch_size=128)]),
    "dropout_and_maxout": (_classification(1200, 6, 4), [
        dict(hidden=[32], activation=act, epochs=15, seed=5,
             mini_batch_size=128, input_dropout_ratio=0.1)
        for act in ("RectifierWithDropout", "Maxout")]),
    "momentum_sgd": (_classification(1200, 6, 6),
                     [dict(hidden=[32], epochs=25, seed=7,
                           adaptive_rate=False, rate=0.01,
                           momentum_start=0.5, momentum_stable=0.9,
                           mini_batch_size=128)]),
    "autoencoder": (_planted(),
                    [dict(autoencoder=True, hidden=[3], epochs=30,
                          mini_batch_size=64, seed=1)]),
}


@pytest.fixture(scope="module")
def full_fits():
    """Fits made once by the first test that asks, on its one-device
    cloud (`cloud1`)."""
    return {}


def _full(full_fits, case):
    if case not in full_fits:
        data, plist = FULL_CASES[case]
        full_fits[case] = [(data,) + _fit_both(data, params)
                           for params in plist]
    return full_fits[case]


def _target(case, est, data):
    if case in ("binomial",):
        return est.auc() > 0.85
    if case == "regression":
        return est.model.mse() < 0.5 * float(np.var(data[0][:, -1]))
    if case == "multinomial_tanh":
        return est.model.training_metrics.accuracy > 0.8
    if case == "dropout_and_maxout":
        return est.auc() > 0.7
    if case == "momentum_sgd":
        return est.auc() > 0.8
    return est.model.training_metrics.mse < 1.5


@pytest.mark.parametrize("case", list(FULL_CASES))
def test_full_fit_matches_the_reference(cloud1, full_fits, case):
    for data, ref, port, rf, pf in _full(full_fits, case):
        assert _target(case, ref, data) and _target(case, port, data)
        got, want = port.predict(pf), ref.predict(rf)
        tol = REG_TOL if case == "regression" else FIT_TOL
        assert _pred_diff(want, got) <= tol
        mp, mr = port.model.training_metrics, ref.model.training_metrics
        rel = 1e-3 if case == "regression" else 1e-5
        assert abs(float(mp.mse) - float(mr.mse)) <= rel * float(mr.mse)
        hist = port.model.scoring_history
        assert hist and hist[-1]["iterations"] == port.model.iterations
        if case == "autoencoder":
            assert got.ncol == 6 and got.names[0] == "reconstr_c0"
            a = port.model.anomaly(pf).vec("Reconstruction.MSE").numeric_np()
            b = ref.model.anomaly(rf).vec("Reconstruction.MSE").numeric_np()
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
            assert len(set(np.argsort(-a)[:8]) & set(range(5))) >= 4
        elif case != "regression":
            assert got.vec("predict").type == "enum"
            assert got.names == ["predict"] + [str(c)
                                               for c in port.model.domain]


REF_VALUE_ERRORS = [dict(hidden=[]), dict(hidden=[0]), dict(hidden=[2.5]),
                    dict(epochs=0), dict(mini_batch_size=0),
                    dict(input_dropout_ratio=1.0), dict(rho=1.5),
                    dict(epsilon=0.0), dict(activation="Relu")]
UNREAD = [dict(rate_decay=0.5), dict(nesterov_accelerated_gradient=False),
          dict(initial_weight_distribution="Normal"),
          dict(initial_weight_scale=0.5), dict(loss="Quadratic"),
          dict(score_interval=1.0), dict(score_training_samples=0),
          dict(score_validation_samples=100),
          dict(overwrite_with_best_model=False),
          dict(shuffle_training_data=True), dict(reproducible=True),
          dict(variable_importances=False),
          dict(export_weights_and_biases=True), dict(elastic_averaging=True),
          dict(stopping_metric="AUC", stopping_rounds=2),
          dict(distribution="gamma"), dict(distribution="tweedie"),
          dict(adaptive_rate=False, max_w2=10.0)]


def test_parameter_errors(cloud1):
    data = _classification(300, 4, 2)
    rf, pf, kw = _frames(data)
    for bad in REF_VALUE_ERRORS:
        params = dict(dict(hidden=[4], epochs=1), **bad)
        with pytest.raises(ValueError) as want:
            refdl.H2ODeepLearningEstimator(**params).train(training_frame=rf,
                                                           **kw)
        with pytest.raises(ValueError) as got:
            dl.H2ODeepLearningEstimator(device="cpu", **params).train(
                training_frame=pf, **kw)
        assert str(got.value) == str(want.value)
    for bad in UNREAD:
        est = dl.H2ODeepLearningEstimator(device="cpu", hidden=[4], epochs=1,
                                          **bad)
        name = next(iter(bad)) if "max_w2" not in bad else "max_w2"
        with pytest.raises(NotImplementedError,
                           match=f"{name}.*queue A, item 10: DeepLearning"):
            est.train(training_frame=pf, **kw)
    arr = np.column_stack([data[0], np.arange(300) % 3])
    names = data[1] + ["off"]
    with pytest.raises(NotImplementedError, match="offset_column"):
        dl.H2ODeepLearningEstimator(device="cpu", offset_column="off").train(
            y="y", training_frame=Frame.from_numpy(arr, names=names))
    with pytest.raises(ValueError, match="response column y is required"):
        dl.H2ODeepLearningEstimator(device="cpu").train(training_frame=pf)


def test_carried_model_mojo_and_serving(cloud1, full_fits, tmp_path):
    """`dl_from_numpy` of the reference's binomial and autoencoder models;
    both packages' MOJOs member by member and loaded across; a served
    batch."""
    for case in ("binomial", "autoencoder"):
        data, ref, port, rf, pf = _full(full_fits, case)[0]
        rm, pm = ref.model, port.model
        di = rm.dinfo
        carried = convert.dl_from_numpy(
            net_params=[(np.asarray(W), np.asarray(b))
                        for W, b in rm.net_params],
            activation=rm.activation, problem=rm.problem, x=rm.x, y=rm.y,
            spec=di._spec, coef_names=di.coef_names, nclass=rm.nclass,
            domain=rm.domain, distribution=rm.distribution, means=di.means,
            stds=di.stds, col_means=di.col_means,
            transfer_groups=getattr(di, "_transfer_groups", None),
            standardize=di.standardize, use_all=di.use_all, device="cpu")
        assert _pred_diff(rm.predict(rf), carried.predict(pf)) <= 1e-6
        pp = mojo.save_model(pm, str(tmp_path), f"port_{case}.h2o3")
        rp = refmojo.save_model(rm, str(tmp_path), f"ref_{case}.h2o3")
        pn, pmeta, parr = _members(pp)
        rn, rmeta, rarr = _members(rp)
        assert pn == rn and sorted(parr) == sorted(rarr)
        assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
            k: v for k, v in rmeta.items() if k != "model_id"}
        for name in rarr:
            assert parr[name].dtype == rarr[name].dtype, name
        own = mojo.load_model(pp).predict(pf)
        assert _pred_diff(pm.predict(pf), own) <= 1e-5
        if case == "binomial":
            # each package's artifact scored by the other
            assert _pred_diff(pm.predict(pf),
                              refmojo.load_model(pp).predict(rf)) <= 1e-5
            assert _pred_diff(rm.predict(rf),
                              mojo.load_model(rp).predict(pf)) <= 1e-5
    data, ref, port, rf, pf = _full(full_fits, "binomial")[0]
    eng = ScoringEngine(ServingConfig())
    try:
        sub = pf.take(np.arange(37, 290))
        assert _pred_diff(port.model.predict(sub),
                          eng.score("dl", port.model, sub)) <= 1e-6
        assert eng.snapshot()["totals"]["fallback_scores"] == 0
    finally:
        eng.shutdown()


def test_cv_holdouts_match_the_reference(cloud1):
    data = _classification(600, 6, 9)
    params = dict(hidden=[16], epochs=10, seed=3, mini_batch_size=64,
                  nfolds=3, keep_cross_validation_predictions=True)
    ref, port, _, _ = _fit_both(data, params)
    got, want = port.model._cv_holdout_pred, ref.model._cv_holdout_pred
    assert got.shape == want.shape == (600,)
    np.testing.assert_allclose(got, want, rtol=0, atol=FIT_TOL)
    assert abs(port.auc(xval=True) - ref.auc(xval=True)) <= 1e-4
    assert len(port.model.cross_validation_models) == 3
