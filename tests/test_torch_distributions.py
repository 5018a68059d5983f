"""Every boosting distribution of the reference's `FAMILIES`: the port's
`init_margin`, `grad_hess`, `multinomial_grad_hess` and `link_inv` against
`h2o3_tpu/models/distributions.py` on seeded margins and responses (f32,
within a few ulps: the two libraries' `exp` may differ in the last bit),
then a 5-tree GBM per regression family through both packages (one-device
cloud for the JAX package, the CPU for the port), whose predictions agree
within 1e-5 and whose forests have the same structure.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import distributions as ref_dist
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import distributions as dist

REGRESSION = ("gaussian", "poisson", "gamma", "tweedie", "laplace",
              "quantile", "huber")
# the parameters that reach grad_hess, away from their defaults
KW = dict(tweedie_power=1.3, alpha=0.8, huber_delta=0.7)
N, F = 1500, 6
NAMES = [f"f{i}" for i in range(F)] + ["y"]


def _margins_and_y(dist_name, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.normal(scale=1.5, size=n).astype(np.float32)
    if dist_name == "bernoulli":
        y = (rng.random(n) < 0.4).astype(np.float32)
    elif dist_name in ("poisson", "gamma", "tweedie"):
        y = rng.poisson(2.0, n).astype(np.float32) + (
            0.5 if dist_name == "gamma" else 0.0)
    else:
        y = rng.normal(scale=2.0, size=n).astype(np.float32)
    return m, y


def test_families_are_the_reference_families():
    assert dist.FAMILIES == ref_dist.FAMILIES
    for problem in ("binomial", "multinomial", "regression"):
        for req in ("AUTO", "poisson"):
            assert (dist.infer_distribution(problem, req)
                    == ref_dist.infer_distribution(problem, req))
    for d in dist.FAMILIES:
        assert dist.deviance_name(d) == ref_dist.deviance_name(d)


@pytest.mark.parametrize("d", [f for f in dist.FAMILIES if f != "multinomial"])
def test_init_margin_matches(d):
    _, y = _margins_and_y(d)
    w = np.random.default_rng(1).choice([0.5, 1.0, 2.0], y.size).astype(np.float32)
    for alpha in (0.5, 0.8):
        assert (dist.init_margin(d, y, w, alpha=alpha)
                == ref_dist.init_margin(d, y, w, alpha=alpha))


@pytest.mark.parametrize("d", [f for f in dist.FAMILIES if f != "multinomial"])
@pytest.mark.parametrize("kw", [{}, KW], ids=["defaults", "params"])
def test_grad_hess_and_link_match(d, kw):
    m, y = _margins_and_y(d)
    g, h = dist.grad_hess(d, torch.from_numpy(m), torch.from_numpy(y), **kw)
    rg, rh = ref_dist.grad_hess(d, jnp.asarray(m), jnp.asarray(y), **kw)
    assert g.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dist.link_inv(d, torch.from_numpy(m)).numpy(),
                               np.asarray(ref_dist.link_inv(d, jnp.asarray(m))),
                               rtol=1e-6, atol=1e-7)


def test_multinomial_grad_hess_matches():
    rng = np.random.default_rng(3)
    m = rng.normal(scale=2.0, size=(3000, 5)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 3000)]
    g, h = dist.multinomial_grad_hess(torch.from_numpy(m), torch.from_numpy(y))
    rg, rh = ref_dist.multinomial_grad_hess(jnp.asarray(m), jnp.asarray(y))
    # two f32 ulps at 1.0: p − 1 inherits p's last-bit difference
    ulp2 = 2 * np.finfo(np.float32).eps
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-6, atol=ulp2)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-6, atol=ulp2)
    np.testing.assert_allclose(dist.softmax(torch.from_numpy(m)).numpy(),
                               np.asarray(jax.nn.softmax(jnp.asarray(m), axis=1)),
                               rtol=1e-6, atol=ulp2)


def test_unknown_distribution_raises():
    with pytest.raises(ValueError, match="unknown distribution"):
        dist.grad_hess("cauchy", torch.zeros(3), torch.zeros(3))


def _regression_frame(d, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    mu = np.exp(0.6 * X[:, 0] - 0.4 * X[:, 1] + 0.3 * np.sin(2 * X[:, 2]))
    if d == "poisson":
        y = rng.poisson(mu)
    elif d in ("gamma", "tweedie"):
        y = rng.gamma(2.0, mu / 2.0)
    else:
        y = 3 * X[:, 0] + np.sin(2 * X[:, 1]) + rng.standard_t(3, n)
    return np.column_stack([X, y.astype(np.float32)])


@pytest.fixture(scope="module")
def fits():
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for d in REGRESSION:
            train, test = _regression_frame(d, N, 0), _regression_frame(d, 500, 1)
            params = dict(ntrees=5, max_depth=3, seed=42, distribution=d,
                          tweedie_power=1.3, quantile_alpha=0.8)
            ref = RefGBM(**params)
            ref.train(y="y", training_frame=RefFrame.from_numpy(train, names=NAMES))
            port = H2OGradientBoostingEstimator(device="cpu", **params)
            port.train(y="y", training_frame=Frame.from_numpy(train, names=NAMES))
            out[d] = dict(
                ref=ref.model, port=port.model,
                ref_pred=ref.predict(RefFrame.from_numpy(test, names=NAMES)),
                port_pred=port.predict(Frame.from_numpy(test, names=NAMES)))
    finally:
        mesh.reset()
    return out


@pytest.mark.parametrize("d", REGRESSION)
def test_family_fit_matches(fits, d):
    ref, port = fits[d]["ref"], fits[d]["port"]
    assert port.distribution == ref.distribution == d
    assert port.f0 == pytest.approx(ref.f0, abs=1e-6)
    rf, pf = ref.forest[0], port.forest[0]
    for f in ("feat", "bin", "is_split"):
        assert np.array_equal(getattr(pf, f).numpy(), np.asarray(getattr(rf, f))), f
    np.testing.assert_allclose(pf.value.numpy(), np.asarray(rf.value),
                               rtol=1e-5, atol=1e-5)
    got = np.asarray(fits[d]["port_pred"].vec("predict").data)
    want = np.asarray(fits[d]["ref_pred"].vec("predict").data)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if d in ("poisson", "gamma", "tweedie"):
        assert (got > 0).all()                 # the log link's inverse
    assert abs(port.training_metrics.rmse - ref.training_metrics.rmse) <= 1e-5
