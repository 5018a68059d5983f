"""The port's quantiles op (`h2o3_tpu_torch/ops/quantiles.py`) against the
reference's `distributed_quantiles` on a one-device cloud, on the CPU.

- Unit weights: every count is an exact integer, so the quantiles are
  bit-equal, on normal, lognormal and heavily tied columns, with NaNs,
  and on thirty columns at scales where `lo + k·span` must be rounded
  once, as XLA's fused multiply-add rounds it (`fma_f32`).
- A weighted column with NaNs and zero weights: within one last-refinement
  bin (range / nbins^iters) plus the f32 spacing of the value, since the
  weighted f32 sums add in another order than XLA's.
- A constant column (span 0, the reference's `1e-300` rounding to f32 0):
  the constant, `[3, 3, 3]`, in both packages.
- The reference's own cases (`tests/test_quantiles.py:17-31`): numpy's
  quantiles within 2e-3, and the NaN and zero-weight masking.
- A process group raises, naming its ROADMAP item.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops.quantiles import distributed_quantiles as ref_quantiles
from h2o3_tpu_torch.ops.quantiles import distributed_quantiles, fma_f32

from test_torch_deeplearning import one_torch_thread  # noqa: F401

PROBS = (0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0)


def _both(x, w, probs=PROBS, **kw):
    ref = np.asarray(ref_quantiles(jnp.asarray(x), jnp.asarray(w), probs, **kw))
    got = distributed_quantiles(torch.from_numpy(x), torch.from_numpy(w),
                                probs, **kw).numpy()
    return got, ref


def _columns():
    rng = np.random.default_rng(0)
    normal = rng.normal(size=20_000).astype(np.float32)
    logn = rng.lognormal(size=20_000).astype(np.float32)
    tied = rng.integers(0, 7, 20_000).astype(np.float32)
    nan = normal.copy()
    nan[rng.random(20_000) < 0.1] = np.nan
    return dict(normal=normal, lognormal=logn, tied=tied, nan=nan)


@pytest.mark.parametrize("name", ["normal", "lognormal", "tied", "nan"])
def test_unit_weights_bit_equal(cloud1, name):
    x = _columns()[name]
    got, ref = _both(x, np.ones_like(x))
    np.testing.assert_array_equal(got, ref)
    # and at another bin count and depth
    got, ref = _both(x, np.ones_like(x), probs=(0.3, 0.7), nbins=64, iters=2)
    np.testing.assert_array_equal(got, ref)


def test_scaled_columns_bit_equal(cloud1):
    """Thirty lognormal columns at scales 0.1 to 1e4: with `lo + k·span`
    rounded twice (a product, then a sum) four of these quantiles part
    from the reference's; rounded once, as XLA's fused multiply-add, none
    does."""
    rng = np.random.default_rng(0)
    for _ in range(30):
        x = (rng.lognormal(size=5000) * rng.uniform(0.1, 1e4)).astype(np.float32)
        probs = tuple(np.round(rng.random(5), 3))
        got, ref = _both(x, np.ones_like(x), probs=probs)
        np.testing.assert_array_equal(got, ref)


def test_weighted_within_one_bin(cloud1):
    rng = np.random.default_rng(1)
    x = rng.normal(size=30_000).astype(np.float32)
    x[rng.random(30_000) < 0.05] = np.nan
    w = rng.uniform(0.1, 3.0, 30_000).astype(np.float32)
    w[rng.random(30_000) < 0.05] = 0.0
    got, ref = _both(x, w)
    ok = ~np.isnan(x) & (w > 0)
    step = (x[ok].max() - x[ok].min()) / 1024.0 ** 3
    tol = step + np.spacing(np.abs(ref).astype(np.float32))
    assert np.all(np.abs(got - ref) <= tol), (got, ref)


def test_constant_column(cloud1):
    x = np.full(50, 3.0, np.float32)
    got, ref = _both(x, np.ones_like(x), probs=(0.1, 0.5, 0.9))
    np.testing.assert_array_equal(ref, [3.0, 3.0, 3.0])
    np.testing.assert_array_equal(got, ref)
    # a constant among NaNs and masked rows, weighted
    x = np.asarray([np.nan, 3.0, 3.0, 7.0, 3.0], np.float32)
    w = np.asarray([1.0, 2.0, 0.5, 0.0, 1.0], np.float32)
    got, ref = _both(x, w, probs=(0.2, 0.8))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [3.0, 3.0])


def test_reference_cases(cloud1):
    rng = np.random.default_rng(0)
    x = rng.normal(size=100_000).astype(np.float32)
    probs = (0.01, 0.25, 0.5, 0.75, 0.99)
    got, ref = _both(x, np.ones_like(x), probs=probs)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, np.quantile(x, probs), atol=2e-3)
    x = np.asarray([1.0, 2.0, 3.0, np.nan, 100.0], np.float32)
    w = np.asarray([1.0, 1.0, 1.0, 1.0, 0.0], np.float32)   # mask the 100
    got, ref = _both(x, w, probs=(0.5,))
    np.testing.assert_array_equal(got, ref)
    assert abs(got[0] - 2.0) < 0.01


def test_fma_and_process_group():
    # a + b·c rounded once: 1 + (1 + 2^-23)(1 − 2^-23) = 2 − 2^-46 → 2.0
    # by one rounding, and exact cases stay exact
    a = torch.tensor([1.0, 0.5, -3.0], dtype=torch.float32)
    b = torch.tensor([1 + 2 ** -23, 3.0, 2.0], dtype=torch.float32)
    c = torch.tensor([1 - 2 ** -23, 0.25, 1.5], dtype=torch.float32)
    want = (a.double() + b.double() * c.double()).float()
    assert torch.equal(fma_f32(a, b, c), want)
    with pytest.raises(NotImplementedError, match="item 9"):
        distributed_quantiles(torch.ones(4), torch.ones(4), (0.5,),
                              process_group=object())
