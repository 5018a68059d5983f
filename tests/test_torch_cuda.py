"""The port's CUDA histogram kernels on the card, against their plain
versions, and the GBM and DRF fits that launch them.

Every case needs an NVIDIA GPU and `nvcc` and skips without a card. The
file imports no `jax`, so on a GPU machine without the JAX package it runs
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.tree import histogram_level_plan
from h2o3_tpu_torch.ops import hist_cuda, histogram

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(dev, seed, N, F, L, nbins):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, nbins, (F, N)).astype(np.uint8)
    node = rng.integers(0, L, N).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    w = (rng.random(N) > 0.3).astype(np.float32)
    vals = np.stack([w, g * w, h * w])
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(node).to(dev),
            torch.from_numpy(vals).to(dev))


@pytest.mark.parametrize("N,F,L,nbins", [
    (200_003, 28, 1, 21),      # the main path's root pass, ragged row count
    (200_003, 28, 16, 21),     # its deepest pass at depth 6
    (50_001, 5, 256, 21),      # one feature per block, > 48 KB shared memory
    (4_099, 3, 4, 256),        # the widest uint8 code range
    (100_003, 3, 1024, 21),    # depth-11 sibling pass: two node slices
    (100_003, 3, 1024, 256),   # wide categorical bins: fourteen node slices
])
def test_kernel_matches_plain(dev, N, F, L, nbins):
    codes, node, vals = _inputs(dev, N + L, N, F, L, nbins)
    before = hist_cuda.launches
    got = hist_cuda.hist_build(codes, node, vals, L, nbins)
    assert hist_cuda.launches == before + 1
    ref = hist_cuda.hist_plain(codes, node, vals, L, nbins)
    torch.cuda.synchronize()
    assert got.shape == (L, F, nbins, 3)
    # f32 sums in another order (shared-memory atomics, then the fold)
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


def test_kernel_rejects_what_it_does_not_take(dev):
    codes, node, vals = _inputs(dev, 1, 1024, 4, 2, 21)
    with pytest.raises(TypeError):
        hist_cuda.hist_build(codes.to(torch.int32), node, vals, 2, 21)
    with pytest.raises(ValueError):
        hist_cuda.hist_build(codes[:, ::2], node[::2], vals[:, ::2], 2, 21)
    with pytest.raises(ValueError):
        hist_cuda.hist_build(codes, node[:-1], vals, 2, 21)


def test_gbm_fit_on_cuda_launches_the_kernel_at_every_level(dev):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(4000, 8)).astype(np.float32)
    y = (rng.random(4000) < 1 / (1 + np.exp(-(1.2 * X[:, 0] - X[:, 1])))
         ).astype(np.float32)
    names = [f"f{i}" for i in range(8)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    fits = {}
    for d in ("cuda", "cpu"):
        hist_cuda.launches = 0
        histogram.DISPATCH.clear()
        est = H2OGradientBoostingEstimator(ntrees=4, max_depth=4, seed=42,
                                           histogram_type="UniformAdaptive",
                                           device=d)
        est.train(y="label", training_frame=fr)
        fits[d] = (est, hist_cuda.launches, dict(histogram.DISPATCH))
    est, launches, dispatch = fits["cuda"]
    assert launches == 16 and dispatch == {"pallas_factored": 16}
    assert fits["cpu"][1] == 0 and fits["cpu"][2] == {"segment": 16}
    a, b = est.model.forest, fits["cpu"][0].model.forest
    for f in ("feat", "bin", "is_split"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    torch.testing.assert_close(a.value.cpu(), b.value, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,F,L,nbins,w_zero", [
    (200_003, 28, 1, 21, 0.3),      # the DRF root pass, ragged row count
    (200_003, 28, 16, 21, 0.5),     # several features per block
    (200_003, 28, 64, 21, 0.5),     # two features per block, > 48 KB
    (200_003, 28, 128, 21, 0.5),    # the narrowest global-atomics pass
    (200_003, 28, 2048, 21, 0.5),   # the last dense level before compaction
    (200_003, 28, 4097, 21, 0.5),   # the compaction passes
    (200_003, 28, 2 ** 18, 21, 0.5),  # a dense rebuild's deepest width
    (50_001, 5, 1024, 256, 0.3),    # the widest uint8 code range
    (4_099, 3, 4, 256, 1.0),        # every row at zero weight
])
def test_rows_kernel_matches_plain(dev, N, F, L, nbins, w_zero):
    rng = np.random.default_rng(N + L)
    codes = torch.from_numpy(
        rng.integers(0, nbins, (N, F)).astype(np.uint8)).to(dev)
    node = torch.from_numpy(rng.integers(0, L, N).astype(np.int32)).to(dev)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    w = (rng.random(N) >= w_zero).astype(np.float32)
    vals = torch.from_numpy(np.stack([w, g * w, h * w])).to(dev)
    before = hist_cuda.launches_rows
    got = hist_cuda.hist_build_rows(codes, node, vals, L, nbins)
    assert hist_cuda.launches_rows == before + 1
    ref = hist_cuda.hist_plain_rows(codes, node, vals, L, nbins)
    torch.cuda.synchronize()
    assert got.shape == (L, F, nbins, 3)
    # f32 sums in another order (atomics), so rtol 1e-5 of the largest entry
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * max(float(ref.abs().max()), 1.0))


def test_rows_kernel_rejects_what_it_does_not_take(dev):
    codes = torch.zeros((1024, 4), dtype=torch.uint8, device=dev)
    node = torch.zeros(1024, dtype=torch.int32, device=dev)
    vals = torch.ones((3, 1024), device=dev)
    with pytest.raises(TypeError):
        hist_cuda.hist_build_rows(codes.to(torch.int32), node, vals, 2, 21)
    with pytest.raises(ValueError):
        hist_cuda.hist_build_rows(codes[::2], node[::2], vals[:, ::2], 2, 21)
    with pytest.raises(ValueError):
        hist_cuda.hist_build_rows(codes, node[:-1], vals, 2, 21)


def test_drf_fit_on_cuda_matches_cpu(dev):
    """A depth-14 DRF (level 13 in compact slots) with "pallas": every pass
    launches B2, and binary labels keep every histogram sum exact, so the
    card's forest is the CPU's."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(4000, 8)).astype(np.float32)
    y = (rng.random(4000) < 1 / (1 + np.exp(-(1.2 * X[:, 0] - X[:, 1])))
         ).astype(np.float32)
    names = [f"f{i}" for i in range(8)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    fits = {}
    for d in ("cuda", "cpu"):
        hist_cuda.launches_rows = 0
        histogram.DISPATCH.clear()
        est = H2ORandomForestEstimator(ntrees=4, max_depth=14, seed=42,
                                       hist_method="pallas", device=d)
        est.train(y="label", training_frame=fr)
        fits[d] = (est, hist_cuda.launches_rows, dict(histogram.DISPATCH))
    est, launches, dispatch = fits["cuda"]
    passes = 4 * len(histogram_level_plan(14, 4096)) + est.model.dense_rebuilds * 14
    assert launches == passes and dispatch == {"pallas": passes}
    assert fits["cpu"][1] == 0
    a, b = est.model.forest, fits["cpu"][0].model.forest
    for f in ("feat", "bin", "is_split"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    torch.testing.assert_close(a.value.cpu(), b.value, rtol=1e-5, atol=1e-5)
    assert abs(est.auc() - fits["cpu"][0].auc()) <= 1e-5
