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


def _rows_inputs(dev, seed, N, F, L, nbins, w_zero, law="uniform"):
    """Row-major codes, node ids and values of one B2 pass. The skewed law
    puts half the weighted rows in node L // 2 and leaves every fourth node
    empty, as the deep dense levels and the compaction passes do."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, nbins, (N, F)).astype(np.uint8)
    node = rng.integers(0, L, N)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    w = (rng.random(N) >= w_zero).astype(np.float32)
    if law == "skewed":
        node = np.where(node % 4 == 3, node - 1, node)
        node[(w > 0) & (rng.random(N) < 0.5)] = L // 2
    vals = np.stack([w, g * w, h * w])
    return (torch.from_numpy(codes).to(dev),
            torch.from_numpy(node.astype(np.int32)).to(dev),
            torch.from_numpy(vals).to(dev))


def _check_rows(got, codes, node, vals, L, nbins):
    ref = hist_cuda.hist_plain_rows(codes, node, vals, L, nbins)
    torch.cuda.synchronize()
    assert got.shape == (L, codes.shape[1], nbins, 3)
    # f32 sums in another order (atomics), so rtol 1e-5 of the largest entry
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * max(float(ref.abs().max()), 1.0))


@pytest.mark.parametrize("N,F,L,nbins,w_zero,law", [
    (200_003, 28, 1, 21, 0.3, "uniform"),     # the DRF root pass, ragged N
    (200_003, 28, 16, 21, 0.5, "uniform"),    # one node per group
    (200_003, 28, 64, 21, 0.5, "uniform"),
    (200_003, 28, 128, 21, 0.5, "uniform"),
    (200_003, 28, 2048, 21, 0.5, "uniform"),  # the last dense level before compaction
    (200_003, 28, 4097, 21, 0.5, "uniform"),  # the compaction passes
    (200_003, 28, 4097, 21, 0.5, "skewed"),   # ... with one node of 50k rows
    (200_003, 28, 8191, 21, 0.5, "uniform"),  # one node below a group boundary
    (200_003, 28, 8193, 21, 0.5, "uniform"),  # one above; global counters
    (200_003, 28, 2 ** 17, 21, 0.5, "skewed"),  # a dense rebuild's widest pass
    (200_003, 28, 2 ** 18, 21, 0.5, "uniform"),
    (50_001, 5, 1024, 256, 0.3, "uniform"),   # the widest uint8 code range
    (4_099, 3, 4, 256, 1.0, "uniform"),       # every row at zero weight
])
def test_rows_kernel_matches_plain(dev, N, F, L, nbins, w_zero, law):
    codes, node, vals = _rows_inputs(dev, N + L, N, F, L, nbins, w_zero, law)
    before = hist_cuda.launches_rows
    got = hist_cuda.hist_build_rows(codes, node, vals, L, nbins)
    assert hist_cuda.launches_rows == before + 1
    _check_rows(got, codes, node, vals, L, nbins)


@pytest.mark.parametrize("G,C", [(8, 1024), (1, 128), (8, 128)])
def test_rows_kernel_groups_of_several_chunks(dev, monkeypatch, G, C):
    """Small chunks make groups whose rows span several chunks (atomics
    into a zeroed slab), beside groups of one chunk and, at G = 1, empty
    groups (plain stores)."""
    N, F, L, nbins = 50_001, 7, 300, 21
    codes, node, vals = _rows_inputs(dev, 9, N, F, L, nbins, 0.5, "skewed")
    monkeypatch.setattr(hist_cuda, "GROUP_NODES", G)
    monkeypatch.setattr(hist_cuda, "CHUNK_ROWS", C)
    per_node = np.bincount(node.cpu().numpy()[vals[0].cpu().numpy() > 0],
                           minlength=L)
    chunks = -(-np.add.reduceat(per_node, np.arange(0, L, G)) // C)
    assert (chunks > 1).any()
    got = hist_cuda.hist_build_rows(codes, node, vals, L, nbins)
    _check_rows(got, codes, node, vals, L, nbins)


@pytest.mark.parametrize("L", [16, 10_000])
def test_rows_kernel_skips_foreign_node_ids(dev, L):
    """Node ids below 0 and at or above L add nothing (shared and global
    counters)."""
    N, F, nbins = 100_003, 6, 21
    codes, node, vals = _rows_inputs(dev, L, N, F, L, nbins, 0.3)
    rng = np.random.default_rng(L)
    foreign = torch.from_numpy(rng.random(N) < 0.2).to(dev)
    wild = torch.from_numpy(
        rng.choice([-3, -1, L, L + 1, 2 ** 30], N).astype(np.int32)).to(dev)
    node_w = torch.where(foreign, wild, node)
    got = hist_cuda.hist_build_rows(codes, node_w, vals, L, nbins)
    keep = ~foreign
    _check_rows(got, codes[keep].contiguous(), node[keep].contiguous(),
                vals[:, keep].contiguous(), L, nbins)


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
