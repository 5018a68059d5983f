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


def _inputs(dev, seed, N, F, L, nbins, law="uniform"):
    """Feature-major codes, node ids and values of one B1 pass. The skewed
    code law puts most rows in a few central bins, as the fit's
    UniformAdaptive bins of normal features do."""
    rng = np.random.default_rng(seed)
    if law == "skewed":
        codes = np.clip(rng.normal(nbins / 2, nbins / 8, (F, N)), 0,
                        nbins - 1).astype(np.uint8)
    else:
        codes = rng.integers(0, nbins, (F, N)).astype(np.uint8)
    node = rng.integers(0, L, N).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    w = (rng.random(N) > 0.3).astype(np.float32)
    vals = np.stack([w, g * w, h * w])
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(node).to(dev),
            torch.from_numpy(vals).to(dev))


def _check_fixed(got, codes, node, vals, L, nbins):
    """The kernel's output equals its fixed-point twin bit for bit, and a
    second launch gives the same bits."""
    again = hist_cuda.hist_build(codes, node, vals, L, nbins)
    fixed = hist_cuda.hist_plain_fixed(codes, node, vals, L, nbins)
    torch.cuda.synchronize()
    # every bit, NaNs in the same places
    for other in (again, fixed):
        torch.testing.assert_close(got, other, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("N,F,L,nbins,law", [
    (200_003, 28, 1, 21, "uniform"),      # the main path's root pass, ragged N
    (500_000, 7, 1, 21, "uniform"),       # odd F, 263 row blocks, odd entries
    (200_003, 28, 16, 21, "uniform"),     # its deepest pass at depth 6
    (200_003, 28, 16, 21, "skewed"),      # ... on codes crowded in a few bins
    (50_001, 5, 256, 21, "uniform"),      # one feature per block, fat row blocks
    (4_099, 3, 4, 256, "uniform"),        # the widest uint8 code range
    (100_003, 3, 1024, 21, "uniform"),    # depth-11 sibling pass: node slices
    (100_003, 3, 1024, 256, "uniform"),   # wide categorical bins: many slices
])
def test_kernel_matches_plain(dev, N, F, L, nbins, law):
    codes, node, vals = _inputs(dev, N + L, N, F, L, nbins, law)
    before = hist_cuda.launches
    got = hist_cuda.hist_build(codes, node, vals, L, nbins)
    assert hist_cuda.launches == before + 1
    ref = hist_cuda.hist_plain(codes, node, vals, L, nbins)
    torch.cuda.synchronize()
    assert got.shape == (L, F, nbins, 3)
    # fixed-point sums against f32 sums in another order
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    _check_fixed(got, codes, node, vals, L, nbins)


@pytest.mark.parametrize("knob,value", [
    ("TILE_ROWS", 256), ("TILE_ROWS", 512), ("THREADS", 256),
    ("THREADS", 1024), ("SMEM_PAIR", hist_cuda.SMEM_MAX),
    ("MIN_ROWS_PER_BLOCK", 4096)])
def test_kernel_bits_do_not_depend_on_the_plan(dev, monkeypatch, knob, value):
    """Integer sums: other tiles, threads, feature splits and row blocks
    give the same bits."""
    codes, node, vals = _inputs(dev, 8, 100_003, 28, 16, 21)
    base = hist_cuda.hist_build(codes, node, vals, 16, 21)
    monkeypatch.setattr(hist_cuda, knob, value)
    got = hist_cuda.hist_build(codes, node, vals, 16, 21)
    torch.cuda.synchronize()
    assert torch.equal(got, base)


def test_kernel_flushes_crowded_nodes(dev):
    """Fat row blocks (deep level) where one node takes half the rows: its
    slab is added into the int64 accumulator two or three times per
    block."""
    N, F, L, nbins = 1_000_003, 3, 1024, 21
    codes, node, vals = _inputs(dev, 2, N, F, L, nbins)
    node[torch.arange(N, device=dev) % 2 == 0] = 5
    plan = hist_cuda.block_plan(L, nbins, F, N)
    assert plan.rows_per_block > 4 * hist_cuda.R_MAX
    got = hist_cuda.hist_build(codes, node, vals, L, nbins)
    _check_fixed(got, codes, node, vals, L, nbins)


@pytest.mark.parametrize("case", ["at_maximum", "zeros", "nan_g", "inf_h",
                                  "tiny", "denormal"])
def test_kernel_scale_edges(dev, case):
    """Every row at the top of its binade in one bin (the int32 bounds, in
    slabs drained at the block's end and in slabs flushed every R_MAX rows),
    all-zero values, a NaN or an inf (that channel NaN), tiny and denormal
    maxima."""
    N, F = 3 * hist_cuda.R_MAX * 40, 2
    codes, node, vals = _inputs(dev, 3, N, F, 1, 21)
    if case == "at_maximum":
        codes.zero_()
        vals.fill_(1 - 2 ** -24)
        vals[2].neg_()
    elif case == "zeros":
        vals.zero_()
    elif case == "nan_g":
        vals[1, 17] = float("nan")
    elif case == "inf_h":
        vals[2, 5] = float("inf")
    else:
        vals[1:] *= 1e-30 if case == "tiny" else 1e-39
    for L in (1, 1024):      # blocks of 1872 rows; blocks of 11,184 in node 0
        nd = node if L == 1 else (node * 7) % L
        got = hist_cuda.hist_build(codes, nd, vals, L, 21)
        _check_fixed(got, codes, nd, vals, L, 21)
    if case == "at_maximum":
        m = 1 - 2 ** -24                      # the exact sum, rounded once
        assert torch.equal(got[:, 0, 0].sum(0).cpu(), torch.tensor(
            [N * m, N * m, -N * m], dtype=torch.float64).float())
    if case in ("nan_g", "inf_h"):
        c = 1 if case == "nan_g" else 2
        assert torch.isnan(got[..., c]).all()
        assert torch.isfinite(got[..., [k for k in range(3) if k != c]]).all()


@pytest.mark.parametrize("L,sibling,law", [
    (1, False, "uniform"), (4, True, "skewed"), (16, True, "uniform"),
    (1024, True, "uniform")])
def test_kernel_no_farther_from_f64_than_f32(dev, L, sibling, law):
    """In each channel (w, g·w, h·w) the kernel's sums lie no farther from
    an f64 sum of the same inputs than `hist_plain`'s f32 atomics do."""
    N, F = 1_000_000, 4
    codes, node, vals = _inputs(dev, 20 + L, N, F, L, 21, law)
    if sibling:
        vals[:, torch.arange(N, device=dev) % 2 == 1] = 0
    got = hist_cuda.hist_build(codes, node, vals, L, 21)
    f32 = hist_cuda.hist_plain(codes, node, vals, L, 21)
    f64 = hist_cuda.hist_plain(codes, node, vals, L, 21, torch.float64)
    err = (got.double() - f64).abs().reshape(-1, 3).amax(0)
    err_f32 = (f32.double() - f64).abs().reshape(-1, 3).amax(0)
    assert (err <= err_f32).all(), (err, err_f32)


def test_kernel_past_2_26_rows(dev):
    """Past 2^26 rows the scale rule gives one bit less per doubling (no
    int64 sum passes 2^62); the kernel follows it, bit for bit."""
    N = 2 ** 26 + 5
    assert hist_cuda.fix_top(N) == hist_cuda.FIX_TOP - 1
    gen = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randint(0, 21, (1, N), generator=gen, device=dev,
                          dtype=torch.uint8)
    node = torch.randint(0, 2, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.randn((3, N), generator=gen, device=dev)
    got = hist_cuda.hist_build(codes, node, vals, 2, 21)
    _check_fixed(got, codes, node, vals, 2, 21)


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
