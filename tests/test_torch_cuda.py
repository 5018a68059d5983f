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
    """Feature-major codes, node ids and values of one B1 pass; the codes
    uint8 up to 256 bins, int16 past that (the fit's rule). The skewed code
    law puts most rows in a few central bins, as the fit's UniformAdaptive
    bins of normal features do."""
    rng = np.random.default_rng(seed)
    dt = np.uint8 if nbins <= 256 else np.int16
    if law == "skewed":
        codes = np.clip(rng.normal(nbins / 2, nbins / 8, (F, N)), 0,
                        nbins - 1).astype(dt)
    else:
        codes = rng.integers(0, nbins, (F, N)).astype(dt)
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
    # 16-bit codes
    (200_003, 8, 1, 301, "uniform"),      # the Airlines GBM's root pass
    (200_003, 8, 64, 301, "skewed"),      # node slices of 22
    (100_003, 8, 4096, 301, "uniform"),   # a compact level: 147 slices
    (50_001, 5, 1, 1024, "uniform"),      # the cap: 4 features a block
    (100_003, 3, 1024, 1024, "uniform"),  # slices of 8 nodes
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


@pytest.mark.parametrize("nbins", [21, 301])
@pytest.mark.parametrize("knob,value", [
    ("TILE_ROWS", 256), ("TILE_ROWS", 512), ("THREADS", 256),
    ("THREADS", 1024), ("SMEM_PAIR", hist_cuda.SMEM_MAX),
    ("MIN_ROWS_PER_BLOCK", 4096)])
def test_kernel_bits_do_not_depend_on_the_plan(dev, monkeypatch, knob, value,
                                               nbins):
    """Integer sums: other tiles, threads, feature splits and row blocks
    give the same bits, on 8- and 16-bit codes."""
    codes, node, vals = _inputs(dev, 8, 100_003, 28, 16, nbins)
    base = hist_cuda.hist_build(codes, node, vals, 16, nbins)
    monkeypatch.setattr(hist_cuda, knob, value)
    got = hist_cuda.hist_build(codes, node, vals, 16, nbins)
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


@pytest.mark.parametrize("L,sibling,law,nbins", [
    (1, False, "uniform", 21), (4, True, "skewed", 21),
    (16, True, "uniform", 21), (1024, True, "uniform", 21),
    (1, False, "skewed", 301), (4096, True, "uniform", 301),
    (64, True, "uniform", 1024)])
def test_kernel_no_farther_from_f64_than_f32(dev, L, sibling, law, nbins):
    """In each channel (w, g·w, h·w) the kernel's sums lie no farther from
    an f64 sum of the same inputs than `hist_plain`'s f32 atomics do."""
    N, F = 1_000_000, 4
    codes, node, vals = _inputs(dev, 20 + L, N, F, L, nbins, law)
    if sibling:
        vals[:, torch.arange(N, device=dev) % 2 == 1] = 0
    got = hist_cuda.hist_build(codes, node, vals, L, nbins)
    f32 = hist_cuda.hist_plain(codes, node, vals, L, nbins)
    f64 = hist_cuda.hist_plain(codes, node, vals, L, nbins, torch.float64)
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
    """int32 or float codes (TypeError); uint8 codes past 256 bins, int16
    codes past 1024 (ValueError); strided or mismatched inputs."""
    codes, node, vals = _inputs(dev, 1, 1024, 4, 2, 21)
    for dt in (torch.int32, torch.float32):
        with pytest.raises(TypeError):
            hist_cuda.hist_build(codes.to(dt), node, vals, 2, 21)
    with pytest.raises(ValueError):
        hist_cuda.hist_build(codes, node, vals, 2, 257)
    with pytest.raises(ValueError):
        hist_cuda.hist_build(codes.to(torch.int16), node, vals, 2, 1025)
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
    a, b = est.model.forest[0], fits["cpu"][0].model.forest[0]
    for f in ("feat", "bin", "is_split"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    torch.testing.assert_close(a.value.cpu(), b.value, rtol=1e-5, atol=1e-5)


def _rows_inputs(dev, seed, N, F, L, nbins, w_zero, law="uniform"):
    """Row-major codes (uint8 up to 256 bins, int16 past that), node ids
    and values of one B2 pass. The skewed law puts half the weighted rows
    in node L // 2 and leaves every fourth node empty, as the deep dense
    levels and the compaction passes do."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, nbins, (N, F)).astype(
        np.uint8 if nbins <= 256 else np.int16)
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
    # 16-bit codes
    (200_003, 8, 1, 301, 0.3, "uniform"),     # the Airlines DRF's root pass
    (200_003, 8, 4097, 301, 0.5, "skewed"),   # its compaction passes, G = 8
    (100_003, 8, 64, 1024, 0.5, "uniform"),   # the cap: G = 2
    (100_003, 28, 64, 1024, 0.5, "skewed"),   # G = 1, features split 18 + 10
    (50_001, 28, 1, 1024, 0.3, "uniform"),
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
    for dt in (torch.int32, torch.float32):
        with pytest.raises(TypeError):
            hist_cuda.hist_build_rows(codes.to(dt), node, vals, 2, 21)
    with pytest.raises(ValueError):
        hist_cuda.hist_build_rows(codes, node, vals, 2, 257)
    with pytest.raises(ValueError):
        hist_cuda.hist_build_rows(codes.to(torch.int16), node, vals, 2, 1025)
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
    a, b = est.model.forest[0], fits["cpu"][0].model.forest[0]
    for f in ("feat", "bin", "is_split"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    torch.testing.assert_close(a.value.cpu(), b.value, rtol=1e-5, atol=1e-5)
    assert abs(est.auc() - fits["cpu"][0].auc()) <= 1e-5


def _enum_frame(n, levels, seed):
    """A frame of a `levels`-level enum whose levels past 255 carry the
    signal, a numeric column and a binary label (the parity fixtures of
    tests/test_torch_codes16.py, without the JAX package)."""
    from h2o3_tpu_torch.frame.vec import Vec

    rng = np.random.default_rng(seed)
    cat = rng.integers(0, levels, n)
    x = rng.normal(size=n).astype(np.float32)
    logit = 1.5 * (cat >= 256) - 0.8 * (cat % 7 == 0) + x
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)
    return Frame({"cat": Vec(cat, "enum",
                             domain=[f"L{i:04d}" for i in range(levels)]),
                  "x": Vec(x), "y": Vec(y, "enum", domain=["N", "Y"])})


@pytest.mark.parametrize("algo,levels", [("gbm", 300), ("drf", 300),
                                         ("gbm", 1200)])
def test_16bit_fit_on_cuda_matches_cpu(dev, algo, levels):
    """GBM (B1) and DRF (B2) on a 300-level enum, and a GBM at the 1024-bin
    cap: every pass launches the kernel on int16 codes, and the card's
    forest is the CPU's."""
    fr = _enum_frame(4000, levels, levels)
    fits = {}
    for d in ("cuda", "cpu"):
        hist_cuda.launches = hist_cuda.launches_rows = 0
        histogram.DISPATCH.clear()
        if algo == "gbm":
            est = H2OGradientBoostingEstimator(ntrees=4, max_depth=4,
                                               min_rows=20, seed=42, device=d)
        else:
            est = H2ORandomForestEstimator(ntrees=4, max_depth=8, seed=42,
                                           hist_method="pallas", device=d)
        est.train(y="y", training_frame=fr)
        fits[d] = (est, hist_cuda.launches + hist_cuda.launches_rows,
                   dict(histogram.DISPATCH))
    est, launches, dispatch = fits["cuda"]
    assert est.model.bm.nbins == min(levels + 1, 1024)
    method = "pallas_factored" if algo == "gbm" else "pallas"
    passes = 4 * len(histogram_level_plan(est.model.max_depth))
    assert launches == passes and dispatch == {method: passes}
    assert fits["cpu"][1] == 0
    a, b = est.model.forest[0], fits["cpu"][0].model.forest[0]
    for f in ("feat", "bin", "is_split"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert int((a.is_split & (a.feat == 0) & (a.bin >= 255)).sum()) > 0
    torch.testing.assert_close(a.value.cpu(), b.value, rtol=1e-5, atol=1e-5)


def test_xgboost_on_cuda_is_repeatable_and_matches_cpu(dev, monkeypatch):
    """XGBoost on the card: two DART fits with the same seed give the same
    forest bit for bit (the leaf totals add in a fixed order on the card),
    every row reaches the CPU fit's leaf, and the lambdarank pass equals
    the CPU's within 1e-6 of the largest |g| and h, its chunkings bit for
    bit."""
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
    from h2o3_tpu_torch.models import xgboost as xgb
    from h2o3_tpu_torch.models.tree import Tree, forest_leaves

    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 8)).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=3000)) > 0)
    d = {f"f{i}": X[:, i] for i in range(8)}
    d["y"] = y.astype(int).astype(str)
    fr = Frame.from_dict(d, column_types={"y": "enum"})
    params = dict(booster="dart", rate_drop=0.3, one_drop=True, ntrees=8,
                  max_depth=4, seed=11)
    fits = []
    for device in (str(dev), str(dev), "cpu"):
        est = H2OXGBoostEstimator(device=device, **params)
        est.train(y="y", training_frame=fr)
        fits.append(est.model)
    a, b, c = fits
    for fa, fb in zip(a.forest[0], b.forest[0]):
        assert torch.equal(fa, fb)
    Xf = torch.from_numpy(X.astype(np.float64))
    ta, tc = (Tree(*[f.cpu() for f in m.forest[0]]) for m in (a, c))
    assert torch.equal(forest_leaves(ta, Xf, 4), forest_leaves(tc, Xf, 4))
    torch.testing.assert_close(ta.value, tc.value, rtol=0, atol=1e-5)

    sizes = rng.integers(1, 300, 80)
    qid = np.repeat(np.arange(80), sizes)
    rel = rng.integers(0, 5, len(qid)).astype(np.float64)
    m = np.round(rng.normal(size=len(qid) + 8), 1).astype(np.float32)
    on_cpu = xgb._make_lambdarank(qid, rel, 10, torch.device("cpu"))(
        torch.from_numpy(m), None)
    outs = []
    for consts in ({}, dict(PAIR_CHUNK=5000),
                   dict(PAIR_CHUNK=1 << 62, PAD_GROWTH=float("inf"))):
        with monkeypatch.context() as mp:
            for name, value in consts.items():
                mp.setattr(xgb, name, value)
            outs.append(xgb._make_lambdarank(qid, rel, 10, dev)(
                torch.from_numpy(m).to(dev), None))
    for got, want in zip(outs[0], on_cpu):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
    for other in outs[1:]:
        assert all(torch.equal(p, q) for p, q in zip(outs[0], other))


def test_kmeans_on_cuda_matches_cpu(dev):
    """K-Means on the card against the CPU: the seeding is host numpy, so
    both start from the same centres; the Lloyd loop's one-hot sums add in
    another order, so centres agree within 1e-5 and assignments and WSS
    (1e-5 relative) agree. Iteration counts agree within one: the stop
    test compares two f32 WSS values at 1e-7 relative, and where Lloyd
    creeps (Random's start here lands two centres in one blob; the WSS
    falls 2-4e-7 a step) the last step's change is at the sums' rounding,
    so the card stopped one step after the CPU, at the same centres (an
    H100 run: 20 against 19)."""
    from h2o3_tpu_torch.estimators import H2OKMeansEstimator

    rng = np.random.default_rng(3)
    centers = rng.uniform(-10, 10, (4, 6))
    X = np.concatenate([c + rng.normal(size=(2000, 6)) for c in centers])
    fr = Frame.from_numpy(X)
    for init in ("PlusPlus", "Furthest", "Random"):
        fits = [H2OKMeansEstimator(k=4, init=init, seed=5, max_iterations=30,
                                   device=d) for d in (str(dev), "cpu")]
        for est in fits:
            est.train(training_frame=fr)
        a, c = (est.model for est in fits)
        assert abs(a.iterations - c.iterations) <= 1
        assert np.abs(a.centers() - c.centers()).max() <= 1e-5 * max(
            1.0, np.abs(c.centers()).max())
        assert np.array_equal(a.predict(fr).vec("predict").numeric_np(),
                              c.predict(fr).vec("predict").numeric_np())
        assert abs(a.tot_withinss() - c.tot_withinss()) <= 1e-5 * abs(
            c.tot_withinss())


def test_glrm_on_cuda_matches_cpu(dev):
    """GLRM on the card against the CPU: the same host start, the batched
    normal equations solved by cuSOLVER on the card; objectives within
    1e-4 relative, reconstructions and `transform` within 1e-3."""
    from h2o3_tpu_torch.estimators import H2OGeneralizedLowRankEstimator

    rng = np.random.default_rng(4)
    A = rng.normal(size=(3000, 3)) @ rng.normal(size=(3, 12))
    A += 0.05 * rng.normal(size=A.shape)
    A[rng.random(A.shape) < 0.1] = np.nan
    fr = Frame.from_numpy(A)
    for init in ("SVD", "Random"):
        fits = [H2OGeneralizedLowRankEstimator(
            k=3, init=init, seed=2, transform="STANDARDIZE",
            max_iterations=200, device=d) for d in (str(dev), "cpu")]
        for est in fits:
            est.train(training_frame=fr)
        a, c = (est.model for est in fits)
        assert abs(a.objective - c.objective) <= 1e-4 * abs(c.objective)
        for method in ("reconstruct", "transform"):
            ga, gc = (getattr(m, method)(fr) for m in (a, c))
            diff = max(np.abs(ga.vec(n).numeric_np()
                              - gc.vec(n).numeric_np()).max()
                       for n in gc.names)
            assert diff <= 1e-3, (init, method, diff)


def test_uplift_on_cuda_matches_cpu(dev):
    """UpliftDRF on the card against the CPU (the CPU test's fixture, with
    its categorical column): B1 takes every histogram pass, 2 ×
    (max_depth + 1) a tree, and B2 none; the counts and label sums are
    exact integers on both devices, so the forests are equal node for node
    and the leaf values bit for bit; `predict` goes through the forest
    kernel, within 1e-5 of the CPU's walk."""
    from h2o3_tpu_torch.estimators import H2OUpliftRandomForestEstimator
    from h2o3_tpu_torch.ops import score_cuda

    rng = np.random.default_rng(3)
    n = 2000
    X = rng.normal(size=(n, 3))
    treat = rng.integers(0, 2, n)
    base = (X[:, 1] > 0.5).astype(float) * 0.2
    lift = np.where(X[:, 0] > 0, 0.4, 0.0) * treat
    y = (rng.uniform(size=n) < base + lift + 0.1).astype(int)
    g = rng.integers(0, 4, n)
    fr = Frame.from_dict(
        {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
         "g": np.asarray(list("abcd"), dtype=object)[g],
         "treatment": np.asarray(["control", "treatment"],
                                 dtype=object)[treat],
         "y": np.asarray(["0", "1"], dtype=object)[y]},
        column_types={"g": "enum", "treatment": "enum", "y": "enum"})
    params = dict(treatment_column="treatment", ntrees=10, max_depth=5,
                  seed=11)
    before = (hist_cuda.launches, hist_cuda.launches_rows)
    histogram.DISPATCH.clear()
    card = H2OUpliftRandomForestEstimator(device=str(dev), **params).train(
        x=["x0", "x1", "x2", "g"], y="y", training_frame=fr).model
    torch.cuda.synchronize()
    assert hist_cuda.launches - before[0] == 2 * 6 * 10
    assert hist_cuda.launches_rows == before[1]
    assert dict(histogram.DISPATCH) == {"pallas_factored": 2 * 6 * 10}
    cpu = H2OUpliftRandomForestEstimator(device="cpu", **params).train(
        x=["x0", "x1", "x2", "g"], y="y", training_frame=fr).model
    for f in ("feat", "bin", "thr", "is_split", "value"):
        assert torch.equal(getattr(card.forest, f).cpu(),
                           getattr(cpu.forest, f)), f
    scored = score_cuda.launches
    a = card.predict(fr).vec("uplift_predict").numeric_np()
    assert score_cuda.launches == scored + 1
    c = cpu.predict(fr).vec("uplift_predict").numeric_np()
    assert np.abs(a - c).max() <= 1e-5


def test_isolation_forests_on_cuda_match_cpu(dev):
    """IsolationForest and ExtendedIsolationForest `predict` on the card
    against the CPU, from the same host-built trees (IsolationForest) and
    host draws (ExtendedIsolationForest, whose trees build on the device):
    path lengths within 1e-12 and 1e-6, the EIF's splits and counts equal
    and its thresholds within 1e-6; no hand-written kernel runs."""
    from h2o3_tpu_torch.estimators import (
        H2OExtendedIsolationForestEstimator, H2OIsolationForestEstimator)
    from h2o3_tpu_torch.ops import score_cuda

    rng = np.random.default_rng(7)
    X = np.concatenate([rng.normal(size=(3000, 4)),
                        rng.normal(loc=8.0, size=(20, 4))])
    X[::37, 1] = np.nan
    fr = Frame.from_numpy(X)
    before = (hist_cuda.launches, hist_cuda.launches_rows,
              score_cuda.launches)
    fits = [H2OIsolationForestEstimator(ntrees=30, seed=8, device=d).train(
        training_frame=fr).model for d in (str(dev), "cpu")]
    a, c = (m.predict(fr) for m in fits)
    for name in ("predict", "mean_length"):
        assert np.abs(a.vec(name).numeric_np()
                      - c.vec(name).numeric_np()).max() <= 1e-12
    fr = Frame.from_numpy(np.nan_to_num(X))
    for ext in (0, 3):
        fits = [H2OExtendedIsolationForestEstimator(
            ntrees=30, extension_level=ext, seed=9, device=d).train(
            training_frame=fr).model for d in (str(dev), "cpu")]
        ma, mc = fits
        assert torch.equal(ma.splits.cpu(), mc.splits)
        assert torch.equal(ma.counts.cpu(), mc.counts)
        assert (ma.thrs.cpu() - mc.thrs).abs().max() <= 1e-6 * max(
            1.0, float(mc.thrs.abs().max()))
        a, c = (m.predict(fr) for m in fits)
        for name in ("anomaly_score", "mean_length"):
            assert np.abs(a.vec(name).numeric_np()
                          - c.vec(name).numeric_np()).max() <= 1e-6
    torch.cuda.synchronize()
    assert (hist_cuda.launches, hist_cuda.launches_rows,
            score_cuda.launches) == before


def test_uplift_300_bins_on_cuda_matches_cpu(dev):
    """UpliftDRF at nbins=300 pads to B = 512: `build_bins` makes uint16
    codes, sent to the card as int16, and B1 takes its int16 instance at
    every pass; the forest equals the CPU's node for node."""
    from h2o3_tpu_torch.estimators import H2OUpliftRandomForestEstimator

    rng = np.random.default_rng(5)
    n = 3000
    X = rng.normal(size=(n, 3))
    treat = rng.integers(0, 2, n)
    lift = np.where(X[:, 0] > 0, 0.4, 0.0) * treat
    y = (rng.uniform(size=n) < 0.2 * (X[:, 1] > 0.5) + lift + 0.1).astype(int)
    fr = Frame.from_dict(
        {"x0": X[:, 0], "x1": X[:, 1], "x2": X[:, 2],
         "treatment": np.asarray(["control", "treatment"],
                                 dtype=object)[treat],
         "y": np.asarray(["0", "1"], dtype=object)[y]},
        column_types={"treatment": "enum", "y": "enum"})
    params = dict(treatment_column="treatment", ntrees=6, max_depth=5,
                  nbins=300, seed=11)
    before = hist_cuda.launches
    histogram.DISPATCH.clear()
    card = H2OUpliftRandomForestEstimator(device=str(dev), **params).train(
        x=["x0", "x1", "x2"], y="y", training_frame=fr).model
    torch.cuda.synchronize()
    assert card.bm.codes.dtype == np.uint16 and card.bm.nbins == 512
    assert hist_cuda.launches - before == 2 * 6 * 6
    assert dict(histogram.DISPATCH) == {"pallas_factored": 2 * 6 * 6}
    cpu = H2OUpliftRandomForestEstimator(device="cpu", **params).train(
        x=["x0", "x1", "x2"], y="y", training_frame=fr).model
    for f in ("feat", "bin", "thr", "is_split", "value"):
        assert torch.equal(getattr(card.forest, f).cpu(),
                           getattr(cpu.forest, f)), f


def test_naive_bayes_on_cuda_is_repeatable_and_matches_cpu(dev):
    """NaiveBayes's moments on the card are one f32 matrix product: two
    card fits are equal bit for bit, and within 1e-6 relative of the CPU's
    (another summation order); the tables are equal; the card's f64
    scoring of the card model's statistics equals the CPU's scoring of the
    same statistics within 1e-12; no hand-written kernel runs."""
    from h2o3_tpu_torch import convert
    from h2o3_tpu_torch.estimators import H2ONaiveBayesEstimator
    from h2o3_tpu_torch.ops import score_cuda

    rng = np.random.default_rng(4)
    n = 50_000
    y = rng.integers(0, 4, n)
    X = rng.normal(size=(n, 5)) + y[:, None] * 0.7
    X[::29, 3] = np.nan
    g = np.where(rng.uniform(size=n) < 0.6, y, rng.integers(0, 4, n))
    cols = {f"x{i}": X[:, i] for i in range(5)}
    cols["g"] = np.asarray(list("abcd"), dtype=object)[g]
    cols["y"] = np.asarray(list("klmn"), dtype=object)[y]
    fr = Frame.from_dict(cols, column_types={"g": "enum", "y": "enum"})
    before = (hist_cuda.launches, hist_cuda.launches_rows,
              score_cuda.launches)
    card = [H2ONaiveBayesEstimator(device=str(dev), laplace=1.0).train(
        y="y", training_frame=fr).model for _ in range(2)]
    cpu = H2ONaiveBayesEstimator(device="cpu", laplace=1.0).train(
        y="y", training_frame=fr).model
    for name, st in cpu.num_stats.items():
        assert card[0].num_stats[name].tobytes() == \
            card[1].num_stats[name].tobytes()
        assert np.abs(card[0].num_stats[name] - st).max() <= 1e-6 * np.abs(
            st).max()
    assert card[0].cat_tables["g"][0].tobytes() == \
        cpu.cat_tables["g"][0].tobytes()
    m = card[0]
    same_stats = convert.naivebayes_from_numpy(
        priors=m.priors, num_stats=m.num_stats, cat_tables=m.cat_tables,
        spec=m.spec, x=m.x, y=m.y, domain=m.domain, device="cpu")
    assert np.abs(m._probs(fr) - same_stats._probs(fr)).max() <= 1e-12
    torch.cuda.synchronize()
    assert (hist_cuda.launches, hist_cuda.launches_rows,
            score_cuda.launches) == before


def test_isotonic_and_gam_on_cuda_match_cpu(dev):
    """Isotonic regression's knots (host PAV) equal on both devices and its
    f64 scores bit-equal to the CPU's; a GAM's knots and centres equal and
    its predictions within 2e-4 of the CPU's at the defaults (the f32
    Gram's rounding, ROADMAP §C), within 1e-5 with a ridge."""
    from h2o3_tpu_torch.estimators import (H2OGeneralizedAdditiveEstimator,
                                           H2OIsotonicRegressionEstimator)

    rng = np.random.default_rng(6)
    n = 20_000
    x = rng.uniform(-3, 3, n)
    z = rng.normal(size=n)
    yi = np.tanh(x) + rng.normal(0, 0.4, n)
    fr = Frame.from_dict({"x": x, "z": z, "yi": yi, "w": rng.uniform(0.5, 2, n)})
    q = np.concatenate([np.linspace(-4, 4, 1001), [np.nan]])
    for oob in ("NA", "clip"):
        ms = [H2OIsotonicRegressionEstimator(
            device=d, out_of_bounds=oob, weights_column="w").train(
            x=["x"], y="yi", training_frame=fr).model for d in (str(dev), "cpu")]
        assert ms[0].thresholds_x.tobytes() == ms[1].thresholds_x.tobytes()
        assert ms[0].thresholds_y.tobytes() == ms[1].thresholds_y.tobytes()
        assert np.array_equal(ms[0]._score(q), ms[1]._score(q), equal_nan=True)
    eta = np.sin(x) * 2 + 0.5 * z
    yb = (rng.uniform(size=n) < 1 / (1 + np.exp(-eta))).astype(int)
    fr["yb"] = np.asarray(["n", "p"], dtype=object)[yb]
    fr = fr.asfactor("yb")
    for tol, extra in ((2e-4, {}), (1e-5, dict(num_knots=[6], lambda_=1e-4))):
        ms = [H2OGeneralizedAdditiveEstimator(
            device=d, gam_columns=["x"], family="binomial",
            **dict(dict(num_knots=[10]), **extra)).train(
            x=["x", "z"], y="yb", training_frame=fr).model
            for d in (str(dev), "cpu")]
        for (_, ka, ca), (_, kc, cc) in zip(ms[0].gam_spec, ms[1].gam_spec):
            assert ka.tobytes() == kc.tobytes() and ca.tobytes() == cc.tobytes()
        a, c = (m.predict(fr).vec("p").numeric_np() for m in ms)
        assert np.abs(a - c).max() <= tol


def test_coxph_sums_and_concordance_on_cuda_match_cpu(dev):
    """CoxPH's risk-set sums (in stop order and with a start column) and
    its partial likelihood on the card within 1e-12 relative of the CPU's
    (both f64; the scan adds in another order), and the concordance
    counts equal, with many tied times and tied linear predictors."""
    from h2o3_tpu_torch.models import coxph

    rng = np.random.default_rng(7)
    n, p = 30_000, 4
    X = rng.normal(size=(n, p))
    X[:, 3] = rng.integers(0, 3, n)
    ts = -np.sort(-np.ceil(rng.exponential(50.0, n)))
    t0 = np.floor(rng.uniform(0, 0.5, n) * ts)
    ev = (rng.random(n) < 0.6).astype(np.float64)
    w = rng.uniform(0.5, 2.0, n)
    beta = np.array([0.3, -0.2, 0.1, 0.4])
    for ties in ("efron", "breslow"):
        out = []
        for d in (dev, torch.device("cpu")):
            st = coxph._Stratum(X, w, ev, ts, t0, ties, d)
            out.append([v.cpu().numpy() for v in st.partial_ll(
                torch.from_numpy(beta).to(d))])
            r = torch.from_numpy(w * np.exp(X @ beta)).to(d)
            out[-1] += [v.cpu().numpy() for v in coxph.risk_set_sums(
                st.X, r, st.plan, st.n_groups)]
        for a, c in zip(*out):
            assert np.abs(a - c).max() <= 1e-12 * np.abs(c).max()
    lp = np.round(X @ beta, 1)          # ties in lp
    counts = [[int(v) for v in coxph.concordance_counts(
        torch.from_numpy(ts).to(d), torch.from_numpy(ev).to(d),
        torch.from_numpy(lp).to(d))] for d in (dev, torch.device("cpu"))]
    assert counts[0] == counts[1]


def test_psvm_features_and_adam_step_on_cuda_match_cpu(dev):
    """PSVM's f32 Fourier features on the card within 4e-6·√(2/D) of the
    CPU's (true f32: TF32 stays off), and one optax-style Adam step from
    the same gradient within 1e-6 of the CPU's."""
    from h2o3_tpu_torch.models import psvm

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(8)
    X = rng.normal(size=(2_000, 60)).astype(np.float32)
    W = rng.normal(scale=np.sqrt(2 * 0.01), size=(60, 1_000)).astype(np.float32)
    b = rng.uniform(0, 2 * np.pi, 1_000).astype(np.float32)
    y = np.where(rng.random(2_000) < 0.5, -1.0, 1.0).astype(np.float32)
    res = []
    for d in (dev, torch.device("cpu")):
        Z = psvm.fourier_features(torch.from_numpy(X).to(d),
                                  torch.from_numpy(W).to(d),
                                  torch.from_numpy(b).to(d))
        yd = torch.from_numpy(y).to(d)
        beta = torch.full((1_000,), 0.01, dtype=torch.float32, device=d)
        bias = torch.zeros((), dtype=torch.float32, device=d)
        _, gb, gbias = psvm.loss_and_grad(Z, yd, torch.ones_like(yd), 1.0,
                                          beta, bias)
        params, _, _ = psvm.adam_step(
            [beta, bias], [gb, gbias], [torch.zeros_like(beta),
                                        torch.zeros_like(bias)],
            [torch.zeros_like(beta), torch.zeros_like(bias)], 1)
        res.append((Z.cpu().numpy(), params[0].cpu().numpy()))
    assert np.abs(res[0][0] - res[1][0]).max() <= 4e-6 * np.sqrt(2 / 1_000)
    assert np.abs(res[0][1] - res[1][1]).max() <= 1e-6


def test_rulefit_rule_evaluation_on_cuda_matches_cpu(dev):
    """RuleFit's rule columns on the card bit-equal to the CPU's and to the
    host's `Rule.evaluate`, with NaNs and rows on the thresholds."""
    from h2o3_tpu_torch.models import rulefit

    rng = np.random.default_rng(9)
    X = np.round(rng.normal(size=(50_000, 5)), 2)
    X[::17, 2] = np.nan
    names = [f"x{i}" for i in range(5)]
    col_of = {n: i for i, n in enumerate(names)}
    rules = []
    for _ in range(300):
        k = int(rng.integers(1, 4))
        rules.append(rulefit.Rule(tuple(
            (names[int(rng.integers(0, 5))],
             float(np.float32(np.round(rng.normal(), 2))),
             bool(rng.integers(0, 2))) for _ in range(k))))
    got = [rulefit.evaluate_rules(torch.from_numpy(X).to(d), rules,
                                  col_of).cpu().numpy()
           for d in (dev, torch.device("cpu"))]
    want = np.column_stack([r.evaluate(X, col_of) for r in rules])
    assert np.array_equal(got[0], got[1])
    assert np.array_equal(got[1].astype(np.float64), want)


def test_item10_estimators_on_cuda_match_cpu(dev):
    """TargetEncoder's tables and encodings, the quantiles op on unit
    weights and Aggregator's exemplars equal on the card and the CPU;
    Word2Vec's vectors after 3 steps within 1e-5; a lossguide XGBoost
    launches B1 once a tree and once a split, with the CPU's features and
    splits."""
    from h2o3_tpu_torch.estimators import (H2OAggregatorEstimator,
                                           H2OTargetEncoderEstimator,
                                           H2OWord2vecEstimator,
                                           H2OXGBoostEstimator)
    from h2o3_tpu_torch.frame.vec import Vec
    from h2o3_tpu_torch.ops.quantiles import distributed_quantiles

    rng = np.random.default_rng(0)
    n = 3000
    d = {"a": np.asarray([f"a{v}" for v in rng.integers(0, 9, n)], dtype=object),
         "fold": rng.integers(0, 5, n).astype(np.float32),
         "y": np.asarray(["no", "yes"], dtype=object)[rng.integers(0, 2, n)]}
    fr = Frame.from_dict(d, column_types={"a": "enum", "y": "enum"})
    te = [H2OTargetEncoderEstimator(
        device=dv, data_leakage_handling="KFold", fold_column="fold",
        blending=True, noise=0.15, seed=7).train(
        x=["a"], y="y", training_frame=fr).model for dv in (str(dev), "cpu")]
    for i in (1, 2):
        np.testing.assert_array_equal(te[0].encodings["a"][i],
                                      te[1].encodings["a"][i])
    np.testing.assert_array_equal(
        np.asarray(te[0].transform(fr, as_training=True).vec("a_te").data),
        np.asarray(te[1].transform(fr, as_training=True).vec("a_te").data))
    x = rng.lognormal(size=50_000).astype(np.float32)
    q = [distributed_quantiles(torch.from_numpy(x).to(dv),
                               torch.ones(50_000, device=dv), (0.1, 0.5, 0.9)
                               ).cpu() for dv in (dev, "cpu")]
    assert torch.equal(q[0], q[1])
    centers = np.repeat(np.arange(6)[:, None] * 5.0, 2, axis=1)
    X = np.repeat(centers, 40, axis=0) + rng.normal(0, 0.01, (240, 2))
    af = Frame.from_numpy(X, names=["u", "v"])
    ag = [H2OAggregatorEstimator(device=dv, target_num_exemplars=6,
                                 rel_tol_num_exemplars=0.5).train(
        x=["u", "v"], training_frame=af).model for dv in (str(dev), "cpu")]
    np.testing.assert_array_equal(ag[0].exemplar_idx, ag[1].exemplar_idx)
    np.testing.assert_array_equal(ag[0].counts, ag[1].counts)
    words = np.asarray([f"w{int(v)}" for v in rng.zipf(1.4, 1200) % 60],
                       dtype=object)
    words[rng.random(1200) < 0.06] = None
    wf = Frame({"words": Vec(None, "string", strings=words)})
    wv = [H2OWord2vecEstimator(device=dv, vec_size=16, epochs=3, seed=11,
                               init_learning_rate=20.0).train(
        training_frame=wf).model.vectors for dv in (str(dev), "cpu")]
    np.testing.assert_allclose(wv[0], wv[1], rtol=0, atol=1e-5)
    Xl = rng.normal(size=(4000, 6)).astype(np.float32)
    lf = Frame.from_dict({**{f"f{i}": Xl[:, i] for i in range(6)},
                          "y": (Xl[:, 0] + Xl[:, 1] * Xl[:, 2] > 0).astype(
                              int).astype(str)}, column_types={"y": "enum"})
    hist_cuda.launches = 0
    lg = [H2OXGBoostEstimator(device=dv, ntrees=3, max_depth=4, max_bins=64,
                              grow_policy="lossguide", max_leaves=7,
                              seed=1).train(y="y", training_frame=lf).model
          for dv in (str(dev), "cpu")]
    splits = int(lg[0].forest[0].is_split.sum())
    assert hist_cuda.launches == 3 + splits
    for f in ("feat", "is_split"):
        assert torch.equal(getattr(lg[0].forest[0], f).cpu(),
                           getattr(lg[1].forest[0], f))


# -- the out-of-core lane on the card -----------------------------------------

_OOC_KNOBS = ("H2O3_TREE_OOC", "H2O3_STREAM_BLOCKS", "H2O3_STREAM_BUDGET_MB",
              "H2O3_TREE_SHARD", "H2O3_TREE_SHARD_BLOCKS",
              "H2O3_STREAM_HOST_BUDGET_MB", "H2O3_DATASET_CACHE")


def _ooc_frame(n=20_000, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    y = ((X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n)) > 0)
    names = [f"f{i}" for i in range(8)] + ["label"]
    return Frame.from_numpy(np.column_stack([X, y.astype(np.float32)]),
                            names=names).asfactor("label")


def _ooc_fit(mp, dev, fr, env, algo, **params):
    for k in _OOC_KNOBS:
        mp.delenv(k, raising=False)
    mp.setenv("H2O3_DATASET_CACHE", "0")
    for k, v in env.items():
        mp.setenv(k, v)
    cls = (H2OGradientBoostingEstimator if algo == "gbm"
           else H2ORandomForestEstimator)
    e = cls(seed=42, device=str(dev), **params)
    e.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    return e.model


def _same_forest(a, b):
    assert a.ntrees_built == b.ntrees_built
    for fa, fb in zip(a.forest, b.forest):
        for f in fa._fields:
            assert torch.equal(getattr(fa, f).cpu(), getattr(fb, f).cpu()), f
    assert a.varimp_table == b.varimp_table


_OOC_PARAMS = {"gbm": dict(ntrees=3, max_depth=5),
               "drf": dict(ntrees=3, max_depth=8, hist_method="pallas",
                           sample_rate=0.632, mtries=3)}


@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("algo", ["gbm", "drf"])
def test_streamed_fit_on_cuda_equals_the_blocks_lane(dev, monkeypatch, algo,
                                                     S):
    """A streamed fit on the card (B1 for the GBM, B2 for the DRF) equals
    the blocks-lane fit of the same S bit for bit, and launches one kernel
    per block and level."""
    fr = _ooc_frame()
    params = _OOC_PARAMS[algo]
    before = (hist_cuda.launches, hist_cuda.launches_rows)
    a = _ooc_fit(monkeypatch, dev, fr, {
        "H2O3_TREE_OOC": "1", "H2O3_STREAM_BLOCKS": str(S),
        "H2O3_STREAM_BUDGET_MB": "0.05"}, algo, **params)
    launched = (hist_cuda.launches - before[0],
                hist_cuda.launches_rows - before[1])
    b = _ooc_fit(monkeypatch, dev, fr, {
        "H2O3_TREE_OOC": "0", "H2O3_TREE_SHARD": "1",
        "H2O3_TREE_SHARD_BLOCKS": str(S)}, algo, **params)
    assert a._stream_stats["blocks"] == S
    assert a._stream_stats["blocks_evicted"] > 0
    want = a.ntrees_built * params["max_depth"] * S
    assert launched == ((want, 0) if algo == "gbm" else (0, want))
    _same_forest(a, b)


def test_prefetch_evicting_blocks_in_flight_keeps_the_forest(dev,
                                                             monkeypatch):
    """A resident budget of one block (floored at the double buffer): each
    block's prefetch of the next evicts the one before while its kernels
    and copies may still run. Twenty fits give one forest, the blocks
    lane's."""
    fr = _ooc_frame()
    params = dict(ntrees=3, max_depth=5)
    env = {"H2O3_TREE_OOC": "1", "H2O3_STREAM_BLOCKS": "8",
           "H2O3_STREAM_BUDGET_MB": "0.000001"}
    want = _ooc_fit(monkeypatch, dev, fr, {
        "H2O3_TREE_OOC": "0", "H2O3_TREE_SHARD": "1",
        "H2O3_TREE_SHARD_BLOCKS": "8"}, "gbm", **params)
    for _ in range(20):
        got = _ooc_fit(monkeypatch, dev, fr, env, "gbm", **params)
        assert got._stream_stats["resident_block_peak"] <= \
            2 * (got._stream_stats["streamed_bytes"]
                 // max(got._stream_stats["blocks_uploaded"], 1))
        _same_forest(got, want)


def test_pod_gbm_on_one_card_equals_the_blocks_lane(dev, tmp_path):
    """Two ranks sharing the card over gloo (the launcher, a FileStore
    rendezvous) fit the GBM of `test_torch_multiprocess.py` at 200,000
    rows: forest, varimp, scoring history, tree count and each rank's
    `predict` equal the one-rank blocks-lane fit at S = 8 on the card bit
    for bit, and each rank's allocator peak over its fit is at most 0.75×
    the one-rank fit's."""
    from test_torch_multiprocess import (_assert_pod_equals_blocks, _join,
                                         _launch)

    n = 200_000
    splits = {1: [0, n], 2: [0, 99_993, n]}
    _join(tmp_path, [_launch(tmp_path, 1, ["gbm"], n=n, splits=splits,
                             device="cuda", env={"H2O3_TREE_SHARD": "1"})])
    _join(tmp_path, [_launch(tmp_path, 2, ["gbm"], n=n, splits=splits,
                             device="cuda")])

    def load(case, size, rank):
        return np.load(tmp_path / f"{case}_{size}_{rank}.npz")

    _assert_pod_equals_blocks(load, "gbm", 2, 8, splits)
    one = load("gbm", 1, 0)
    for r in range(2):
        pod = load("gbm", 2, r)
        assert 0 < int(pod["dev_alloc"]) <= 0.75 * int(one["dev_alloc"]), (
            r, int(pod["dev_alloc"]), int(one["dev_alloc"]))
