"""`build_tree` parity: the same fixture through the reference's depth-wise
fused builder and the port's. Fixtures have no near-tied gains, so the
structure (feature, bin, split flag per node) must match exactly, and the
leaf values within 1e-5. Also the scorers on codes and on raw values, whose
outputs inherit the leaf values' 1e-5 tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu.models import tree as ref_tree
from h2o3_tpu_torch.models import tree
from h2o3_tpu_torch.ops import packing, prng

B = 21


def _fixture(seed, N=4096, F=6):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, (N, F)).astype(np.uint8)
    signal = (1.5 * (codes[:, 1] >= 10) - 0.9 * (codes[:, 2] < 6)
              + 0.05 * codes[:, 3] + 0.4 * (codes[:, 4] == B - 1))
    y = (rng.random(N) < 1 / (1 + np.exp(-(signal - 0.6)))).astype(np.float32)
    p = np.full(N, y.mean(), np.float32)
    g = (p - y).astype(np.float32) + 0.01 * rng.normal(size=N).astype(np.float32)
    h = (p * (1 - p)).astype(np.float32) + 0.1 * rng.random(N).astype(np.float32)
    w = np.ones(N, np.float32)
    w[-40:] = 0.0                                 # zero-weight pad rows
    edges = np.sort(rng.normal(size=(F, B - 2)), axis=1).astype(np.float32)
    return codes, g, h, w, edges


def _nan_fixture():
    """reg_lambda=0 with rows of zero g and h: inside the right subtree of
    the root split (feature 1, codes >= 10) the left cumulative sums of
    feature 0's first bin are 0/0, a NaN gain. NaN counts as the maximum
    and is not > the threshold, so that node must not split."""
    codes, g, h, w, edges = _fixture(7)
    dead = (codes[:, 1] >= 10) & (codes[:, 0] == 0)
    g[dead] = 0.0
    h[dead] = 0.0
    return codes, g, h, w, edges


def _both(codes, g, h, w, edges, depth, pack_bits, **kw):
    F = codes.shape[1]
    c = packing.pack_host(codes, pack_bits) if pack_bits else codes
    fm = np.ones(F, np.float32)
    ref = ref_tree.build_tree(
        jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jnp.asarray(fm), jnp.asarray(edges), max_depth=depth, nbins=B,
        hist_method="segment", pack_bits=pack_bits, fused_split=True, **kw)
    got = tree.build_tree(
        torch.from_numpy(c), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(w), torch.from_numpy(fm), torch.from_numpy(edges),
        max_depth=depth, nbins=B, pack_bits=pack_bits, **kw)
    return ref, got


def _assert_same_tree(ref, got):
    (rt, rleaf, rgain, rcov), (gt, gleaf, ggain, gcov) = ref[:4], got[:4]
    for f in ("feat", "bin", "is_split"):
        assert np.array_equal(getattr(gt, f).numpy(), np.asarray(getattr(rt, f))), f
    np.testing.assert_allclose(gt.thr.numpy(), np.asarray(rt.thr), rtol=0, atol=0)
    np.testing.assert_allclose(gt.value.numpy(), np.asarray(rt.value),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(gleaf.numpy(), np.asarray(rleaf))
    np.testing.assert_allclose(ggain.numpy(), np.asarray(rgain), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gcov.numpy(), np.asarray(rcov), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("pack_bits", [0, 5])
@pytest.mark.parametrize("reg", [dict(reg_lambda=1.0), dict(reg_lambda=0.0),
                                 dict(reg_lambda=1.0, reg_alpha=0.3)])
def test_build_tree_parity(pack_bits, reg):
    codes, g, h, w, edges = _fixture(1)
    ref, got = _both(codes, g, h, w, edges, 4, pack_bits, min_rows=10.0,
                     min_split_improvement=1e-5, **reg)
    assert bool(np.asarray(ref[0].is_split).sum() >= 7)   # a real tree
    _assert_same_tree(ref, got)


@pytest.mark.parametrize("pack_bits", [0, 5])
def test_build_tree_parity_in_row_blocks(pack_bits):
    """Histograms and leaf totals accumulated per contiguous row block and
    folded in block order, in both packages."""
    codes, g, h, w, edges = _fixture(5)
    ref, got = _both(codes, g, h, w, edges, 4, pack_bits, min_rows=10.0,
                     min_split_improvement=1e-5, n_shard_blocks=4)
    _assert_same_tree(ref, got)


@pytest.mark.parametrize("pack_bits", [0, 5])
def test_build_tree_nan_gain_rule(pack_bits):
    codes, g, h, w, edges = _nan_fixture()
    ref, got = _both(codes, g, h, w, edges, 4, pack_bits, min_rows=10.0,
                     min_split_improvement=1e-5, reg_lambda=0.0)
    issp = np.asarray(ref[0].is_split)
    # the root splits on feature 1; its right child meets the NaN gain
    assert issp[0] and int(np.asarray(ref[0].feat)[0]) == 1
    assert issp[1] and not issp[2]
    _assert_same_tree(ref, got)


def test_nan_first_argmax_matches_jnp_argmax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 40)).astype(np.float32)
    x[rng.random(x.shape) < 0.05] = np.nan
    x[rng.random(x.shape) < 0.2] = -np.inf
    x[5] = -np.inf
    x[6, 3] = x[6, 9] = 50.0                     # a tie: first occurrence
    got = tree._nan_first_argmax(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jnp.argmax(jnp.asarray(x), axis=1)))


@pytest.mark.parametrize("pack_bits", [0, 5])
def test_predict_codes_matches_reference(pack_bits):
    codes, g, h, w, edges = _fixture(2)
    (rt, _, _, _), (gt, _, _, _) = _both(codes, g, h, w, edges, 4, pack_bits,
                                         min_rows=10.0)
    c = packing.pack_host(codes, pack_bits) if pack_bits else codes
    got = tree.predict_codes_packed(gt, torch.from_numpy(c), pack_bits, 4)
    ref = np.asarray(ref_tree.predict_codes_packed(
        rt, jnp.asarray(c), pack_bits, 4))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_predict_forest_raw_matches_reference():
    """A 3-tree forest scored on raw values with NaNs (NaN goes right)."""
    trees_ref, trees_port = [], []
    for s in range(3):
        codes, g, h, w, edges = _fixture(10 + s)
        (rt, _, _, _), (gt, _, _, _) = _both(codes, g, h, w, edges, 4, 0,
                                             min_rows=10.0)
        trees_ref.append(rt)
        trees_port.append(gt)
    rf = ref_tree.stack_trees(trees_ref)
    pf = tree.Tree(*[torch.stack([getattr(t, f) for t in trees_port])
                     for f in tree.Tree._fields])
    rng = np.random.default_rng(4)
    X = rng.normal(size=(777, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    got = tree.predict_forest_raw(pf, torch.from_numpy(X), 4).numpy()
    ref = np.asarray(ref_tree.predict_forest_raw(rf, jnp.asarray(X), 4))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _fused_fixture(seed=1, N=2048, F=9):
    """`tests/test_tree_fused.py::_tree_data`: continuous g, h > 0.1."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, (N, F)).astype(np.uint8)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32) + 0.1
    w = np.where(rng.random(N) > 0.05, 1.0, 0.0).astype(np.float32)
    edges = np.sort(rng.normal(size=(F, B - 2)), axis=1).astype(np.float32)
    return codes, g, h, w, edges


def _both_keyed(codes, g, h, w, edges, seed, pack_bits=0, **kw):
    """`_both` with the per-level column sample drawn from PRNGKey(seed)
    (jax.random in the reference, `ops.prng` in the port)."""
    rate = kw.pop("mtries_rate", None)
    rkw = dict(kw, key=jax.random.PRNGKey(seed))
    pkw = dict(kw, key=prng.PRNGKey(seed))
    if rate is not None:
        rkw["mtries_rate"] = jnp.float32(rate)
        pkw["mtries_rate"] = rate
    F = codes.shape[1]
    c = packing.pack_host(codes, pack_bits) if pack_bits else codes
    fm = np.ones(F, np.float32)
    ref = ref_tree.build_tree(
        jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jnp.asarray(fm), jnp.asarray(edges), nbins=B, hist_method="segment",
        pack_bits=pack_bits, fused_split=True, **rkw)
    got = tree.build_tree(
        torch.from_numpy(c), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(w), torch.from_numpy(fm), torch.from_numpy(edges),
        nbins=B, pack_bits=pack_bits, **pkw)
    return ref, got


@pytest.mark.parametrize("pack_bits", [0, 5])
@pytest.mark.parametrize("rate", [0.5, 5 / 9])
def test_build_tree_mtries_parity(pack_bits, rate):
    """Per-level (node, feature) keep masks from the threefry draws: the
    same features are offered to each node, so the same tree is built."""
    codes, g, h, w, edges = _fused_fixture()
    ref, got = _both_keyed(codes, g, h, w, edges, 3, pack_bits, max_depth=4,
                           min_rows=5.0, mtries_rate=rate)
    full, _ = _both_keyed(codes, g, h, w, edges, 3, pack_bits, max_depth=4,
                          min_rows=5.0)
    # the sample really changed the tree
    assert not np.array_equal(np.asarray(ref[0].feat), np.asarray(full[0].feat))
    _assert_same_tree(ref, got)


@pytest.mark.parametrize("pack_bits", [0, 5])
@pytest.mark.parametrize("mtries_rate", [None, 0.5])
def test_build_tree_compact_parity(pack_bits, mtries_rate):
    """Depth 9 with a 64-slot cap: levels 7 and 8 run in compact slots and
    split there. The same tree, the same per-row leaves, no overflow."""
    codes, g, h, w, edges = _fused_fixture(N=2048, F=9)
    ref, got = _both_keyed(codes, g, h, w, edges, 5, pack_bits, max_depth=9,
                           min_rows=12.0, compact_cap=64,
                           mtries_rate=mtries_rate)
    assert int(np.asarray(ref[-1])) == 0 and int(got[-1]) == 0
    assert tree.compact_switch_depth(9, 64) == 7
    assert np.asarray(ref[0].is_split)[127:511].sum() >= 10
    _assert_same_tree(ref, got)


@pytest.mark.parametrize("pack_bits", [0, 5])
def test_build_tree_compact_overflow_flag(pack_bits):
    """A 4-slot cap cannot hold the live frontier: both packages count the
    same overflows (the fit loop then rebuilds the tree densely)."""
    codes, g, h, w, edges = _fused_fixture(N=2048, F=9)
    ref, got = _both_keyed(codes, g, h, w, edges, 5, pack_bits, max_depth=8,
                           min_rows=1.0, compact_cap=4)
    assert int(np.asarray(ref[-1])) > 0
    assert int(got[-1]) == int(np.asarray(ref[-1]))


def test_histogram_level_plan_matches_reference():
    for depth, cap in ((6, 0), (19, 4096), (8, 64), (14, 16), (3, 4096)):
        assert (tree.histogram_level_plan(depth, cap)
                == ref_tree.histogram_level_plan(depth, cap))
