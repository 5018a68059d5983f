"""Forest scoring: the port's plain walk (`tree.predict_forest_raw`, what
`score_cuda.forest_score` runs on the CPU) against the reference's fused
scorer (`build_score_table_jit` + `predict_forest_fused`), on the random
forests of `tests/test_score_fused.py` (ragged heaps, NaN features, depth-0
stumps, zero-padded trees), built with numpy and handed to both packages;
and, on the card, the forest kernel (`csrc/score.cu`) against the walk.

The `cuda` cases import no `jax`, so on a machine with a card and without
the JAX package they run alone:

    python -m pytest --noconftest tests/test_torch_score.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.models import tree as treelib
from h2o3_tpu_torch.ops import score_cuda

DEPTHS = [1, 2, 4, 5, 6, 8, 11]


def _random_forest(rng, nt, depth, F, frac_leaf=0.15):
    """`tests/test_score_fused.py::_random_forest` in numpy: (feat, thr,
    is_split, value) of nt trees of the given depth, the deepest level and
    a random 15 % of the other nodes not split."""
    T = treelib.heap_size(depth)
    feat = rng.integers(0, F, size=(nt, T)).astype(np.int32)
    thr = rng.normal(size=(nt, T)).astype(np.float32)
    issp = np.zeros((nt, T), bool)
    issp[:, : 2 ** depth - 1] = True
    issp[rng.random((nt, T)) < frac_leaf] = False
    val = (rng.normal(size=(nt, T)) * 0.1).astype(np.float32)
    return feat, thr, issp, val


def _port_tree(feat, thr, issp, val, device="cpu"):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return treelib.Tree(t(feat), t(feat), t(thr), t(issp), t(val))


def _reference_fused(feat, thr, issp, val, X, depth):
    import jax.numpy as jnp

    from h2o3_tpu.models import tree as reftree

    forest = reftree.Tree(jnp.asarray(feat), jnp.asarray(feat),
                          jnp.asarray(thr), jnp.asarray(issp),
                          jnp.asarray(val))
    walk, value = reftree.build_score_table_jit(forest, max_depth=depth)
    return np.asarray(reftree.predict_forest_fused(walk, value,
                                                   jnp.asarray(X), depth))


def _rows(rng, n, F, nan_frac=0.05):
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[rng.random(X.shape) < nan_frac] = np.nan
    return X


@pytest.mark.parametrize("depth", DEPTHS)
def test_walk_matches_reference_fused(depth):
    rng = np.random.default_rng(depth)
    F = 7
    parts = _random_forest(rng, nt=6, depth=depth, F=F)
    X = _rows(rng, 257, F)
    ref = _reference_fused(*parts, X, depth)
    got = score_cuda.forest_score(_port_tree(*parts), torch.from_numpy(X),
                                  depth).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_walk_depth_zero_stumps():
    rng = np.random.default_rng(1)
    parts = (np.zeros((4, 1), np.int32), np.zeros((4, 1), np.float32),
             np.zeros((4, 1), bool),
             rng.normal(size=(4, 1)).astype(np.float32))
    X = rng.normal(size=(10, 3)).astype(np.float32)
    ref = _reference_fused(*parts, X, 0)
    got = score_cuda.forest_score(_port_tree(*parts), torch.from_numpy(X),
                                  0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.full(10, parts[3].sum()), rtol=1e-6)


def test_walk_zero_padded_trees_add_nothing():
    """Trees of all-zero fields (the reference's pow2 tree-count padding)
    contribute exactly 0; a forest of no trees scores 0."""
    rng = np.random.default_rng(2)
    parts = _random_forest(rng, nt=5, depth=3, F=4)
    padded = [np.concatenate([a, np.zeros((3,) + a.shape[1:], a.dtype)])
              for a in parts]
    X = rng.normal(size=(50, 4)).astype(np.float32)
    ref = _reference_fused(*padded, X, 3)
    Xt = torch.from_numpy(X)
    got = score_cuda.forest_score(_port_tree(*padded), Xt, 3).numpy()
    unpadded = score_cuda.forest_score(_port_tree(*parts), Xt, 3).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, unpadded)
    empty = [a[:0] for a in parts]
    assert np.array_equal(
        score_cuda.forest_score(_port_tree(*empty), Xt, 3).numpy(),
        np.zeros(50, np.float32))


# -- the kernel on the card ----------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_walk(dev, parts, X, depth):
    forest = _port_tree(*parts, device=dev)
    Xd = torch.from_numpy(X).to(dev)
    before = score_cuda.launches
    got = score_cuda.forest_score(forest, Xd, depth)
    want = treelib.predict_forest_raw(forest, Xd, depth)
    torch.cuda.synchronize()
    assert score_cuda.launches == before + 1
    return got.cpu().numpy(), want.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0] + DEPTHS)
def test_kernel_matches_walk(dev, depth):
    """f32 sums of the same leaf values in another order: within 1e-5 of
    the walk, scaled by the largest sum."""
    rng = np.random.default_rng(100 + depth)
    F = 7
    parts = _random_forest(rng, nt=9, depth=depth, F=F)
    X = _rows(rng, 1000, F)
    got, want = _kernel_vs_walk(dev, parts, X, depth)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [3, 11])
def test_kernel_equals_walk_bit_for_bit_on_a_dyadic_forest(dev, depth):
    """Leaf values on a 2^-10 grid make every sum exact in any order, so the
    kernel's traversal must give the walk's sums to the bit."""
    rng = np.random.default_rng(7 + depth)
    F = 5
    feat, thr, issp, _ = _random_forest(rng, nt=40, depth=depth, F=F)
    val = (rng.integers(-512, 512, size=feat.shape) / 1024.0).astype(np.float32)
    X = _rows(rng, 3000, F)
    got, want = _kernel_vs_walk(dev, (feat, thr, issp, val), X, depth)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(dev):
    rng = np.random.default_rng(3)
    parts = _random_forest(rng, nt=2, depth=3, F=4)
    forest = _port_tree(*parts, device=dev)
    X = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)).to(dev)
    with pytest.raises(ValueError, match="shallower"):
        score_cuda.forest_score(forest, X, 4)
    with pytest.raises(TypeError):
        score_cuda.forest_score(forest, X.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        score_cuda.forest_score(forest, X.t().contiguous().t(), 3)
