"""TreeSHAP: the port's plain version (`models/tree_shap.py::
tree_shap_plain`, what `compute_contributions` runs on the CPU) against the
reference's numpy TreeSHAP (`h2o3_tpu/models/tree_shap.py::
tree_shap_numpy`) and the brute-force Shapley oracle, on random heaps built
with numpy and handed to both packages; and, on the card, the kernel
(`csrc/tree_shap.cu`) against the plain version, bit for bit.

Tolerances: 1e-12 against the reference's numpy (its own native-against-
numpy tolerance, `tests/test_contributions.py`): the port visits the left
child first and sums each tree's φ from 0.0, the reference the hot child
first into one running φ, so only the rounding of the sums differs. 1e-10
against brute force (the reference's own tolerance there).

The `cuda` cases import no `jax`, so on a machine with a card they run
alone:

    python -m pytest --noconftest tests/test_torch_tree_shap.py -m cuda -q
"""

from collections import namedtuple

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.models import tree as treelib
from h2o3_tpu_torch.models import tree_shap as ts

Fst = namedtuple("Fst", "feat thr is_split value")


def _random_heaps(rng, nt, depth, F, p_split=0.8, zero_cover=0.1,
                  consistent=False):
    """(feat, thr, is_split, value, cover) of nt random heaps: features
    drawn from few columns (so paths repeat them), splits below a leaf
    cleared, a share of the covers zero; with `consistent`, leaf covers
    positive and every split node's cover the sum of its children's."""
    T = treelib.heap_size(depth)
    feat = rng.integers(0, F, (nt, T)).astype(np.int32)
    thr = rng.normal(size=(nt, T)).astype(np.float32)
    issp = rng.random((nt, T)) < p_split
    issp[:, 2 ** depth - 1:] = False
    for i in range(1, T):
        issp[:, i] &= issp[:, (i - 1) // 2]
    val = rng.normal(size=(nt, T)).astype(np.float32)
    if consistent:
        cov = np.zeros((nt, T), np.float32)
        cov[:, 2 ** depth - 1:] = rng.random((nt, 2 ** depth)) + 0.1
        for i in range(2 ** depth - 2, -1, -1):
            cov[:, i] = cov[:, 2 * i + 1] + cov[:, 2 * i + 2]
    else:
        cov = (rng.random((nt, T)) * 10).astype(np.float32)
        cov[rng.random((nt, T)) < zero_cover] = 0.0
    return feat, thr, issp, val, cov


def _port(feat, thr, issp, val, cov, device="cpu"):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return treelib.Tree(t(feat), t(feat), t(thr), t(issp), t(val)), t(cov)


def _rows(rng, n, F, thr=None):
    """f64 rows with 10 % NaN; where `thr` is given, some values sit
    exactly on an f32 threshold and one f64 ulp above it."""
    X = rng.normal(size=(n, F))
    X[rng.random(X.shape) < 0.1] = np.nan
    if thr is not None:
        t = thr.reshape(-1)[rng.integers(0, thr.size, n)].astype(np.float64)
        X[:, 0] = t
        X[::2, 1 % F] = np.nextafter(t[::2], np.inf)
    return X


@pytest.mark.parametrize("depth", list(range(9)))
def test_plain_matches_reference_numpy(depth):
    from h2o3_tpu.models import tree_shap as ref

    rng = np.random.default_rng(depth)
    F = 3 if depth < 6 else 5
    parts = _random_heaps(rng, 4, depth, F)
    X = _rows(rng, 24 if depth < 7 else 8, F, parts[1])
    want = ref.tree_shap_numpy(Fst(*parts[:4]), parts[4], X, 0.5)
    forest, cov = _port(*parts)
    got = ts.tree_shap_plain(forest, cov, torch.from_numpy(X), 0.5).numpy()
    # zero covers give NaN φ in both, at the same places
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_single_leaf_trees():
    from h2o3_tpu.models import tree_shap as ref

    rng = np.random.default_rng(7)
    parts = _random_heaps(rng, 3, 4, 4)
    parts[2][:] = False                          # every root a leaf
    X = _rows(rng, 10, 4)
    forest, cov = _port(*parts)
    got = ts.tree_shap_plain(forest, cov, torch.from_numpy(X), 1.0).numpy()
    want = ref.tree_shap_numpy(Fst(*parts[:4]), parts[4], X, 1.0)
    assert np.all(got[:, :4] == 0.0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("trial", range(5))
def test_plain_matches_bruteforce(trial):
    from h2o3_tpu.models import tree_shap as ref

    rng = np.random.default_rng(30 + trial)
    D, F = 3 + trial % 2, 3
    parts = _random_heaps(rng, 2, D, F, consistent=True)
    X = _rows(rng, 4, F)
    forest, cov = _port(*parts)
    got = ts.tree_shap_plain(forest, cov, torch.from_numpy(X), 1.0).numpy()
    for r in range(X.shape[0]):
        bf = ts.shapley_bruteforce(Fst(*parts[:4]), parts[4], X[r])
        np.testing.assert_array_equal(
            bf, ref.shapley_bruteforce(Fst(*parts[:4]), parts[4], X[r]))
        np.testing.assert_allclose(got[r], bf, rtol=0, atol=1e-10)


@pytest.mark.parametrize("depth", [0, 2, 5, 8])
def test_bias_matches_reference_expected_value(depth):
    from h2o3_tpu.models import tree_shap as ref

    rng = np.random.default_rng(50 + depth)
    feat, thr, issp, val, cov = _random_heaps(rng, 5, depth, 4)
    ev = ts.tree_expectations(issp, val, cov)
    want = [ref._expected_value(feat[t], thr[t], issp[t],
                                val[t].astype(np.float64),
                                cov[t].astype(np.float64), 0)
            for t in range(5)]
    np.testing.assert_array_equal(ev, np.asarray(want, np.float64))
    forest, c = _port(feat, thr, issp, val, cov)
    bias = 0.0
    for e in want:
        bias += e * 0.25
    assert ts.forest_bias(forest, c, 0.25) == bias


@pytest.mark.parametrize("scale,f0", [(1.0, -0.375), (1.0 / 7, 0.0)])
def test_compute_contributions_f0_and_scale(scale, f0):
    """f0·scale lands in the bias term; a DRF's 1/ntrees scales every
    column. Against the reference's `compute_contributions` (its native
    kernel where it is built, its numpy otherwise)."""
    from h2o3_tpu.models import tree_shap as ref

    rng = np.random.default_rng(60)
    parts = _random_heaps(rng, 7, 5, 4, consistent=True)
    X = _rows(rng, 32, 4, parts[1])
    want = ref.compute_contributions(*parts, X, scale, f0)
    forest, cov = _port(*parts)
    got = ts.compute_contributions(forest, cov, torch.from_numpy(X), scale,
                                   f0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    bias = ts.forest_bias(forest, cov, scale) + f0 * scale
    assert np.all(got[:, -1] == bias)


def test_covers_shape_mismatch_raises():
    rng = np.random.default_rng(61)
    parts = _random_heaps(rng, 3, 3, 4)
    forest, cov = _port(*parts)
    with pytest.raises(ValueError, match="covers shape"):
        ts.compute_contributions(forest, cov[:2], torch.zeros(2, 4,
                                 dtype=torch.float64), 1.0, 0.0)


def test_heap_depth():
    assert [ts.heap_depth(treelib.heap_size(d)) for d in range(12)] == \
        list(range(12))
    with pytest.raises(ValueError):
        ts.heap_depth(6)


# -- the kernel on the card ----------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 3, 6, 9, 12, 19])
def test_kernel_equals_plain_bit_for_bit(dev, depth):
    from h2o3_tpu_torch.ops import shap_cuda

    rng = np.random.default_rng(200 + depth)
    F = 5
    parts = _random_heaps(rng, 3, depth, F, p_split=0.9 if depth < 10 else 0.6)
    X = _rows(rng, 300, F, parts[1])
    forest, cov = _port(*parts, device=dev)
    Xd = torch.from_numpy(X).to(dev)
    before = shap_cuda.launches
    got = ts.compute_contributions(forest, cov, Xd, 0.5, 0.25)
    torch.cuda.synchronize()
    assert shap_cuda.launches == before + 1
    fc, cc = _port(*parts)
    want = ts.compute_contributions(fc, cc, torch.from_numpy(X), 0.5, 0.25)
    assert torch.equal(got.cpu().isnan(), want.isnan())
    assert torch.equal(got.cpu().nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
def test_kernel_chunks_rows(dev, monkeypatch):
    from h2o3_tpu_torch.ops import shap_cuda

    rng = np.random.default_rng(300)
    parts = _random_heaps(rng, 4, 5, 4, consistent=True)
    X = _rows(rng, 1000, 4)
    forest, cov = _port(*parts, device=dev)
    Xd = torch.from_numpy(X).to(dev)
    whole = ts.compute_contributions(forest, cov, Xd, 1.0, 0.0)
    monkeypatch.setattr(shap_cuda, "SCRATCH_BYTES", 4 * 4 * 8 * 300)
    before = shap_cuda.launches
    chunked = ts.compute_contributions(forest, cov, Xd, 1.0, 0.0)
    torch.cuda.synchronize()
    assert shap_cuda.launches == before + 4
    assert torch.equal(whole, chunked)
