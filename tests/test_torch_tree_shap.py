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
    for lvl in range(1, depth + 1):
        lo = 2 ** lvl - 1
        issp[:, lo:2 * lo + 1] &= np.repeat(issp[:, (lo - 1) // 2:lo], 2,
                                            axis=1)
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


# -- the path plan and its replay ---------------------------------------------

def _same(got, want):
    """Equal bit for bit, NaN at the same places."""
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.nan_to_num(), want.nan_to_num()))


@pytest.mark.parametrize("depth", list(range(13)))
def test_replay_equals_plain_bit_for_bit(depth):
    """`tree_shap_replay_plain` over `build_shap_plan` gives
    `tree_shap_plain`'s bits, NaN included, on random heaps with zero
    covers and on consistent ones."""
    rng = np.random.default_rng(400 + depth)
    F = 3 if depth < 6 else 5
    p_split = 0.9 if depth < 7 else (0.75 if depth < 10 else 0.7)
    for consistent in (False, True):
        parts = _random_heaps(rng, 2, depth, F, p_split=p_split,
                              consistent=consistent)
        parts[2][:, 0] = depth > 0               # every root splits
        X = torch.from_numpy(_rows(rng, 12, F, parts[1]))
        forest, cov = _port(*parts)
        plan = ts.build_shap_plan(forest, cov, F)
        want = ts.tree_shap_plain(forest, cov, X, 0.5, 0.125)
        got = ts.tree_shap_replay_plain(plan, X, 0.5, 0.125)
        assert _same(got, want)


def test_plan_matches_instrumented_dfs(monkeypatch):
    """The plan's steps are the DFS's node entries in its order: each
    zero fraction equal to the bits `_tree_phi` extends with, each unwind
    position the one it unwinds at, on heaps whose paths repeat features;
    the leaves, their levels and values are where the DFS stops."""
    import sys

    rng = np.random.default_rng(410)
    depth, F = 6, 2
    parts = _random_heaps(rng, 3, depth, F, p_split=0.85)
    forest, cov = _port(*parts)
    entered, unwound = [], {}
    real_extend, real_unwind = ts._extend, ts._unwind

    def extend(W, pz, po):
        fr = sys._getframe(1).f_locals
        entered.append((fr["node"], fr["level"], pz))
        return real_extend(W, pz, po)

    def unwind(W, one, zero):
        fr = sys._getframe(1).f_locals
        unwound[(len(entered), fr["node"])] = (fr["i"], zero)
        return real_unwind(W, one, zero)

    monkeypatch.setattr(ts, "_extend", extend)
    monkeypatch.setattr(ts, "_unwind", unwind)
    steps, leaves = [], []
    for t in range(3):
        entered.clear()
        unwound.clear()
        ts._tree_phi(ts._HostTree(parts[0][t].astype(np.int64), parts[1][t],
                                  parts[2][t], parts[3][t], parts[4][t]),
                     torch.from_numpy(_rows(rng, 4, F)), 1.0, depth)
        # the position a split unwinds at, by split node (one visit each)
        at = {node: i for (_, node), (i, _) in unwound.items()}
        for node, level, pz in entered[1:]:
            par = (node - 1) // 2
            steps.append((pz, at.get(par, -1), int(parts[0][t][par]),
                          node % 2 == 0))
            if not parts[2][t][node] or level == depth:
                leaves.append((t, level, float(parts[3][t][node])))
    assert unwound, "the heap must repeat features"
    plan = ts.build_shap_plan(forest, cov, F)
    assert plan.step_zin.tolist() == [s[0] for s in steps]
    assert plan.step_pos.tolist() == [s[1] for s in steps]
    assert plan.step_feat.tolist() == [s[2] for s in steps]
    assert plan.step_right.tolist() == [s[3] for s in steps]
    assert plan.leaf_level.tolist() == [lv[1] for lv in leaves]
    assert plan.leaf_value.tolist() == [lv[2] for lv in leaves]
    per_tree = np.bincount([lv[0] for lv in leaves], minlength=3)
    assert plan.tree_leaf.tolist() == [0] + np.cumsum(per_tree).tolist()
    # each leaf's steps: its fresh ones end at it; the unwind level names
    # the level whose step put the repeated feature on the path
    ends = plan.leaf_step.tolist()
    assert ends[0] == 0 and ends[-1] == len(steps)
    lvl = plan.leaf_level.tolist()
    feat, ulev = plan.step_feat.tolist(), plan.step_ulev.tolist()
    path = {}
    for leaf in range(len(lvl)):
        fresh = ends[leaf + 1] - ends[leaf]
        for j, s in zip(range(lvl[leaf] - fresh + 1, lvl[leaf] + 1),
                        range(ends[leaf], ends[leaf + 1])):
            path[j] = s
            assert (ulev[s] == -1) == (plan.step_pos[s] == -1)
            if ulev[s] >= 0:
                assert 1 <= ulev[s] < j and feat[path[ulev[s]]] == feat[s]


def test_single_leaf_plan_is_empty():
    rng = np.random.default_rng(420)
    parts = _random_heaps(rng, 3, 4, 4)
    parts[2][:] = False
    forest, cov = _port(*parts)
    plan = ts.build_shap_plan(forest, cov, 4)
    assert plan.tree_leaf.tolist() == [0, 0, 0, 0]
    assert plan.leaf_step.tolist() == [0]
    assert plan.step_zin.numel() == plan.leaf_level.numel() == 0
    X = torch.from_numpy(_rows(rng, 5, 4))
    got = ts.tree_shap_replay_plain(plan, X, 1.0, 0.5)
    assert torch.equal(got, ts.tree_shap_plain(forest, cov, X, 1.0, 0.5))


# -- the kernel on the card ----------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _sparse_heaps(rng, nt, depth, F, device, p_split=0.6):
    """(feat, thr, is_split, value, cover) tensors of nt heaps of `depth`
    on `device`, drawn at their reachable nodes only (the rest zero, which
    no walk reads): every root splits, a split's children split with
    p_split, and one chain from each root (sides alternating) splits down
    to the last level; 10 % of the covers are zero."""
    T = treelib.heap_size(depth)
    z = lambda dt: torch.zeros((nt, T), dtype=dt, device=device)  # noqa: E731
    feat, thr, issp = z(torch.int32), z(torch.float32), z(torch.bool)
    val, cov = z(torch.float32), z(torch.float32)
    tree, node = np.arange(nt), np.zeros(nt, np.int64)
    chain = np.zeros(nt, np.int64)
    put = lambda a, v: a.__setitem__(  # noqa: E731
        (torch.from_numpy(tree).to(device), torch.from_numpy(node).to(device)),
        torch.from_numpy(v).to(device=device, dtype=a.dtype))
    for lvl in range(depth + 1):
        n = len(node)
        put(feat, rng.integers(0, F, n))
        put(thr, rng.normal(size=n))
        put(val, rng.normal(size=n))
        put(cov, np.where(rng.random(n) < 0.1, 0.0, rng.random(n) * 10))
        if lvl == depth:
            break
        sp = (rng.random(n) < p_split) | (node == chain[tree]) | (lvl == 0)
        tree, node = tree[sp], node[sp]
        put(issp, np.ones(len(node), bool))
        tree = np.repeat(tree, 2)
        node = 2 * np.repeat(node, 2) + 1 + np.tile([0, 1], len(node))
        chain = 2 * chain + 1 + lvl % 2
    return feat, thr, issp, val, cov


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 3, 6, 9, 12, 19, 25, 30])
def test_kernel_equals_plain_bit_for_bit(dev, depth):
    """Each depth bucket (8, 12, 20, 30) against the plain version. Depths
    25 and 30 are drawn at their reachable nodes on the card; at depth 30
    (2^31 − 1 nodes a heap, 36.5 GB of fields on the card) the plain DFS's
    host copy of the heap would need ≈70 GB, so the kernel is held there
    against `tree_shap_replay_plain` on the card, which the CPU tests hold
    equal to `tree_shap_plain` bit for bit."""
    from h2o3_tpu_torch.ops import shap_cuda

    rng = np.random.default_rng(200 + depth)
    F = 5
    if depth < 20:
        parts = _random_heaps(rng, 3, depth, F,
                              p_split=0.9 if depth < 10 else 0.6)
        forest, cov = _port(*parts, device=dev)
        X = _rows(rng, 300, F, parts[1])
    else:
        feat, thr, issp, val, cov = _sparse_heaps(rng, 2 if depth < 30 else 1,
                                                  depth, F, dev)
        forest = treelib.Tree(feat, feat, thr, issp, val)
        X = _rows(rng, 300, F)
    Xd = torch.from_numpy(X).to(dev)
    before = shap_cuda.launches
    if depth < 30:
        got = ts.compute_contributions(forest, cov, Xd, 0.5, 0.25)
        torch.cuda.synchronize()
        fc, cc = treelib.Tree(*[f.cpu() for f in forest]), cov.cpu()
        want = ts.compute_contributions(fc, cc, torch.from_numpy(X), 0.5,
                                        0.25)
    else:
        plan = ts.build_shap_plan(forest, cov, F)
        assert int(plan.leaf_level.max()) == depth
        got = shap_cuda.tree_shap(forest, cov, Xd, 0.5, 0.25, plan=plan)
        want = ts.tree_shap_replay_plain(plan, Xd, 0.5, 0.25)
        torch.cuda.synchronize()
    assert shap_cuda.launches == before + 1
    assert _same(got.cpu(), want.cpu())


@pytest.mark.cuda
def test_kernel_rows_not_a_multiple_of_a_warp(dev):
    """37 rows over 3 trees: a flat (tree, row) grid would put rows of two
    trees into one warp."""
    rng = np.random.default_rng(310)
    parts = _random_heaps(rng, 3, 7, 4)
    X = _rows(rng, 37, 4, parts[1])
    forest, cov = _port(*parts, device=dev)
    got = ts.compute_contributions(forest, cov, torch.from_numpy(X).to(dev),
                                   1.0, 0.0)
    fc, cc = _port(*parts)
    want = ts.compute_contributions(fc, cc, torch.from_numpy(X), 1.0, 0.0)
    assert _same(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_takes_a_kept_plan(dev):
    """A plan built once and passed in gives the bits of one the call
    builds; a plan for another feature count is refused."""
    from h2o3_tpu_torch.ops import shap_cuda

    rng = np.random.default_rng(320)
    parts = _random_heaps(rng, 4, 8, 5, consistent=True)
    forest, cov = _port(*parts, device=dev)
    Xd = torch.from_numpy(_rows(rng, 200, 5, parts[1])).to(dev)
    plan = ts.build_shap_plan(forest, cov, 5)
    builds = ts.plan_builds
    kept = shap_cuda.tree_shap(forest, cov, Xd, 1.0, 0.5, plan=plan)
    assert ts.plan_builds == builds
    built = shap_cuda.tree_shap(forest, cov, Xd, 1.0, 0.5)
    assert ts.plan_builds == builds + 1
    assert _same(kept, built)
    with pytest.raises(ValueError, match="plan"):
        shap_cuda.tree_shap(forest, cov, Xd[:, :4].contiguous(), 1.0, 0.5,
                            plan=plan)


@pytest.mark.cuda
def test_model_keeps_its_plan_on_the_card(dev):
    """`predict_contributions` on the card builds the plan at its first
    call and none at the second; both equal the CPU model's bits."""
    from h2o3_tpu_torch import convert
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.ops import shap_cuda

    rng = np.random.default_rng(330)
    F = 4
    feat, thr, issp, val, cov = _random_heaps(rng, 5, 6, F, consistent=True)
    names = [f"f{i}" for i in range(F)]
    models = [convert.forest_from_numpy(
        feat=feat, bin=feat, thr=thr, is_split=issp, value=val, covers=cov,
        f0=0.25, edges=[np.zeros(1)] * F, max_depth=6, x=names, y="y",
        nbins=20, domain=["0", "1"], device=d) for d in (dev, "cpu")]
    fr = Frame.from_numpy(_rows(rng, 100, F), names=names)
    builds, launches = ts.plan_builds, shap_cuda.launches
    first = models[0].predict_contributions(fr)
    again = models[0].predict_contributions(fr)
    assert ts.plan_builds == builds + 1
    assert shap_cuda.launches == launches + 2
    want = models[1].predict_contributions(fr)
    for n in want.names:
        a, b = (np.asarray(c.vec(n).data) for c in (first, want))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(again.vec(n).data), b)


# A harness appended to the kernel's source, around its div_try: per law,
# random (a, b) pairs from an xorshift stream; counts accepted pairs,
# accepted pairs whose quotient differs from __ddiv_rn's (NaN against NaN
# counts as equal) and refused pairs.
_DIV_CHECK = r"""
__global__ void div_check(unsigned long long seed, int per_thread, int law,
                          unsigned long long* counts) {
  unsigned long long s =
      seed ^ (0x9E3779B97F4A7C15ull *
              (blockIdx.x * blockDim.x + threadIdx.x + 1));
  unsigned long long acc = 0, diff = 0, refused = 0;
  for (int k = 0; k < per_thread; ++k) {
    s ^= s << 13; s ^= s >> 7; s ^= s << 17; const unsigned long long u = s;
    s ^= s << 13; s ^= s >> 7; s ^= s << 17; const unsigned long long v = s;
    double a, b;
    if (law == 0) {         // any bit pattern, a quarter of dividends ±0
      a = __longlong_as_double((long long)u);
      b = __longlong_as_double((long long)v);
      if ((u & 7) == 0) a = 0.0;
      if ((u & 7) == 1) a = -0.0;
    } else if (law == 1) {  // finite positive, every exponent
      a = __longlong_as_double((long long)((u >> 2) & 0x7fefffffffffffffull));
      b = __longlong_as_double((long long)((v >> 2) & 0x7fefffffffffffffull));
    } else if (law == 2) {  // either sign, exponents within ±60
      a = __longlong_as_double((long long)((u & 0x800fffffffffffffull) |
          ((unsigned long long)(1023 + (int)((u >> 52) % 121) - 60) << 52)));
      b = __longlong_as_double((long long)((v & 0x800fffffffffffffull) |
          ((unsigned long long)(1023 + (int)((v >> 52) % 121) - 60) << 52)));
    } else {                // TreeSHAP's: weights over small divisors
      a = (double)(u >> 11) * 0x1.0p-53 * ldexp(1.0, -(int)(v & 63));
      b = (double)((v >> 9) % 40 + 1) *
          (((v >> 8) & 1) ? 1.0 : (double)(u & 0xfffff) * 0x1.0p-20);
    }
    bool ok;
    const double q = div_try(a, b, ok), w = __ddiv_rn(a, b);
    if (!ok) {
      ++refused;
    } else {
      ++acc;
      if (__double_as_longlong(q) != __double_as_longlong(w) &&
          !(isnan(q) && isnan(w)))
        ++diff;
    }
  }
  atomicAdd(&counts[0], acc);
  atomicAdd(&counts[1], diff);
  atomicAdd(&counts[2], refused);
}
extern "C" int h2o3_div_check(unsigned long long seed, int blocks,
                              int per_thread, int law, void* counts) {
  div_check<<<blocks, 256>>>(seed, per_thread, law,
                             static_cast<unsigned long long*>(counts));
  return (int)cudaDeviceSynchronize();
}
"""


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["any_bits", "every_exponent", "moderate",
                                 "shap_like"])
def test_div_try_equals_ddiv_rn(dev, law):
    """The kernel's branch-free division (div.rn's fast path and its
    acceptance test) gives __ddiv_rn's bits wherever it accepts, on 2^28
    random pairs a law, and accepts nearly all pairs of finite moderate
    operands."""
    import ctypes

    from h2o3_tpu_torch.ops import hist_cuda, shap_cuda

    src = hist_cuda.BUILD_DIR / "tree_shap_div_check.cu"
    hist_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(shap_cuda.SOURCE.read_text() + _DIV_CHECK)
    lib, _ = hist_cuda.build_library(src, "h2o3divcheck")
    lib.h2o3_div_check.argtypes = [ctypes.c_ulonglong, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    index = ["any_bits", "every_exponent", "moderate", "shap_like"].index(law)
    assert lib.h2o3_div_check(1234 + index, 4096, 256, index,
                              counts.data_ptr()) == 0
    accepted, differing, refused = counts.tolist()
    assert accepted + refused == 4096 * 256 * 256
    assert differing == 0
    if law in ("moderate", "shap_like"):
        assert refused < 1e-5 * accepted


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
