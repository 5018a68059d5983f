"""The forest kernels' packed score table, launch plans and plain twin.

On the CPU: the packed table (`score_cuda.build_score_pack`) decodes back
to the `Tree` fields; `tree.predict_forest_ordered` (the per-tree leaf
values added in tree order, the kernels' order) agrees with the
reference's fused scorer (`predict_forest_fused` over
`build_score_table_jit`) and with the port's `predict_forest_raw`; the plan
selector puts the GBM's shape on the resident plan and the DRF's on the
streamed one; a model builds its table once and the memory ledger counts
it; a model on the CPU builds none.

On the card (`cuda` cases): each plan, forced in turn, equals
`predict_forest_ordered` bit for bit on random forests of depth 0 to 19,
F = 1 and 28, ragged row counts, one tree, out-of-range features and NaNs;
a model on the card builds its table at its first `predict` and keeps it;
and the wrapper refuses what it does not take. They import no `jax`:

    python -m pytest --noconftest tests/test_torch_score_pack.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.models import tree as treelib
from h2o3_tpu_torch.ops import hist_cuda, score_cuda
from h2o3_tpu_torch.runtime import memory_ledger

from test_torch_score import _port_tree, _random_forest, _reference_fused, _rows


def _wild_forest(rng, nt, depth, F, frac_leaf=0.15):
    """`_random_forest` with a tenth of the feature indices out of [0, F)
    (negative or ≥ F), which the scorers clamp into it."""
    feat, thr, issp, val = _random_forest(rng, nt, depth, F, frac_leaf)
    wild = rng.random(feat.shape) < 0.1
    feat[wild] = rng.integers(-5, F + 5, size=int(wild.sum()))
    return feat, thr, issp, val


def test_pack_decodes_to_tree_fields():
    rng = np.random.default_rng(0)
    F = 5
    feat, thr, issp, val = _wild_forest(rng, nt=7, depth=6, F=F)
    forest = _port_tree(feat, thr, issp, val)
    before = score_cuda.pack_builds
    pack = score_cuda.build_score_pack(forest, F)
    assert score_cuda.pack_builds == before + 1
    assert pack.forest is forest and pack.n_feat == F
    nodes = pack.nodes.numpy()
    assert nodes.shape == feat.shape + (2,) and nodes.dtype == np.int32
    np.testing.assert_array_equal(
        nodes[..., 1], np.where(issp, np.clip(feat, 0, F - 1), -1))
    np.testing.assert_array_equal(nodes[..., 0], thr.view(np.int32))
    assert pack.nodes.numel() * pack.nodes.element_size() == 8 * feat.size


@pytest.mark.parametrize("depth", [0, 1, 6, 11])
def test_ordered_matches_reference_fused(depth):
    rng = np.random.default_rng(40 + depth)
    F = 7
    parts = _random_forest(rng, nt=6, depth=depth, F=F)
    X = _rows(rng, 257, F)
    ref = _reference_fused(*parts, X, depth)
    got = treelib.predict_forest_ordered(_port_tree(*parts),
                                         torch.from_numpy(X), depth).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("depth", [0, 3, 8])
def test_ordered_is_the_walk_summed_in_order(depth):
    """The same leaves as `predict_forest_raw`; only the order of the f32
    adds differs, so within 1e-6 of the sum's size; and exactly the
    in-order sum of the walk's per-tree values."""
    rng = np.random.default_rng(60 + depth)
    F = 4
    parts = _random_forest(rng, nt=23, depth=depth, F=F)
    forest = _port_tree(*parts)
    X = torch.from_numpy(_rows(rng, 300, F))
    got = treelib.predict_forest_ordered(forest, X, depth)
    raw = treelib.predict_forest_raw(forest, X, depth)
    tol = 1e-6 * torch.clamp(raw.abs(), min=1.0)
    assert bool(((got - raw).abs() <= tol).all())
    acc = torch.zeros(X.shape[0])
    for t in range(parts[0].shape[0]):
        one = treelib.Tree(*(f[t:t + 1] for f in forest))
        acc = acc + treelib.predict_forest_raw(one, X, depth)
    assert torch.equal(got, acc)


def test_ordered_clamps_features_into_range():
    """A feature index outside [0, F) reads the nearest column, as the
    kernels' table holds it: the same sums as the forest with its indices
    clipped, whose walk needs no clamping."""
    rng = np.random.default_rng(5)
    F = 3
    feat, thr, issp, val = _wild_forest(rng, nt=5, depth=4, F=F)
    assert ((feat < 0) | (feat >= F)).any()
    X = torch.from_numpy(_rows(rng, 200, F))
    got = treelib.predict_forest_ordered(_port_tree(feat, thr, issp, val), X, 4)
    clipped = _port_tree(np.clip(feat, 0, F - 1), thr, issp, val)
    assert torch.equal(got, treelib.predict_forest_ordered(clipped, X, 4))
    raw = treelib.predict_forest_raw(clipped, X, 4)
    assert bool(((got - raw).abs() <= 1e-6 * raw.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("rows", [64, 512, 100_000, 1_000_000])
def test_plan_selector(rows):
    """GBM (20 trees, depth 6, 127 nodes a tree) → resident; DRF (50 trees,
    depth 19, 2^20 − 1 nodes) → streamed; every plan fits shared memory
    and covers every row and tree."""
    gbm = score_cuda.score_plan(20, 6, 28, rows)
    assert gbm.kind == "resident" and gbm.stage_x
    assert score_cuda.resident_bytes(20, 6) == 20_240
    assert gbm.smem <= hist_cuda.SMEM_MAX
    assert 1 <= gbm.grid <= -(-rows // score_cuda.THREADS)
    drf = score_cuda.score_plan(50, 19, 28, rows)
    assert drf.kind == "streamed" and drf.stage_x
    assert drf.chunk == score_cuda.STREAM_CHUNK
    assert drf.smem <= hist_cuda.SMEM_MAX
    assert drf.row_blocks * drf.rows_per_block >= rows
    assert (drf.row_blocks - 1) * drf.rows_per_block < rows
    assert drf.grid == -(-50 // drf.chunk) * drf.row_blocks
    assert score_cuda.score_plan(50, 19, 28, rows) == drf


def test_plan_edges():
    # a forest at the resident budget stays resident; one more tree streams
    nt = score_cuda.RESIDENT_BYTES // score_cuda.resident_bytes(1, 8)
    assert score_cuda.score_plan(nt, 8, 28, 1000).kind == "resident"
    assert score_cuda.score_plan(nt + 1, 8, 28, 1000).kind == "streamed"
    # rows too wide for a tile are read from global memory
    wide = score_cuda.score_plan(20, 6, 2000, 1000)
    assert wide.kind == "resident" and not wide.stage_x
    assert wide.smem == score_cuda.resident_bytes(20, 6)
    with pytest.raises(ValueError, match="shared memory"):
        score_cuda.score_plan(50, 19, 28, 1000, kind="resident")
    with pytest.raises(ValueError, match="unknown"):
        score_cuda.score_plan(50, 19, 28, 1000, kind="warp")


@pytest.fixture(scope="module")
def cpu_gbm():
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    from test_torch_gbm import make_higgs_like

    X, y = make_higgs_like(1500, n_feat=6, seed=3)
    names = [f"f{i}" for i in range(6)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    est = H2OGradientBoostingEstimator(ntrees=4, max_depth=3, seed=42,
                                       device="cpu")
    est.train(y="label", training_frame=fr)
    return est.model, fr


def test_model_builds_its_table_once(cpu_gbm):
    """The table a model keeps for the card: built at the first call, then
    the same one; the memory ledger grows by its bytes."""
    model, _ = cpu_gbm
    model.__dict__.pop("_score_tables", None)
    host0, dev0 = memory_ledger.measure(model)
    before = score_cuda.pack_builds
    pack = model._score_table(0, len(model.x))
    assert model._score_table(0, len(model.x)) is pack
    assert score_cuda.pack_builds == before + 1
    assert model._score_tables == {0: pack}
    assert pack.forest is model.forest[0]
    assert pack.n_feat == len(model.x)
    host1, dev1 = memory_ledger.measure(model)
    nbytes = pack.nodes.numel() * pack.nodes.element_size()
    assert nbytes == 8 * model.forest[0].feat.numel()
    assert (host1 - host0, dev1 - dev0) == (nbytes, 0)
    model.__dict__.pop("_score_tables")


def test_cpu_model_builds_no_table(cpu_gbm):
    """On the CPU the plain walk scores and reads no table, so a model there
    builds none and the ledger does not grow."""
    model, fr = cpu_gbm
    model.__dict__.pop("_score_tables", None)
    before = score_cuda.pack_builds
    ledger0 = memory_ledger.measure(model)
    p1 = np.asarray(model.predict(fr).vec("1").data)
    p2 = np.asarray(model.predict(fr).vec("1").data)
    np.testing.assert_array_equal(p1, p2)
    assert score_cuda.pack_builds == before
    assert "_score_tables" not in model.__dict__
    assert memory_ledger.measure(model) == ledger0


def test_model_rebuilds_its_table_for_a_new_forest(cpu_gbm):
    model, _ = cpu_gbm
    F = len(model.x)
    old = model._score_table(0, F)
    model.forest = [treelib.Tree(*(f.clone() for f in model.forest[0]))]
    try:
        assert model._score_table(0, F) is not old
        assert model._score_tables[0].forest is model.forest[0]
        assert model._score_table(0, F + 1).n_feat == F + 1
    finally:
        model.forest = [old.forest]
        model.__dict__.pop("_score_tables", None)


# -- the plans on the card -----------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _plan_vs_ordered(dev, parts, X, depth, kind):
    forest = _port_tree(*parts, device=dev)
    Xd = torch.from_numpy(X).to(dev)
    counts = (score_cuda.launches, score_cuda.launches_resident,
              score_cuda.launches_streamed)
    got = score_cuda.forest_score(forest, Xd, depth, kind=kind)
    want = treelib.predict_forest_ordered(forest, Xd, depth)
    torch.cuda.synchronize()
    resident = kind == "resident"
    assert (score_cuda.launches, score_cuda.launches_resident,
            score_cuda.launches_streamed) == (
                counts[0] + 1, counts[1] + resident, counts[2] + (not resident))
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
def test_card_model_builds_its_table_once(dev):
    """A model on the card builds its table at its first `predict`, scores
    the second over the same one, and the ledger counts its device bytes."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    from test_torch_gbm import make_higgs_like

    X, y = make_higgs_like(1500, n_feat=6, seed=3)
    names = [f"f{i}" for i in range(6)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    est = H2OGradientBoostingEstimator(ntrees=4, max_depth=3, seed=42,
                                       device=str(dev))
    est.train(y="label", training_frame=fr)
    model = est.model
    model.__dict__.pop("_score_tables", None)
    host0, dev0 = memory_ledger.measure(model)
    before = score_cuda.pack_builds
    p1 = np.asarray(model.predict(fr).vec("1").data)
    pack = model._score_tables[0]
    p2 = np.asarray(model.predict(fr).vec("1").data)
    assert score_cuda.pack_builds == before + 1
    assert model._score_tables == {0: pack}
    assert pack.forest is model.forest[0]
    np.testing.assert_array_equal(p1, p2)
    host1, dev1 = memory_ledger.measure(model)
    nbytes = pack.nodes.numel() * pack.nodes.element_size()
    assert (host1 - host0, dev1 - dev0) == (0, nbytes)


# (depth, trees): a forced resident plan holds at most ~227 KB of forest
RESIDENT_CASES = [(0, 9), (1, 9), (6, 20), (11, 3)]
STREAMED_CASES = [(0, 9), (1, 9), (6, 20), (11, 9), (19, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 28])
@pytest.mark.parametrize("depth,nt", RESIDENT_CASES)
def test_resident_plan_equals_ordered(dev, depth, nt, F):
    rng = np.random.default_rng(1000 + 10 * depth + F)
    parts = _wild_forest(rng, nt, depth, F)
    _plan_vs_ordered(dev, parts, _rows(rng, 3001, F), depth, kind="resident")


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 28])
@pytest.mark.parametrize("depth,nt", STREAMED_CASES)
def test_streamed_plan_equals_ordered(dev, depth, nt, F):
    rng = np.random.default_rng(2000 + 10 * depth + F)
    parts = _wild_forest(rng, nt, depth, F, frac_leaf=0.05)
    _plan_vs_ordered(dev, parts, _rows(rng, 3001, F), depth, kind="streamed")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["resident", "streamed"])
@pytest.mark.parametrize("depth", [0, 6])
def test_one_tree(dev, kind, depth):
    rng = np.random.default_rng(3000 + depth)
    parts = _wild_forest(rng, 1, depth, 5)
    _plan_vs_ordered(dev, parts, _rows(rng, 700, 5), depth, kind=kind)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,rows", [(8, 2999), (8, 250_001), (14, 2999)])
def test_streamed_sizes(dev, depth, rows):
    """The streamed plan's own sizes: levels staged deeper than the forest
    (depth 8) and shallower (depth 14, the rest from global memory), row
    ranges of one tile and of several with a ragged last one, trees not a
    multiple of the chunk."""
    rng = np.random.default_rng(4000 + depth + rows % 7)
    plan = score_cuda.score_plan(7, depth, 28, rows, kind="streamed")
    assert plan.staged_levels == min(depth, score_cuda.STREAM_LEVELS)
    assert (plan.rows_per_block > score_cuda.THREADS) == (rows > 200_000)
    parts = _wild_forest(rng, 7, depth, 28, frac_leaf=0.05)
    _plan_vs_ordered(dev, parts, _rows(rng, rows, 28), depth, "streamed")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["resident", "streamed"])
def test_rows_read_from_global_memory(dev, kind):
    """Rows too wide for a tile in shared memory (F = 2000)."""
    rng = np.random.default_rng(5000)
    parts = _wild_forest(rng, 5, 5, 2000)
    plan = score_cuda.score_plan(5, 5, 2000, 600, kind=kind)
    assert not plan.stage_x
    _plan_vs_ordered(dev, parts, _rows(rng, 600, 2000), 5, kind)


@pytest.mark.cuda
def test_default_plans_on_the_smoke_shapes(dev):
    """The selector's own plans: resident for a 20-tree depth-6 forest,
    streamed for a 50-tree depth-12 one (its trees hold more than the
    resident budget)."""
    rng = np.random.default_rng(6000)
    for nt, depth, kind in ((20, 6, "resident"), (50, 12, "streamed")):
        parts = _wild_forest(rng, nt, depth, 28)
        forest = _port_tree(*parts, device=dev)
        X = torch.from_numpy(_rows(rng, 5000, 28)).to(dev)
        before = getattr(score_cuda, f"launches_{kind}")
        got = score_cuda.forest_score(forest, X, depth)
        assert getattr(score_cuda, f"launches_{kind}") == before + 1
        assert torch.equal(got, treelib.predict_forest_ordered(forest, X, depth))


@pytest.mark.cuda
def test_wrapper_rejects_what_it_does_not_take(dev):
    rng = np.random.default_rng(7)
    parts = _random_forest(rng, nt=2, depth=3, F=4)
    forest = _port_tree(*parts, device=dev)
    X = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)).to(dev)
    for kind in ("resident", "streamed"):
        with pytest.raises(ValueError, match="shallower"):
            score_cuda.forest_score(forest, X, 4, kind=kind)
        with pytest.raises(TypeError):
            score_cuda.forest_score(forest, X.double(), 3, kind=kind)
        with pytest.raises(ValueError, match="contiguous"):
            score_cuda.forest_score(forest, X.t().contiguous().t(), 3,
                                    kind=kind)
    other = _port_tree(*parts, device=dev)
    with pytest.raises(ValueError, match="another forest"):
        score_cuda.forest_score(forest, X, 3,
                                pack=score_cuda.build_score_pack(other, 4))
    with pytest.raises(ValueError, match="another forest"):
        score_cuda.forest_score(forest, X, 3,
                                pack=score_cuda.build_score_pack(forest, 3))
    with pytest.raises(ValueError, match="shared memory"):
        score_cuda.forest_score(_port_tree(*_random_forest(rng, 50, 12, 4),
                                           device=dev), X, 12, kind="resident")
    # more shared memory than a block may hold is refused by the card, and
    # the entry's code reaches the caller as a KernelError
    lib = score_cuda.build()
    pack = score_cuda.build_score_pack(forest, 4)
    out = torch.empty(8, device=dev)
    rc = lib.h2o3_forest_score_resident(
        pack.nodes.data_ptr(), forest.value.data_ptr(), X.data_ptr(),
        out.data_ptr(), 8, 4, 2, forest.feat.shape[1], 3, 1, 1,
        hist_cuda.SMEM_MAX + 1024, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(hist_cuda.KernelError):
        hist_cuda.check_launch(rc, "forest scoring kernel")
