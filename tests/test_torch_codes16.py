"""16-bit bin codes through the port's tree path, against the JAX package.

Past 256 bins `build_bins` makes uint16 codes: a categorical of 256 or
more levels (nbins = max(nbins + 1, min(levels + 1, 1024))) or `nbins` set
to 256 or more. The port ships them to the device as int16
(`packing.device_codes`, the same bits) and both histogram kernels take
them; on the CPU the plain twins run. Here the same seeded frames go
through both packages on the CPU:

* binning: the codes byte-identical at 301 and 1024 bins (a 300-level and
  a 1,200-level enum, a numeric at nbins=300), the 1,200-level enum's
  levels past the cap clipped into the last value bin as the reference
  does;
* histograms: `hist_plain` on int16 codes against the reference's
  `_hist_segment`, `hist_plain_fixed` against an f64 sum;
* fits: GBM and DRF (``hist_method="pallas"``, `hist_plain_rows` on the
  CPU) on a 300-level enum with binary labels, a multinomial GBM, GBM and
  DRF on the 1,200-level enum at the cap; the forest structure equal node
  for node, leaf values and predictions within 1e-5;
* a 5-fold CV on the fold-reuse path (holdouts walk int16 codes), a MOJO
  round trip and `predict_contributions` on a carried-across forest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from h2o3_tpu.frame.binning import build_bins as ref_build_bins
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.frame.vec import Vec as RefVec
from h2o3_tpu.models.drf import H2ORandomForestEstimator as RefDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as RefGBM
from h2o3_tpu.ops.histogram import _hist_segment
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.frame.binning import build_bins
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models import tree as treelib
from h2o3_tpu_torch.ops import hist_cuda, histogram, packing

TOL = 1e-5


def enum_data(n, levels, seed, classes=2):
    """(enum codes, numeric column, label codes): a `levels`-level enum
    whose levels at or past 256 carry the signal, and a label of `classes`
    levels from a logistic (or softmax) model in both."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, levels, n)
    x = rng.normal(size=n).astype(np.float32)
    if classes == 2:
        logit = 1.5 * (cat >= 256) - 0.8 * (cat % 7 == 0) + x
        y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(int)
    else:
        score = np.stack([1.5 * (cat >= 256), x, 0.8 * (cat % 5 == 0)], 1)
        y = np.argmax(score + rng.gumbel(size=(n, 3)), axis=1)
    return cat, x, y


def frame_pair(n, levels, seed, classes=2):
    """The same frame in both packages, the enum's domain every one of its
    `levels` levels (so nbins = min(levels + 1, 1024), whichever levels a
    frame holds, and test frames share the training codes)."""
    cat, x, y = enum_data(n, levels, seed, classes)
    width = len(str(levels - 1))
    out = []
    for frame_cls, vec_cls in ((RefFrame, RefVec), (Frame, Vec)):
        out.append(frame_cls({
            "cat": vec_cls(cat, "enum", domain=[
                f"L{i:0{width}d}" for i in range(levels)]),
            "x": vec_cls(x),
            "y": vec_cls(y, "enum", domain=[f"Y{k}" for k in range(classes)])}))
    return out


# case -> (algo, levels, classes, rows, parameters); one reference fit each
CASES = {
    # min_rows 20: at the default 10, tree 0 splits a 43-row node whose best
    # enum and numeric splits tie exactly in real arithmetic (the same left
    # rows and positives, binary labels), and f32 sums in another order
    # break that tie either way (ROADMAP §C, near-ties)
    "gbm": ("gbm", 300, 2, 2000, dict(ntrees=3, max_depth=4, min_rows=20)),
    # nbins=300 bins the numeric into 300 value bins too
    "drf_nbins300": ("drf", 300, 2, 2000, dict(ntrees=3, max_depth=6,
                                               nbins=300)),
    "gbm_multinomial": ("gbm", 300, 3, 2000, dict(ntrees=2, max_depth=3)),
    "gbm_cap": ("gbm", 1200, 2, 3000, dict(ntrees=3, max_depth=4)),
    "drf_cap": ("drf", 1200, 2, 3000, dict(ntrees=3, max_depth=5)),
}
CV_PARAMS = dict(ntrees=2, max_depth=3, nfolds=5, fold_assignment="Modulo")
ESTIMATORS = {"gbm": (RefGBM, H2OGradientBoostingEstimator),
              "drf": (RefDRF, H2ORandomForestEstimator)}


@pytest.fixture(scope="module")
def fits():
    out = {}
    mesh.init(jax.devices()[:1])
    try:
        for case, (algo, levels, classes, n, params) in CASES.items():
            rf, pf = frame_pair(n, levels, levels + classes, classes)
            ref_cls, port_cls = ESTIMATORS[algo]
            ref = ref_cls(seed=42, **params)
            ref.train(y="y", training_frame=rf)
            port_kw = dict(hist_method="pallas") if algo == "drf" else {}
            port = port_cls(seed=42, device="cpu", **params, **port_kw)
            histogram.DISPATCH.clear()
            port.train(y="y", training_frame=pf)
            rt, pt = frame_pair(500, levels, 1, classes)
            out[case] = dict(ref=ref.model, port=port.model, rt=rt, pt=pt,
                             dispatch=dict(histogram.DISPATCH))
        rf, pf = frame_pair(2000, 300, 3)
        ref = RefGBM(seed=7, **CV_PARAMS)
        ref.train(y="y", training_frame=rf)
        port = H2OGradientBoostingEstimator(seed=7, device="cpu", **CV_PARAMS)
        port.train(y="y", training_frame=pf)
        out["cv"] = dict(ref=ref.model, port=port.model)
    finally:
        mesh.reset()
    return out


@pytest.mark.parametrize("kind", ["enum300", "enum1200", "numeric300"])
def test_build_bins_codes_equal_the_reference(kind):
    rng = np.random.default_rng(5)
    if kind == "numeric300":
        X = rng.normal(size=(3000, 2))
        X[::17, 1] = np.nan
        is_cat, nbins = np.zeros(2, bool), 301
    else:
        levels = 300 if kind == "enum300" else 1200
        X = np.column_stack([rng.integers(0, levels, 3000).astype(float),
                             rng.normal(size=3000)])
        X[::23, 0] = np.nan
        is_cat, nbins = np.array([True, False]), min(levels + 1, 1024)
    got = build_bins(X, nbins=nbins, is_categorical=is_cat)
    ref = ref_build_bins(X, nbins=nbins, is_categorical=is_cat)
    assert got.codes.dtype == np.uint16 == ref.codes.dtype
    assert got.codes.tobytes() == np.asarray(ref.codes).tobytes()
    for a, b in zip(got.edges, ref.edges):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    na_col = 1 if kind == "numeric300" else 0
    assert int(got.codes[:, na_col].max()) == nbins - 1       # the NA bin
    if kind == "enum1200":
        # the 1024 cap: levels 1022..1199 share the last value bin
        col = X[:, 0]
        past = ~np.isnan(col) & (col >= 1022)
        assert past.sum() > 100
        assert (got.codes[past, 0] == 1022).all()
        assert got.codes[~np.isnan(col), 0].max() == 1022


def test_device_codes_keep_the_bits():
    c16 = np.array([[0, 255], [256, 1023]], np.uint16)
    d = packing.device_codes(c16)
    assert d.dtype == np.int16 and d.view(np.uint16).tobytes() == c16.tobytes()
    assert (d.astype(np.int64) == c16.astype(np.int64)).all()
    c8 = np.array([[3, 200]], np.uint8)
    assert packing.device_codes(c8) is c8
    with pytest.raises(TypeError):
        packing.device_codes(c16.astype(np.int32))
    assert packing.pack_bits_for(301, 2000) == 0


def _hist_inputs(nbins, seed):
    rng = np.random.default_rng(seed)
    N, F, L = 3000, 3, 4
    codes = rng.integers(0, nbins, (N, F)).astype(np.uint16)
    codes[::5, 1] = nbins - 1
    node = rng.integers(0, L, N).astype(np.int32)
    w = (rng.random(N) < 0.7).astype(np.float32)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    return codes, node, np.stack([w, g * w, h * w]), L


@pytest.mark.parametrize("nbins", [301, 1024])
def test_hist_plain_on_int16_codes_matches_segment(nbins):
    codes, node, vals, L = _hist_inputs(nbins, nbins)
    cd = torch.from_numpy(packing.device_codes(codes))
    got = hist_cuda.hist_plain(cd.t().contiguous(), torch.from_numpy(node),
                               torch.from_numpy(vals), L, nbins)
    rows = hist_cuda.hist_plain_rows(cd, torch.from_numpy(node),
                                     torch.from_numpy(vals), L, nbins)
    ref = np.asarray(_hist_segment(jnp.asarray(codes), jnp.asarray(node),
                                   jnp.asarray(vals), L, nbins))
    assert got.shape == (L, 3, nbins, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())
    assert torch.equal(rows, got)
    # every bin, the last ones included, holds its rows
    assert float(got[..., 0].sum()) == float(vals[0].sum()) * 3


@pytest.mark.parametrize("nbins", [301, 1024])
def test_hist_plain_fixed_on_int16_codes_vs_f64(nbins):
    codes, node, vals, L = _hist_inputs(nbins, nbins + 1)
    cfm = torch.from_numpy(packing.device_codes(codes)).t().contiguous()
    nd, vt = torch.from_numpy(node), torch.from_numpy(vals)
    fixed = hist_cuda.hist_plain_fixed(cfm, nd, vt, L, nbins)
    f32 = hist_cuda.hist_plain(cfm, nd, vt, L, nbins)
    f64 = hist_cuda.hist_plain(cfm, nd, vt, L, nbins, torch.float64)
    err = (fixed.double() - f64).abs().reshape(-1, 3).amax(0)
    err_f32 = (f32.double() - f64).abs().reshape(-1, 3).amax(0)
    assert (err <= err_f32).all(), (err, err_f32)
    # B1's wrapper on the CPU is its plain twin, int16 codes as they are
    assert torch.equal(hist_cuda.hist_build(cfm, nd, vt, L, nbins), f32)


def test_kernels_take_int16_up_to_1024_bins():
    """What `hist_build` and `hist_build_rows` check before a launch:
    uint8 codes up to 256 bins, int16 up to 1024, nothing else."""
    node = torch.zeros(16, dtype=torch.int32)
    vals = torch.ones((3, 16))
    ok = [(torch.uint8, 256), (torch.int16, 21), (torch.int16, 1024)]
    for dt, nbins in ok:
        hist_cuda._check_inputs("k", torch.zeros((16, 2), dtype=dt), node,
                                vals, 16, nbins)
    for dt in (torch.int32, torch.float32, torch.uint16):
        with pytest.raises(TypeError):
            hist_cuda._check_inputs("k", torch.zeros((16, 2), dtype=dt),
                                    node, vals, 16, 21)
    for dt, nbins in [(torch.uint8, 257), (torch.int16, 1025)]:
        with pytest.raises(ValueError):
            hist_cuda._check_inputs("k", torch.zeros((16, 2), dtype=dt),
                                    node, vals, 16, nbins)


def test_fit_past_1024_bins_raises():
    """A user's nbins of 1024 or more passes the categorical cap; the port
    raises there (the reference fits it on uint16 codes)."""
    rf, pf = frame_pair(200, 3, 0)
    est = H2OGradientBoostingEstimator(ntrees=1, max_depth=2, nbins=1500,
                                       device="cpu")
    with pytest.raises(ValueError, match="at most 1024"):
        est.train(y="y", training_frame=pf)


def test_plans_at_wide_bins():
    """B1's plan counts staged codes at their width; at B = 1024 it falls to
    node slices of 8 whose list words stay below 2^31. B2's plan stages no
    codes: at B = 1024 and F = 28 it takes one node and 18 features a
    block."""
    for nbins in (301, 1024):
        for L in (1, 64, 4096):
            p1 = hist_cuda.block_plan(L, nbins, 8, 1_000_000, 132, 1)
            p2 = hist_cuda.block_plan(L, nbins, 8, 1_000_000, 132, 2)
            for p in (p1, p2):
                assert p.smem <= hist_cuda.SMEM_MAX and p.tile_rows % 16 == 0
                slab = p.nodes_per_block * p.feats_per_block * nbins * 6
                assert slab < 2 ** 19
            if (p1.feats_per_block, p1.nodes_per_block, p1.tile_rows) == (
                    p2.feats_per_block, p2.nodes_per_block, p2.tile_rows):
                # the same split: the staged codes take twice the bytes
                assert p2.smem - p1.smem == p1.feats_per_block * p1.tile_rows
    deep = hist_cuda.block_plan(4096, 1024, 8, 1_000_000, 132, 2)
    assert (deep.nodes_per_block, deep.grid[2], deep.threads) == (8, 512, 1024)
    rp = hist_cuda.rows_plan(64, 1024, 28, 1_000_000)
    assert (rp.group_nodes, rp.feats_per_block, rp.grid[1]) == (1, 18, 2)
    assert rp.smem <= hist_cuda.SMEM_MAX
    assert hist_cuda.rows_plan(64, 301, 8, 1_000_000).group_nodes == 8


def test_code_walks_on_int16_equal_int64():
    """The row partition's `_row_code` and `predict_codes` on int16 codes."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 1024, (500, 3)).astype(np.uint16)
    c16 = torch.from_numpy(packing.device_codes(codes))
    c64 = torch.from_numpy(codes.astype(np.int64))
    rf = torch.from_numpy(rng.integers(0, 3, 500).astype(np.int32))
    assert torch.equal(treelib._row_code(c16, rf, 0),
                       treelib._row_code(c64, rf, 0))
    T = treelib.heap_size(2)
    tree = treelib.Tree(
        feat=torch.tensor([0, 1, 2] + [0] * 4, dtype=torch.int32),
        bin=torch.tensor([300, 700, 255] + [0] * 4, dtype=torch.int32),
        thr=torch.zeros(T), is_split=torch.tensor([True] * 3 + [False] * 4),
        value=torch.arange(T, dtype=torch.float32))
    assert torch.equal(treelib.predict_codes(tree, c16, 2),
                       treelib.predict_codes(tree, c64, 2))


@pytest.mark.parametrize("case", list(CASES))
def test_forest_structure_matches(fits, case):
    ref, port = fits[case]["ref"], fits[case]["port"]
    levels = CASES[case][1]
    assert port.bm.nbins == ref.bm.nbins == min(levels + 1, 1024)
    assert port.bm.codes.tobytes() == np.asarray(ref.bm.codes).tobytes()
    assert len(port.forest) == len(ref.forest)
    wide = 0
    for pt, rt in zip(port.forest, ref.forest):
        for f in ("feat", "bin", "is_split"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          np.asarray(getattr(rt, f)),
                                          err_msg=f)
        np.testing.assert_allclose(pt.value.numpy(), np.asarray(rt.value),
                                   rtol=0, atol=TOL)
        on_cat = pt.is_split & (pt.feat == 0)
        wide += int((on_cat & (pt.bin >= 255)).sum())
    # the enum's levels past 255 carry the signal: some split reaches them
    assert wide > 0
    if CASES[case][0] == "drf":
        assert set(fits[case]["dispatch"]) == {"pallas"}


@pytest.mark.parametrize("case", list(CASES))
def test_predictions_match(fits, case):
    f = fits[case]
    pr, pp = f["ref"], f["port"]
    a, b = pr.predict(f["rt"]), pp.predict(f["pt"])
    assert a.names == b.names
    for c in b.names[1:]:
        np.testing.assert_allclose(np.asarray(b.vec(c).data, np.float64),
                                   np.asarray(a.vec(c).data, np.float64),
                                   rtol=0, atol=TOL)


def test_cv_fold_reuse_holdouts_match(fits):
    ref, port = fits["cv"]["ref"], fits["cv"]["port"]
    assert port.bm.codes.dtype == np.uint16
    assert len(port.cross_validation_models) == 5
    for rm, pm in zip(ref.cross_validation_models,
                      port.cross_validation_models):
        for f in ("feat", "bin", "is_split"):
            np.testing.assert_array_equal(getattr(pm.forest[0], f).numpy(),
                                          np.asarray(getattr(rm.forest[0], f)))
    np.testing.assert_allclose(port._cv_holdout_pred, ref._cv_holdout_pred,
                               rtol=0, atol=TOL)
    assert abs(port.auc(xval=True) - ref.auc(xval=True)) <= TOL


@pytest.mark.parametrize("case", ["gbm", "gbm_cap"])
def test_mojo_round_trip(fits, tmp_path, case):
    """A model fit at 301 and at 1024 bins exports and scores with the
    numpy scorer: the payload holds split bins as int32 and thresholds,
    whatever the code width."""
    f = fits[case]
    path = mojo.save_model(f["port"], str(tmp_path), "wide.h2o3")
    loaded = mojo.load_model(path)
    a = np.asarray(loaded.predict(f["pt"]).vec("Y1").data, np.float64)
    b = np.asarray(f["port"].predict(f["pt"]).vec("Y1").data, np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert int(f["port"].forest[0].bin.max()) >= 256


def test_contributions_match_the_reference(fits):
    """The reference's forest carried across: both packages explain the
    same trees, within 1e-12."""
    f = fits["gbm"]
    m = f["ref"]
    carried = convert.forest_from_numpy(
        **{k: np.asarray(getattr(m.forest[0], k))
           for k in ("feat", "bin", "thr", "is_split", "value")},
        covers=np.asarray(m.covers[0]), f0=m.f0, edges=m.bm.edges,
        max_depth=m.max_depth, x=m.x, y=m.y, nbins=m.bm.nbins,
        domain=m.domain, problem=m.problem, distribution=m.distribution,
        mode=m.mode, device="cpu")
    a = m.predict_contributions(f["rt"])
    b = carried.predict_contributions(f["pt"])
    assert a.names == b.names
    for c in b.names:
        np.testing.assert_allclose(np.asarray(b.vec(c).data, np.float64),
                                   np.asarray(a.vec(c).data, np.float64),
                                   rtol=0, atol=1e-12)
