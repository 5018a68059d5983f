"""`DataInfo` of the port against the reference's: the same frames (string
enum levels through `Frame.from_dict`, numeric columns with NaNs, integer
columns that ship as uint8 and int16) through both packages.

The host half is the reference's numpy code, so its products must be equal
to the bit: the column spec, `coef_names`, the standardization stats, the
imputation means, the transfer groups and `fit_transform`/`transform`. The
device design is held to the reference's XLA expansion (on the CPU) bit for
bit: both widen the same compact packs and compute (x − mean) / std in f32,
one operation per element, which XLA does not fuse into another rounding.
"""

import numpy as np
import pytest
import torch

import jax

from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models import estimator_engine as ref_est
from h2o3_tpu.models.model_base import DataInfo as RefDataInfo
from h2o3_tpu.parallel import mesh
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import estimator_engine as est
from h2o3_tpu_torch.models.model_base import SCORE_ROW_BUCKET, DataInfo


def frame_dict(n, seed, wide=False, shuffle_levels=False, unseen=False):
    """Columns: a normal with NaNs, an integer 0..200 (uint8), an integer
    -900..900 (int16), a constant-free float; enums with 4, 3 and 6 string
    levels, one with NAs. `wide` adds eight more numeric columns (the
    stacked pre-pass of `device_design` takes over above eight).
    `shuffle_levels` drops a level from one enum (another domain, so codes
    remap) and `unseen` adds a level the fit never saw."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    a[rng.random(n) < 0.05] = np.nan
    d = {"a": a,
         "small": rng.integers(0, 201, n).astype(np.float64),
         "mid": rng.integers(-900, 901, n).astype(np.float64),
         "f": rng.uniform(-3, 7, n)}
    if wide:
        for i in range(8):
            col = rng.normal(i, 1 + i, n)
            if i % 3 == 0:
                col[rng.random(n) < 0.02] = np.nan
            d[f"w{i}"] = col
    lv1 = np.asarray(["ORD", "JFK", "SFO", "ATL"], dtype=object)
    c1 = lv1[rng.integers(0, 4, n)]
    if shuffle_levels:
        c1[c1 == "ATL"] = "JFK"          # a domain without ATL
    if unseen:
        c1[::17] = "BOS"                 # a level the fit never saw
    c2 = np.asarray(["mon", "tue", "wed"], dtype=object)[rng.integers(0, 3, n)]
    c3 = np.asarray([f"L{i}" for i in range(6)], dtype=object)[
        rng.integers(0, 6, n)]
    c3[rng.random(n) < 0.03] = None      # NA codes (-1)
    d.update(c1=c1, c2=c2, c3=c3)
    return d


TYPES = {"c1": "enum", "c2": "enum", "c3": "enum"}


def frames(d):
    return (RefFrame.from_dict(d, column_types=TYPES),
            Frame.from_dict(d, column_types=TYPES))


def x_of(d):
    return list(d)


@pytest.fixture(scope="module", params=[(False, True, False),
                                        (True, True, False),
                                        (False, False, False),
                                        (False, True, True)],
                ids=["narrow", "wide", "unstandardized", "use_all"])
def fitted(request):
    wide, std, use_all = request.param
    d = frame_dict(1500, 0, wide=wide)
    rf, pf = frames(d)
    mesh.init(jax.devices()[:1])
    try:
        ref = RefDataInfo(rf, x_of(d), standardize=std,
                          use_all_factor_levels=use_all)
        port = DataInfo(pf, x_of(d), standardize=std,
                        use_all_factor_levels=use_all)
        ref_X = np.asarray(ref.device_design(rf, fit=True, add_intercept=True))
        port_X = port.device_design(pf, fit=True, add_intercept=True,
                                    device="cpu").numpy()
        test = frame_dict(700, 1, wide=wide, shuffle_levels=True, unseen=True)
        test["small"][::50] = 300.0         # no longer fits uint8
        rt, pt = frames(test)
        ref_T = np.asarray(ref.device_design(rt, fit=False, add_intercept=True,
                                             row_bucket=SCORE_ROW_BUCKET))
        port_T = port.device_design(pt, fit=False, add_intercept=True,
                                    row_bucket=SCORE_ROW_BUCKET,
                                    device="cpu").numpy()
    finally:
        mesh.reset()
    return dict(ref=ref, port=port, ref_X=ref_X, port_X=port_X, ref_T=ref_T,
                port_T=port_T, rf=rf, pf=pf, rt=rt, pt=pt, n_test=700,
                std=std)


def test_spec_and_coef_names_equal(fitted):
    ref, port = fitted["ref"], fitted["port"]
    assert port._spec == ref._spec
    assert port.coef_names == ref.coef_names
    assert port.x == ref.x and port.use_all == ref.use_all
    # domains are the sorted string levels, in both packages
    assert port._spec[-3][2] == ["ATL", "JFK", "ORD", "SFO"]


def test_stats_equal_to_the_bit(fitted):
    ref, port = fitted["ref"], fitted["port"]
    if fitted["std"]:
        assert port.means.dtype == ref.means.dtype == np.float64
        np.testing.assert_array_equal(port.means, ref.means)
        np.testing.assert_array_equal(port.stds, ref.stds)
    else:
        assert port.means is None and ref.means is None
    assert port.col_means == ref.col_means
    assert port._transfer_groups == ref._transfer_groups
    assert port._transfer_groups[:3] == [2, 0, 1]


def test_device_design_equal_to_the_bit(fitted):
    ref_X, port_X = fitted["ref_X"], fitted["port_X"]
    assert port_X.dtype == np.float32 and port_X.shape == ref_X.shape
    assert port_X.shape[1] == len(fitted["port"].coef_names) + 1
    np.testing.assert_array_equal(port_X, ref_X)
    assert np.all(port_X[:, -1] == 1.0)


def test_scoring_design_remaps_unseen_levels_and_pads(fitted):
    """A scoring frame with another domain, an unseen level, NaNs and a
    value past its uint8 group: the port pads to the same 512-row bucket
    and expands the same rows (the fallback all-f32 packs, remapped codes,
    an unseen level to zeros, NaN to the fit's mean)."""
    ref_T, port_T = fitted["ref_T"], fitted["port_T"]
    n = fitted["n_test"]
    assert port_T.shape == ref_T.shape == (1024, fitted["port_X"].shape[1])
    np.testing.assert_array_equal(port_T[:n], ref_T[:n])
    port, pt = fitted["port"], fitted["pt"]
    host = port.transform(pt)
    np.testing.assert_allclose(port_T[:n, :-1], host, rtol=0, atol=1e-5)


def test_fit_transform_and_transform_equal(fitted):
    d = frame_dict(400, 3)
    rf, pf = frames(d)
    for std in (True, False):
        ref = RefDataInfo(rf, x_of(d), standardize=std)
        port = DataInfo(pf, x_of(d), standardize=std)
        np.testing.assert_array_equal(port.fit_transform(pf),
                                      ref.fit_transform(rf))
        if std:
            np.testing.assert_array_equal(port.means, ref.means)
            np.testing.assert_array_equal(port.stds, ref.stds)
        np.testing.assert_array_equal(port.transform(fitted["pt"]),
                                      ref.transform(fitted["rt"]))


def test_from_state_rebuilds_the_same_design(fitted):
    ref, pt = fitted["ref"], fitted["pt"]
    clone = DataInfo.from_state(
        spec=ref._spec, coef_names=ref.coef_names,
        standardize=ref.standardize, use_all=ref.use_all, means=ref.means,
        stds=ref.stds, col_means=ref.col_means,
        transfer_groups=ref._transfer_groups)
    got = clone.device_design(pt, fit=False, add_intercept=True,
                              row_bucket=SCORE_ROW_BUCKET, device="cpu")
    np.testing.assert_array_equal(got.numpy(), fitted["port_T"])


def test_design_matrix_equals_the_reference_engine():
    d = frame_dict(900, 5)
    rf, pf = frames(d)
    mesh.init(jax.devices()[:1])
    try:
        rdi, rX = ref_est.design_matrix(rf, x_of(d), standardize=True,
                                        add_intercept=True)
        rX = np.asarray(rX)
    finally:
        mesh.reset()
    timings = {}
    pdi, pX = est.design_matrix(pf, x_of(d), standardize=True,
                                add_intercept=True, device="cpu",
                                timings=timings)
    np.testing.assert_array_equal(pX.numpy(), rX)
    assert pdi.coef_names == rdi.coef_names
    assert set(timings) == {"pack_s", "h2d_s", "expand_s"}


def test_shard_plan_equals_the_reference(monkeypatch):
    """The engine's lane decision is the reference's for one to four
    devices, one process or several, under every setting of the switches
    (H2O3_EST_SHARD unset, "0" and "1", a block count, the legacy
    switch); `local_plan` and `block_slices` cut the same grid."""
    from h2o3_tpu_torch.parallel import mesh

    for env, blocks, leg in ((None, None, None), ("0", None, None),
                             ("1", None, None), ("1", "6", None),
                             (None, "6", None), ("1", None, "1")):
        for k, v in (("H2O3_EST_SHARD", env),
                     ("H2O3_EST_SHARD_BLOCKS", blocks),
                     ("H2O3_EST_LEGACY", leg)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        assert est.shard_blocks() == ref_est.shard_blocks()
        for ndev in (1, 2, 3, 4):
            for mp in (False, True):
                plan = est.shard_plan(ndev, mp)
                assert plan == ref_est.shard_plan(ndev, mp), (env, ndev, mp)
                mode, s = plan
                cloud = mesh.Cloud(size=ndev)
                lb, axis = est.local_plan(cloud, mode, s)
                rlb, raxis = ref_est.local_plan(cloud, mode, s)
                assert (lb, axis) == (rlb, raxis)
                if lb:
                    npad = est.pad_rows(1000, s) // (ndev if mode == "mesh"
                                                     else 1)
                    assert est.block_slices(npad, lb) == \
                        ref_est.block_slices(npad, lb)


def test_engine_helpers_match_the_reference(monkeypatch):
    for n, s in ((0, 0), (7, 0), (7, 8), (16, 8), (1001, 3)):
        assert est.pad_rows(n, s) == ref_est.pad_rows(n, s)
    for env in ("", "1", "yes", "no"):
        monkeypatch.setenv("H2O3_EST_LEGACY", env)
        assert est.legacy() == ref_est.legacy()
    monkeypatch.delenv("H2O3_EST_LEGACY")
    assert est.shard_plan(1, False) == ref_est.shard_plan(1, False)


def test_expansion_on_device_tensors_keeps_the_device():
    """The expansion runs where its packs lie; on the CPU it is the plain
    torch version the card runs too."""
    from h2o3_tpu_torch.models.model_base import expand_design

    cats = torch.tensor([[0, 2], [1, -1], [2, 0]], dtype=torch.int32)
    n8 = torch.tensor([[3], [4], [5]], dtype=torch.uint8)
    n16 = torch.zeros((3, 0), dtype=torch.int16)
    n32 = torch.tensor([[float("nan")], [1.5], [2.0]])
    spec = (("num", 0), ("cat", 3), ("num", 2), ("cat", 3))
    X = expand_design(spec, False, False, True, n8, n16, n32, cats,
                      torch.zeros(0), torch.ones(0))
    want = torch.tensor([[3, 0, 0, 0, 0, 1, 1],
                         [4, 1, 0, 1.5, 0, 0, 1],
                         [5, 0, 1, 2, 0, 0, 1]], dtype=torch.float32)
    assert torch.equal(X, want)
