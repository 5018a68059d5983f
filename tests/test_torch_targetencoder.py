"""TargetEncoder of the port (`h2o3_tpu_torch/models/targetencoder.py`)
against the reference's, on the CPU.

The same numpy-seeded frames (two categorical columns with NAs, one of
them wide; a binary and a real response; a 5-value fold column) go
through the JAX package on a one-device cloud and through the port with
`device="cpu"`:

- under `data_leakage_handling` "None", "LeaveOneOut" and "KFold" (with
  and without a `fold_column`), blending on and off: the tables (domains,
  sums, counts, out-of-fold tables, prior, fold assignment) bit for bit,
  and the `_te` columns of a training transform (noise 0.15, so the noise
  draws are held too) and of a plain one bit for bit;
- a level unseen in training, and NA, encode as the prior;
- an unknown `data_leakage_handling` spelling raises `ValueError` in the
  port (the reference encodes it as "None", ROADMAP §C);
- the MOJO payload member for member, each package's artifact scored by
  the other's scorer and equal to the model's plain transform, and
  `convert.targetencoder_from_numpy`.
"""

import numpy as np
import pytest

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.models.targetencoder import H2OTargetEncoderEstimator as RefTE
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import H2OTargetEncoderEstimator
from h2o3_tpu_torch.frame.frame import Frame

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

N = 3000
CASES = {
    "none": dict(data_leakage_handling="None"),
    "none_blend": dict(data_leakage_handling="None", blending=True,
                       inflection_point=3, smoothing=10),
    "loo": dict(data_leakage_handling="LeaveOneOut"),
    "loo_blend": dict(data_leakage_handling="LeaveOneOut", blending=True),
    "kfold": dict(data_leakage_handling="KFold"),
    "kfold_blend_col": dict(data_leakage_handling="KFold", blending=True,
                            inflection_point=3, smoothing=10,
                            fold_column="fold"),
    "kfold_col": dict(data_leakage_handling="KFold", fold_column="fold"),
}


def _data(n, seed, real=False):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, n)
    b = rng.zipf(1.6, n) % 150
    p = 1 / (1 + np.exp(-(a - 2.5) * 0.6 + (b % 7 - 3) * 0.3))
    d = {"a": np.asarray([f"a{v}" for v in a], dtype=object),
         "b": np.asarray([f"b{v}" for v in b], dtype=object),
         "num": rng.normal(size=n).astype(np.float32),
         "fold": rng.integers(0, 5, n).astype(np.float32)}
    d["a"][rng.random(n) < 0.05] = None
    d["b"][rng.random(n) < 0.03] = None
    if real:
        d["y"] = (p * 3 + rng.normal(size=n)).astype(np.float32)
    else:
        d["y"] = np.asarray(["no", "yes"], dtype=object)[
            (rng.random(n) < p).astype(int)]
    return d


def _frames(d):
    types = {"a": "enum", "b": "enum"}
    if d["y"].dtype == object:
        types["y"] = "enum"
    return (RefFrame.from_dict(d, column_types=types),
            Frame.from_dict(d, column_types=types))


def _fit(params, d):
    rf, pf = _frames(d)
    kw = dict(noise=0.15, seed=1234, **params)
    ref = RefTE(**kw)
    ref.train(x=["a", "b", "num"], y="y", training_frame=rf)
    port = H2OTargetEncoderEstimator(device="cpu", **kw)
    port.train(x=["a", "b", "num"], y="y", training_frame=pf)
    return ref.model, port.model, rf, pf


def _te(fr):
    return {n: np.asarray(fr.vec(n).data) for n in fr.names if n.endswith("_te")}


def _assert_tables(pm, rm):
    assert list(pm.encodings) == list(rm.encodings) == ["a", "b"]
    assert pm.prior == rm.prior
    for col in rm.encodings:
        rdom, rs, rc, rfold = rm.encodings[col]
        pdom, ps, pc, pfold = pm.encodings[col]
        assert pdom == rdom
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pc, rc)
        assert sorted(pfold) == sorted(rfold)
        for fid in rfold:
            np.testing.assert_array_equal(pfold[fid][0], rfold[fid][0])
            np.testing.assert_array_equal(pfold[fid][1], rfold[fid][1])
    if rm._fold_assign is None:
        assert pm._fold_assign is None
    else:
        np.testing.assert_array_equal(pm._fold_assign, rm._fold_assign)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("real", [False, True], ids=["binary", "real"])
def test_tables_and_transforms_bit_equal(cloud1, case, real):
    rm, pm, rf, pf = _fit(CASES[case], _data(N, 0, real))
    _assert_tables(pm, rm)
    for as_training in (True, False):
        got = _te(pm.transform(pf, as_training=as_training))
        want = _te(rm.transform(rf, as_training=as_training))
        assert list(got) == list(want) == ["a_te", "b_te"]
        for c in want:
            assert got[c].dtype == want[c].dtype == np.float32
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    # the noise draws: a training transform moves every row
    plain = _te(pm.transform(pf))["a_te"]
    noisy = _te(pm.transform(pf, as_training=True, noise=0.15))["a_te"]
    assert np.all(plain != noisy) or CASES[case]["data_leakage_handling"] != "None"


def test_unseen_level_gives_the_prior(cloud1):
    rm, pm, _, _ = _fit(CASES["none_blend"], _data(N, 0))
    d = _data(40, 5)
    d["a"][:5] = "a_never_seen"
    d["b"][5:9] = None
    rf, pf = _frames(d)
    got, want = _te(pm.transform(pf)), _te(rm.transform(rf))
    for c in want:
        np.testing.assert_array_equal(got[c], want[c])
    prior = np.float32(pm.prior)
    assert np.all(got["a_te"][:5] == prior)
    assert np.all(got["b_te"][5:9] == prior)


def test_unknown_spelling_raises(cloud1):
    d = _data(200, 0)
    rf, pf = _frames(d)
    # the reference encodes h2o-py's spelling silently as "None"
    ref = RefTE(data_leakage_handling="k_fold", seed=1)
    ref.train(x=["a"], y="y", training_frame=rf)
    assert ref.model.leakage == "k_fold" and ref.model._fold_assign is None
    with pytest.raises(ValueError, match="data_leakage_handling='k_fold'"):
        H2OTargetEncoderEstimator(device="cpu", data_leakage_handling="k_fold"
                                  ).train(x=["a"], y="y", training_frame=pf)


def test_mojo_and_convert(cloud1, tmp_path):
    rm, pm, rf, pf = _fit(CASES["kfold_blend_col"], _data(N, 0))
    pp = mojo.save_model(pm, str(tmp_path), "port_te.h2o3")
    rp = refmojo.save_model(rm, str(tmp_path), "ref_te.h2o3")
    pn, pmeta, parr = _members(pp)
    rn, rmeta, rarr = _members(rp)
    assert pn == rn and sorted(parr) == sorted(rarr)
    assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
        k: v for k, v in rmeta.items() if k != "model_id"}
    for k in rarr:
        np.testing.assert_array_equal(parr[k], rarr[k], err_msg=k)
    d = _data(500, 3)
    d["a"][:3] = "a_never_seen"
    rt, pt = _frames(d)
    want = _te(pm.transform(pt))
    for scored in (mojo.load_model(pp).predict(pt), mojo.load_model(rp).predict(pt),
                   mojo.load_model(pp).transform(pt),
                   refmojo.load_model(pp).predict(rt)):
        got = _te(scored)
        for c in want:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    carried = convert.targetencoder_from_numpy(
        encodings=rm.encodings, prior=rm.prior, blending=rm.blending,
        inflection_point=rm.k, smoothing=rm.f, noise=rm.noise,
        data_leakage_handling=rm.leakage, fold_assign=rm._fold_assign,
        seed=rm.seed, x=rm.x, y=rm.y, device="cpu")
    for as_training in (True, False):
        got = _te(carried.transform(pf, as_training=as_training))
        want = _te(rm.transform(rf, as_training=as_training))
        for c in want:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
