"""Aggregator and Word2Vec of the port against the reference's, on the CPU.

Aggregator (`h2o3_tpu_torch/models/aggregator.py`): the reference's block
pass computes distances as ‖a‖² − 2·a·eᵀ + ‖e‖² with XLA's matmul, the
port with torch's, and the two sum in other orders. So the fixtures are
separated blobs (sub-blobs inside blobs, placed to break symmetric ties)
and the test asserts that every distance the passes compare lies at least
AGG_MARGIN (relative) from the radius, and that no two exemplars within
the radius of a row lie within that margin of each other: f32 rounding
cannot move a decision there. Then the exemplar indices and counts are
equal, over one pass and over a bisection of two, and on 5,832 rows in 6
columns (two blocks, the exemplar buffer growing from 256 to 1024). Also
`target >= n`, the `ValueError` of `predict`, the export `TypeError`, the
unread parameters' raises and `convert.aggregator_from_numpy`.

Word2Vec (`h2o3_tpu_torch/models/word2vec.py`):

- the vocabulary equal to the reference model's, and `skipgram_pairs`
  byte-equal to the reference's pair loop (NA and out-of-vocabulary
  breaks, windows at the ends); `negative_draw` equal to `rng.choice`'s
  draws and leaving the generator in its state;
- the vectors after 3 steps within W2V_TOL = 1e-5 of the reference's
  (duplicate words in a batch add in another order than XLA's scatter);
- on `tests/test_longtail.py:41-61`'s corpus after the full fit, the
  top-3 `find_synonyms` of each word equal to the reference's;
- `transform` under "NONE" and "AVERAGE" of a carried reference model
  equal to the reference's bit for bit;
- the unread parameters raise;
- the MOJO payload member for member, loaded across both ways, its
  vectors, `find_synonyms` and `transform` equal to the model's.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu import mojo as refmojo
from h2o3_tpu.frame.frame import Frame as RefFrame
from h2o3_tpu.frame.vec import Vec as RefVec
from h2o3_tpu.models.aggregator import H2OAggregatorEstimator as RefAgg
from h2o3_tpu.models.word2vec import H2OWord2vecEstimator as RefW2V
from h2o3_tpu_torch import convert, mojo
from h2o3_tpu_torch.estimators import (H2OAggregatorEstimator,
                                       H2OWord2vecEstimator)
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import Vec
from h2o3_tpu_torch.models import aggregator as pagg
from h2o3_tpu_torch.models.model_base import DataInfo
from h2o3_tpu_torch.models.word2vec import negative_draw, skipgram_pairs

from test_torch_deeplearning import one_torch_thread  # noqa: F401
from test_torch_mojo import _members

AGG_MARGIN = 1e-2
W2V_TOL = 1e-5


# ---------------------------------------------------------------- Aggregator
def _blobs():
    """18 blobs on a 3×3×2 lattice, each of four tight sub-blobs at
    unequal offsets: 1,800 rows."""
    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(2),
                             indexing="ij"), -1).reshape(-1, 3) * 4.0
    offs = np.asarray([[0, 0, 0], [0.8, 0, 0], [0, 0.62, 0], [1.0, 0.9, 0.4]])
    X = np.concatenate([c + o + rng.normal(0, 0.01, size=(25, 3))
                        for c in g for o in offs])
    rng.shuffle(X)
    return X


def _lattice6():
    """729 blobs on a 3^6 lattice, 8 rows each: 5,832 rows."""
    rng = np.random.default_rng(1)
    g = np.stack(np.meshgrid(*[np.arange(3)] * 6, indexing="ij"),
                 -1).reshape(-1, 6).astype(np.float64)
    X = np.repeat(g, 8, axis=0) + rng.normal(0, 0.01, size=(len(g) * 8, 6))
    rng.shuffle(X)
    return X


def _margin(Xs, passes):
    """The smallest relative gap, over every pass, between the radius and
    a row's distance to an exemplar of that pass, and between two
    exemplars within the radius of one row (f64 distances)."""
    worst = np.inf
    A = Xs.astype(np.float64)
    for ps in passes:
        r2 = ps["radius2"]
        idx, _ = pagg.aggregate(torch.from_numpy(Xs), Xs, r2)
        E = A[idx]
        d2 = (A * A).sum(1)[:, None] - 2 * A @ E.T + (E * E).sum(1)[None, :]
        worst = min(worst, (np.abs(d2 - r2) / r2).min())
        within = np.sort(np.where(d2 <= r2, d2, np.inf), axis=1)
        with np.errstate(invalid="ignore"):
            gaps = np.diff(within, axis=1)
        gaps = gaps[np.isfinite(gaps)]
        if gaps.size:
            worst = min(worst, gaps.min() / r2)
    return worst


@pytest.mark.parametrize("fixture,target,tol,n_passes", [
    ("blobs", 30, 0.5, 1), ("blobs", 60, 0.2, 2), ("lattice6", 700, 0.2, 1)])
def test_aggregator_exemplars_equal(cloud1, fixture, target, tol, n_passes):
    X = _blobs() if fixture == "blobs" else _lattice6()
    names = [f"c{i}" for i in range(X.shape[1])]
    rf = RefFrame.from_numpy(X, names=names)
    pf = Frame.from_numpy(X, names=names)
    ref = RefAgg(target_num_exemplars=target, rel_tol_num_exemplars=tol)
    ref.train(x=names, training_frame=rf)
    port = H2OAggregatorEstimator(target_num_exemplars=target,
                                  rel_tol_num_exemplars=tol, device="cpu")
    port.train(x=names, training_frame=pf)
    pm, rm = port.model, ref.model
    assert len(pm.passes) == n_passes
    Xs = DataInfo(pf, names, standardize=True,
                  use_all_factor_levels=True).fit_transform(pf)
    assert _margin(Xs, pm.passes) > AGG_MARGIN
    np.testing.assert_array_equal(pm.exemplar_idx, rm.exemplar_idx)
    np.testing.assert_array_equal(pm.counts, rm.counts)
    assert pm.counts.sum() == len(X)
    agg, ragg = pm.aggregated_frame, rm.aggregated_frame
    assert agg.names == ragg.names == names + ["counts"]
    for n in agg.names:
        np.testing.assert_array_equal(agg.vec(n).numeric_np(),
                                      ragg.vec(n).numeric_np())
    if fixture == "lattice6":
        assert len(pm.exemplar_idx) > 512     # the buffer grew twice


def test_aggregator_edges_and_raises(cloud1, tmp_path):
    X = _blobs()[:50]
    names = ["a", "b", "c"]
    rf = RefFrame.from_numpy(X, names=names)
    pf = Frame.from_numpy(X, names=names)
    ref = RefAgg(target_num_exemplars=100)
    ref.train(x=names, training_frame=rf)
    port = H2OAggregatorEstimator(target_num_exemplars=100, device="cpu")
    port.train(x=names, training_frame=pf)
    np.testing.assert_array_equal(port.model.exemplar_idx, np.arange(50))
    np.testing.assert_array_equal(port.model.exemplar_idx,
                                  ref.model.exemplar_idx)
    np.testing.assert_array_equal(port.model.counts, ref.model.counts)
    with pytest.raises(ValueError, match="does not support predict"):
        port.model.predict(pf)
    with pytest.raises(TypeError, match="cannot export"):
        mojo.save_model(port.model, str(tmp_path), "agg.h2o3")
    with pytest.raises(TypeError, match="cannot export"):
        refmojo.save_model(ref.model, str(tmp_path), "ragg.h2o3")
    for bad in (dict(num_iteration_without_new_exemplar=10),
                dict(save_mapping_frame=True)):
        with pytest.raises(NotImplementedError,
                           match=f"{next(iter(bad))}.*item 10"):
            H2OAggregatorEstimator(device="cpu", **bad).train(
                x=names, training_frame=pf)
    carried = convert.aggregator_from_numpy(
        exemplar_idx=ref.model.exemplar_idx, counts=ref.model.counts,
        x=names, training_frame=pf)
    for n in names + ["counts"]:
        np.testing.assert_array_equal(
            carried.aggregated_frame.vec(n).numeric_np(),
            ref.model.aggregated_frame.vec(n).numeric_np())


# ------------------------------------------------------------------ Word2Vec
ANIMALS = ["cat", "dog", "mouse", "horse"]
FOODS = ["apple", "bread", "cheese", "pasta"]


def _corpus():
    """`tests/test_longtail.py:41-61`'s corpus: 400 four-word sentences of
    one topic each, NA between sentences."""
    rng = np.random.default_rng(2)
    sents = []
    for _ in range(400):
        group = ANIMALS if rng.random() < 0.5 else FOODS
        sents.extend(list(rng.choice(group, 4)) + [None])
    return np.asarray(sents, dtype=object)


def _mixed_corpus():
    """A corpus with rare words (below `min_word_freq`), NAs at both ends
    and runs longer than the window."""
    rng = np.random.default_rng(7)
    words = np.asarray([f"w{int(v)}" for v in rng.zipf(1.4, 1200) % 60],
                       dtype=object)
    words[rng.random(1200) < 0.06] = None
    words[0] = words[-1] = None
    return words


def Wc0(vocab, dim, seed):
    """The vectors before the first step, drawn as both packages draw them."""
    rng = np.random.default_rng(seed)
    return (rng.random((len(vocab), dim)).astype(np.float32) - 0.5) / dim


def _word_frames(words):
    return (RefFrame({"words": RefVec(None, "string", strings=words)}),
            Frame({"words": Vec(None, "string", strings=words)}))


def _ref_pairs(seq, window):
    """The reference's pair loop (`h2o3_tpu/models/word2vec.py:160-172`)."""
    centers, contexts = [], []
    for i in range(len(seq)):
        if seq[i] < 0:
            continue
        for d in range(1, window + 1):
            j = i + d
            if j >= len(seq) or seq[j] < 0:
                break
            centers.append(seq[i]); contexts.append(seq[j])
            centers.append(seq[j]); contexts.append(seq[i])
    return np.asarray(centers, np.int32), np.asarray(contexts, np.int32)


def _fit_w2v(words, **params):
    rf, pf = _word_frames(words)
    ref = RefW2V(**params)
    ref.train(training_frame=rf)
    port = H2OWord2vecEstimator(device="cpu", **params)
    port.train(training_frame=pf)
    return ref.model, port.model, rf, pf


def test_word2vec_vocab_pairs_and_three_steps(cloud1):
    words = _mixed_corpus()
    rm, pm, _, _ = _fit_w2v(words, vec_size=16, min_word_freq=5, epochs=3,
                            window_size=4, seed=11, init_learning_rate=20.0)
    assert pm.vocab == rm.vocab
    index = {w: i for i, w in enumerate(pm.vocab)}
    seq = np.asarray([index.get(w, -1) if w is not None else -1
                      for w in words], np.int64)
    assert (seq == -1).sum() > (np.asarray([w is None for w in words])).sum()
    for window in (1, 4, 7):
        c, o = skipgram_pairs(seq, window)
        rc, ro = _ref_pairs(seq, window)
        assert c.dtype == rc.dtype and c.tobytes() == rc.tobytes()
        assert o.dtype == ro.dtype and o.tobytes() == ro.tobytes()
    assert pm.fit_stats["steps"] == 3 and pm.fit_stats["pairs"] < 8192
    moved = np.abs(pm.vectors - Wc0(rm.vocab, 16, 11)).max()
    assert moved > 100 * W2V_TOL          # the steps moved the vectors
    np.testing.assert_allclose(pm.vectors, np.asarray(rm.vectors), rtol=0,
                               atol=W2V_TOL)


def test_negative_draw_equals_choice():
    """`negative_draw` gives `rng.choice(V, (B, neg), p=probs)`'s indices
    and leaves the generator where `choice` leaves it."""
    freq = np.random.default_rng(1).integers(5, 5000, 3000).astype(np.float64)
    probs = freq ** 0.75
    probs = probs / probs.sum()
    cdf = probs.cumsum()
    cdf /= cdf[-1]
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for B in (8192, 77):
        want = a.choice(len(probs), size=(B, 5), p=probs)
        got = negative_draw(b.random((B, 5)), torch.from_numpy(cdf))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    assert a.random() == b.random()


def test_word2vec_synonyms_and_transform(cloud1):
    words = _corpus()
    rm, pm, rf, pf = _fit_w2v(words, vec_size=16, min_word_freq=2, epochs=100,
                              window_size=3, seed=3, init_learning_rate=1.0)
    for w in ANIMALS + FOODS:
        assert list(pm.find_synonyms(w, 3)) == list(rm.find_synonyms(w, 3)), w
        top = list(pm.find_synonyms(w, 1))[0]
        assert top in (ANIMALS if w in ANIMALS else FOODS)
    carried = convert.word2vec_from_numpy(vocab=rm.vocab, vectors=rm.vectors)
    for method in ("NONE", "AVERAGE"):
        got = carried.transform(pf, aggregate_method=method)
        want = rm.transform(rf, aggregate_method=method)
        assert got.names == want.names
        assert got.nrow == (400 + 1 if method == "AVERAGE" else len(words))
        for n in want.names:
            np.testing.assert_array_equal(got.vec(n).numeric_np(),
                                          want.vec(n).numeric_np())
    assert carried.find_synonyms("cat", 5) == rm.find_synonyms("cat", 5)


def test_word2vec_raises_and_mojo(cloud1, tmp_path):
    words = _corpus()
    _, pf = _word_frames(words)
    for bad in (dict(sent_sample_rate=0.01), dict(norm_model="NegSampling"),
                dict(word_model="CBOW"), dict(pre_trained="frame")):
        with pytest.raises(NotImplementedError, match=f"{next(iter(bad))}.*item 10"):
            H2OWord2vecEstimator(device="cpu", **bad).train(training_frame=pf)
    rm, pm, rf, pf = _fit_w2v(words, vec_size=8, min_word_freq=2, epochs=3,
                              window_size=3, seed=3)
    pp = mojo.save_model(pm, str(tmp_path), "port_w2v.h2o3")
    rp = refmojo.save_model(rm, str(tmp_path), "ref_w2v.h2o3")
    pn, pmeta, parr = _members(pp)
    rn, rmeta, rarr = _members(rp)
    assert pn == rn and sorted(parr) == sorted(rarr)
    assert {k: v for k, v in pmeta.items() if k != "model_id"} == {
        k: v for k, v in rmeta.items() if k != "model_id"}
    np.testing.assert_array_equal(parr["w2v_vocab"], rarr["w2v_vocab"])
    for loaded in (mojo.load_model(pp), refmojo.load_model(pp)):
        np.testing.assert_array_equal(loaded.arrays["w2v_vectors"], pm.vectors)
        assert loaded.find_synonyms("bread", 4) == pm.find_synonyms("bread", 4)
        src = pf if isinstance(loaded, mojo.MojoScorer) else rf
        for method in ("NONE", "AVERAGE"):
            got = loaded.transform(src, aggregate_method=method)
            want = pm.transform(pf, aggregate_method=method)
            for n in want.names:
                np.testing.assert_array_equal(got.vec(n).numeric_np(),
                                              want.vec(n).numeric_np())
    # the reference's artifact in the port's scorer
    scored = mojo.load_model(rp).predict(pf)
    want = rm.transform(rf)
    for n in want.names:
        np.testing.assert_array_equal(scored.vec(n).numeric_np(),
                                      want.vec(n).numeric_np())
    ext = H2OWord2vecEstimator.from_external(Frame.from_dict(
        {"w": np.asarray(pm.vocab, dtype=object),
         **{f"v{j}": pm.vectors[:, j] for j in range(8)}}))
    assert ext.vocab == pm.vocab
    np.testing.assert_array_equal(ext.vectors, pm.vectors)
