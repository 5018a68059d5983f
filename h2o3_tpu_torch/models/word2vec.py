"""H2OWord2vecEstimator — word embeddings, single device.

Port of `h2o3_tpu/models/word2vec.py` (reference parity:
`hex/word2vec/Word2Vec.java` and the client surface
`h2o-py/h2o/estimators/word2vec.py`: `find_synonyms`, `transform` with
`aggregate_method="AVERAGE"`, the pre-trained import). The reference trains
skip-gram with negative sampling as synchronous mini-batches; so does the
port.

The host part is the reference's, in its order: the vocabulary (`np.unique`
over the words, `min_word_freq`), the skip-gram pairs within
NA-delimited sentences (a word below the frequency floor also ends a
window), the unigram^0.75 table, `Wc` from `rng.random` and `Wo` zeros,
one `rng.permutation` per epoch and one `rng.choice(V, (B, neg), p)` per
step, B = min(8192, pairs) with the tail of an epoch dropped, and the f32
learning rate of each step. `skipgram_pairs` builds the pairs with array
operations; its arrays equal the reference's loop byte for byte. The
negatives are drawn as `Generator.choice` draws them with `p`
(`negative_draw`: `rng.random((B, neg))` searched in the table's f64 CDF,
`side="right"`), with the search on the device: the same indices from the
same generator state, without numpy's per-call checks and cumulative sum
of `p` and its host search, most of a step's host time.

The step (`sgns_step`) runs on the device in f32: the centre, context and
negative rows gathered, the mean negative log-likelihood's gradient
written out (σ(−s)/B for the positive pair, σ(t)/B for each negative),
scattered into dense (V, d) gradients with `index_add_` and applied as
W − lr·g. Where a word occurs more than once in a batch its rows add in
another order than XLA's scatter (and, on the card, in the atomics'
order), so vectors agree to f32 rounding, not bit for bit.

`sent_sample_rate`, `norm_model`, `word_model` and `pre_trained` are
accepted by the reference and never read by its fit: only their defaults
are ported (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .metrics import ModelMetricsBase
from .model_base import H2OEstimator, H2OModel, check_unread

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(sent_sample_rate=0.001, norm_model="HSM", word_model="SkipGram",
               pre_trained=None)
BATCH = 8192


def skipgram_pairs(seq: np.ndarray, window: int):
    """(centers, contexts) int32 of the reference's pair loop: for each
    in-vocabulary position i and d = 1..window while i + d is in range and
    in vocabulary, the pairs (seq[i], seq[i+d]) and (seq[i+d], seq[i])."""
    n = len(seq)
    stops = np.concatenate([np.nonzero(seq < 0)[0], [n]])
    i = np.arange(n)
    # the window of i ends before the first stop after it
    run = stops[np.searchsorted(stops, i, side="right")] - i - 1
    run = np.where(seq >= 0, np.minimum(run, window), 0)
    d = np.arange(1, window + 1)
    keep = d[None, :] <= run[:, None]                     # (n, window)
    ii = np.broadcast_to(i[:, None], keep.shape)[keep]
    jj = (i[:, None] + d[None, :])[keep]
    a, b = seq[ii], seq[jj]
    centers = np.stack([a, b], axis=1).reshape(-1).astype(np.int32)
    contexts = np.stack([b, a], axis=1).reshape(-1).astype(np.int32)
    return centers, contexts


def negative_draw(u: np.ndarray, cdf: torch.Tensor) -> torch.Tensor:
    """(B, neg) int64 negatives on cdf's device from `u = rng.random((B,
    neg))`: equal to `rng.choice(V, (B, neg), p=probs)` from the state that
    drew `u`, which searches those uniforms in `cumsum(p) / cumsum(p)[-1]`
    (`cdf`, f64) with `side="right"`."""
    return torch.searchsorted(cdf, torch.from_numpy(u).to(cdf.device),
                              right=True)


def sgns_step(Wc: torch.Tensor, Wo: torch.Tensor, c_idx: torch.Tensor,
              o_idx: torch.Tensor, n_idx: torch.Tensor, lr_t: float):
    """One SGNS step on the mean loss −mean(log σ(vc·vo) + Σ log σ(−vc·vn)):
    returns the updated (Wc, Wo)."""
    B, neg = n_idx.shape
    vc, vo, vn = Wc[c_idx], Wo[o_idx], Wo[n_idx]           # (B,d) (B,d) (B,n,d)
    s = (vc * vo).sum(dim=1)                               # (B,)
    t = torch.einsum("bd,bnd->bn", vc, vn)                 # (B, neg)
    dpos = -torch.sigmoid(-s) / B                          # dL/ds
    dneg = torch.sigmoid(t) / B                            # dL/dt
    gvc = dpos[:, None] * vo + torch.einsum("bn,bnd->bd", dneg, vn)
    gvo = dpos[:, None] * vc
    gvn = dneg[:, :, None] * vc[:, None, :]
    gc = torch.zeros_like(Wc).index_add_(0, c_idx, gvc)
    go = torch.zeros_like(Wo).index_add_(0, o_idx, gvo).index_add_(
        0, n_idx.reshape(-1), gvn.reshape(B * neg, -1))
    return Wc - lr_t * gc, Wo - lr_t * go


class Word2VecModel(H2OModel):
    algo = "word2vec"

    def __init__(self, params, vocab: List[str], vectors: np.ndarray):
        super().__init__(params)
        self.vocab = vocab
        self.index: Dict[str, int] = {w: i for i, w in enumerate(vocab)}
        self.vectors = vectors  # (V, dim)
        self.x = []
        self.y = None

    def find_synonyms(self, word: str, count: int = 20) -> Dict[str, float]:
        if word not in self.index:
            return {}
        v = self.vectors[self.index[word]]
        norms = np.linalg.norm(self.vectors, axis=1) * max(np.linalg.norm(v), 1e-12)
        sims = self.vectors @ v / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = {}
        for i in order:
            if self.vocab[i] == word:
                continue
            out[self.vocab[i]] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def transform(self, words_frame: Frame, aggregate_method: str = "NONE") -> Frame:
        """words → vectors; AVERAGE aggregates consecutive non-NA runs
        (h2o's sentence embedding convention: NA rows delimit sentences)."""
        col = words_frame.vecs()[0]
        words = col.to_numpy() if col.type == "string" else np.asarray(
            [col.domain[c] if c >= 0 else None for c in np.asarray(col.data)],
            dtype=object,
        )
        dim = self.vectors.shape[1]
        if aggregate_method.upper() == "NONE":
            out = np.full((len(words), dim), np.nan)
            for i, w in enumerate(words):
                if w is not None and w in self.index:
                    out[i] = self.vectors[self.index[w]]
            return Frame.from_dict({f"C{j+1}": out[:, j] for j in range(dim)})
        sents, cur = [], []
        for w in words:
            if w is None:
                sents.append(cur)
                cur = []
            else:
                cur.append(w)
        sents.append(cur)
        out = np.full((len(sents), dim), np.nan)
        for i, sent in enumerate(sents):
            vecs = [self.vectors[self.index[w]] for w in sent if w in self.index]
            if vecs:
                out[i] = np.mean(vecs, axis=0)
        return Frame.from_dict({f"C{j+1}": out[:, j] for j in range(dim)})

    def predict(self, test_data: Frame) -> Frame:
        return self.transform(test_data)

    def _make_metrics(self, frame):
        return ModelMetricsBase()


class H2OWord2vecEstimator(H2OEstimator):
    algo = "word2vec"
    supervised = False
    _param_defaults = dict(
        vec_size=100,
        min_word_freq=5,
        window_size=5,
        sent_sample_rate=0.001,
        init_learning_rate=0.025,
        epochs=5,
        negative_samples=5,
        norm_model="HSM",
        word_model="SkipGram",
        pre_trained=None,
    )

    @staticmethod
    def from_external(frame: Frame) -> Word2VecModel:
        """Import pre-trained embeddings (h2o.word2vec pre_trained path):
        first column words, rest the vector. Word labels are decoded PER ROW
        (an enum column's domain is sorted, not row-ordered — rows must pair
        with their own matrix row)."""
        words = frame.vecs()[0]
        if words.type == "string":
            labels = [str(w) for w in words.to_numpy()]
        elif words.type == "enum":
            dom = np.asarray(words.domain + [None], dtype=object)
            labels = [str(w) for w in dom[np.asarray(words.data)]]
        else:
            labels = [str(w) for w in words.numeric_np()]
        mat = np.column_stack([v.numeric_np() for v in frame.vecs()[1:]])
        est = H2OWord2vecEstimator()
        return Word2VecModel(est, labels, mat)

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> Word2VecModel:
        p = self._parms
        check_unread("Word2Vec", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        seed = p["_actual_seed"]
        col = train.vecs()[0]
        if col.type == "string":
            words = col.to_numpy()
        elif col.type == "enum":
            dom = np.asarray(col.domain + [None], dtype=object)
            words = dom[np.asarray(col.data)]
        else:
            raise ValueError("word2vec needs a string/enum column of words")

        min_freq = int(p.get("min_word_freq", 5))
        toks = [w for w in words if w is not None]
        uniq, counts = np.unique(np.asarray(toks, dtype=object), return_counts=True)
        keep = counts >= min_freq
        vocab = [str(w) for w in uniq[keep]]
        freq = counts[keep].astype(np.float64)
        V = len(vocab)
        if V == 0:
            raise ValueError(f"no words with frequency >= {min_freq}")
        index = {w: i for i, w in enumerate(vocab)}
        seq = np.asarray([index.get(w, -1) if w is not None else -1 for w in words],
                         np.int64)

        dim = int(p.get("vec_size", 100))
        window = int(p.get("window_size", 5))
        neg = int(p.get("negative_samples", 5))
        lr = float(p.get("init_learning_rate", 0.025))
        epochs = int(p.get("epochs", 5))

        centers, contexts = skipgram_pairs(seq, window)
        if not len(centers):
            raise ValueError("no skip-gram pairs (input too short)")

        # unigram^0.75 negative-sampling table
        probs = freq ** 0.75
        probs = probs / probs.sum()

        rng = np.random.default_rng(seed)
        Wc_h = (rng.random((V, dim)).astype(np.float32) - 0.5) / dim
        t_vocab = time.perf_counter()
        cdf = probs.cumsum()
        cdf /= cdf[-1]
        cdf_d = torch.from_numpy(cdf).to(dev)
        Wc = torch.from_numpy(Wc_h).to(dev)
        Wo = torch.zeros((V, dim), dtype=torch.float32, device=dev)
        c_d = torch.from_numpy(centers.astype(np.int64)).to(dev)
        o_d = torch.from_numpy(contexts.astype(np.int64)).to(dev)

        B = min(BATCH, len(centers))
        steps_per_epoch = max(len(centers) // B, 1)
        total = epochs * steps_per_epoch
        t = 0
        draw_s = 0.0
        for ep in range(epochs):
            th = time.perf_counter()
            perm = rng.permutation(len(centers))
            draw_s += time.perf_counter() - th
            perm_d = torch.from_numpy(perm).to(dev)
            for s in range(steps_per_epoch):
                sel = perm_d[s * B:(s + 1) * B]
                th = time.perf_counter()
                u = rng.random((len(sel), neg))
                draw_s += time.perf_counter() - th
                n_idx = negative_draw(u, cdf_d)
                lr_t = float(np.float32(lr * max(1 - t / total, 1e-4)))
                Wc, Wo = sgns_step(Wc, Wo, c_d[sel], o_d[sel], n_idx, lr_t)
                t += 1
        vectors = Wc.cpu().numpy()
        t_end = time.perf_counter()

        model = Word2VecModel(self, vocab, vectors)
        model.training_metrics = ModelMetricsBase(nobs=len(centers))
        # host: the vocabulary and the pairs, then numpy's draws inside the
        # step loop (`loop_s`); the loop's rest is the steps' launches and
        # their waits on the device (`steps_s`)
        loop_s = t_end - t_vocab
        model.fit_timings = dict(vocab_pairs_s=t_vocab - t0, draws_s=draw_s,
                                 steps_s=loop_s - draw_s, loop_s=loop_s,
                                 total_s=t_end - t0)
        model.fit_stats = dict(vocab=V, pairs=int(len(centers)), batch=B,
                               steps=total)
        return model


Word2Vec = H2OWord2vecEstimator
