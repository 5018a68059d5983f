"""SharedTree fit loop — GBM and DRF over `tree.build_tree`.

Port of the single-device, in-core fit of `h2o3_tpu/models/shared_tree.py`
(`_fit`, the per-tree step `_one_tree` with `_grads`, row and column
sampling, the margin update, DRF out-of-bag sums, the compaction-overflow
rebuild, the forest pack, training metrics and `SharedTreeModel._margins`
through the forest-scoring kernel, and the memory-feasibility depth clamp
with its warning). Reference parity: `hex/tree/SharedTree.java`,
`hex/tree/gbm/GBM.java` and `hex/tree/drf/DRF.java`.

Each iteration m: the tree's keys from `fold_in(seed key, m)` (`ops.prng`,
the reference's threefry draws) → the row and column samples → gradients
(GBM: from the margins; DRF: g = −y, h = 1, so a leaf is its rows' mean
response) → `tree.build_tree` → margins += leaf value per row. A DRF
forest predicts the average of its trees. PyTorch runs this eagerly; there
is no per-iteration program to compile.

Not ported yet (ROADMAP queue A, items 5-9): per-class row sampling,
multinomial and the other distributions, validation frames, early stopping,
CV, checkpoints, DART, dataset cache, streaming, sharding, QoS and
calibration. Asking for any of them raises `NotImplementedError`.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import device as devlib
from ..frame.binning import BinnedMatrix, build_bins
from ..frame.frame import Frame
from ..ops import packing, prng, score_cuda
from ..runtime.log import Log
from . import distributions as dist_mod
from . import tree as treelib
from .metrics import ModelMetricsBinomial, ModelMetricsRegression
from .model_base import SCORE_ROW_BUCKET, H2OEstimator, H2OModel, response_info


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def _histogram_budget(dev: torch.device) -> int:
    """Bytes the deepest level's histograms may take: half the card's
    memory (the reference's half of the device's byte limit), 8 GiB on the
    CPU."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[1] // 2
    return 8 << 30


def _binom_binned_stats(margins: torch.Tensor, y: torch.Tensor, n: int,
                        nbins: int = 400):
    """AUC2-style 400-bin score histogram on the device (hex/AUC2.java):
    quantile edges, per-bin (pos, neg) counts and the logloss / squared
    error sums over the first `n` rows."""
    valid = torch.arange(margins.shape[0], device=margins.device) < n
    p = torch.sigmoid(margins)
    # the linear-interpolation quantiles of the n real rows, written out:
    # torch.nanquantile refuses inputs of more than 2^24 elements
    v = torch.sort(p[:n]).values
    pos = torch.linspace(0.0, 1.0, nbins, device=p.device, dtype=p.dtype) * (n - 1)
    lo = pos.to(torch.int64)
    qs = torch.lerp(v[lo], v[pos.ceil().to(torch.int64)], pos - lo)
    bins = torch.searchsorted(qs, p, side="left")
    vf = valid.to(torch.float32)
    npos = torch.zeros(nbins + 1, device=p.device).index_add_(0, bins, y * vf)
    nneg = torch.zeros(nbins + 1, device=p.device).index_add_(
        0, bins, (1.0 - y) * vf)
    pc = torch.clamp(p, 1e-15, 1 - 1e-15)
    zero = torch.zeros_like(pc)
    nll = -torch.sum(torch.where(valid & (y > 0.5), torch.log(pc), zero)
                     + torch.where(valid & (y <= 0.5), torch.log(1.0 - pc), zero))
    sq = torch.sum(torch.where(valid, (p - y) ** 2, zero))
    return qs, npos, nneg, nll, sq


_log = logging.getLogger(__name__)


def probs_from_margins(mode: str, problem: str, m: np.ndarray,
                       ntrees: int) -> np.ndarray:
    """Host-side margins (N, 1) → predictions. GBM: the link of the summed
    margins; DRF: the forest average of the per-leaf response means (vote
    averaging, `hex/tree/drf/DRFModel.score0`)."""
    m = np.asarray(m)
    if mode == "drf":
        m = m * (1.0 / max(ntrees, 1))
        if problem == "binomial":
            p1 = np.clip(m[:, 0], 0.0, 1.0)
            return np.stack([1 - p1, p1], axis=1)
        return m[:, :1]
    if problem == "binomial":
        p1 = 1 / (1 + np.exp(-m[:, 0]))
        return np.stack([1 - p1, p1], axis=1)
    return m[:, :1]


def _metrics_for(problem, yvec, probs):
    if problem == "binomial":
        return ModelMetricsBinomial.make(np.asarray(yvec.data), probs[:, 1])
    return ModelMetricsRegression.make(yvec.numeric_np(), probs[:, 0])


def frame_to_matrix(frame: Frame, x: Sequence[str], expected_domains=None):
    """Frame → (X float64 with NaN NAs, is_categorical, domains). Enums stay
    integer codes; with `expected_domains` (the training domains) test-frame
    codes are remapped label → training code and unseen levels become NA
    (`hex/Model.adaptTestForTrain`)."""
    cols, cats, doms = [], [], []
    for i, n in enumerate(x):
        v = frame.vec(n)
        col = v.numeric_np()
        exp = expected_domains[i] if expected_domains is not None else None
        if v.type == "enum" and exp is not None and v.domain != exp:
            lookup = {lbl: j for j, lbl in enumerate(exp)}
            remap = np.asarray(
                [lookup.get(lbl, -1) for lbl in (v.domain or [])], np.float64)
            codes = np.asarray(v.data)
            col = np.where(codes >= 0,
                           remap[np.maximum(codes, 0)] if len(remap) else -1.0,
                           -1.0)
            col = np.where(col < 0, np.nan, col)
        cols.append(col)
        cats.append(v.type == "enum")
        doms.append(v.domain)
    return np.column_stack(cols), np.asarray(cats), doms


class SharedTreeModel(H2OModel):
    algo = "sharedtree"

    def __init__(self, params, x, y, bm: BinnedMatrix, problem, nclass,
                 domain, distribution, f0: float, forest: treelib.Tree,
                 covers: Optional[torch.Tensor], max_depth: int,
                 device: torch.device, mode: str = "gbm"):
        self.algo = getattr(params, "algo", self.algo)
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self.bm = bm
        self.problem = problem
        self.nclass = nclass
        self.domain = domain
        self.distribution = distribution
        self.f0 = float(f0)          # initial margin
        self.forest = forest         # stacked Tree, (ntrees, T) per field
        self.covers = covers         # (ntrees, T) Σ row weights per node
        self.max_depth = max_depth
        self.device = device
        self.mode = mode             # 'gbm' (summed margins) | 'drf' (averaged)
        self.ntrees_built = int(forest.feat.shape[0])
        self.fit_timings: Dict[str, float] = {}

    def _matrix(self, frame: Frame) -> np.ndarray:
        X, _, _ = frame_to_matrix(frame, self.x, expected_domains=self.bm.domains)
        return X

    def _margins(self, X: np.ndarray) -> np.ndarray:
        """(N, 1) f64 margins on a raw feature matrix, scored on the device
        the model was fit on: the forest kernels over the model's score
        table on the card, the plain walk on the CPU, which builds no table
        (`score_cuda.forest_score`). Rows are padded with zeros
        to a multiple of SCORE_ROW_BUCKET, which are sliced off; GBM's
        initial margin is added in f64 on the host."""
        n = X.shape[0]
        npad = _pad_to_multiple(max(n, 1), SCORE_ROW_BUCKET)
        Xp = np.zeros((npad, X.shape[1]), np.float32)
        Xp[:n] = X
        Xd = torch.from_numpy(Xp).to(self.device)
        pack = self._score_table(X.shape[1]) if Xd.is_cuda else None
        s = score_cuda.forest_score(self.forest, Xd, self.max_depth, pack=pack)
        return (s.cpu().numpy().astype(np.float64)[:n] + self.f0)[:, None]

    def _score_table(self, n_feat: int) -> score_cuda.ScorePack:
        """The forest's packed score table (8 bytes a node), built at the
        first score on the card and kept while the forest and the feature
        count stay the same. It lives in the model's `__dict__`, so the
        memory ledger counts it with the model."""
        pack = getattr(self, "_score_pack", None)
        if pack is None or pack.forest is not self.forest \
                or pack.n_feat != n_feat:
            pack = self._score_pack = score_cuda.build_score_pack(
                self.forest, n_feat)
        return pack

    def _score_probs(self, X: np.ndarray) -> np.ndarray:
        return probs_from_margins(self.mode, self.problem, self._margins(X),
                                  self.ntrees_built)

    def predict(self, test_data: Frame) -> Frame:
        out = self._score_probs(self._matrix(test_data))
        if self.problem == "binomial":
            lab = out.argmax(axis=1)
            d = {"predict": np.asarray(self.domain, dtype=object)[lab]}
            for i, cls in enumerate(self.domain):
                d[str(cls)] = out[:, i]
            return Frame.from_dict(d, column_types={"predict": "enum"})
        return Frame.from_dict({"predict": out[:, 0]})

    def _make_metrics(self, frame: Frame):
        out = self._score_probs(self._matrix(frame))
        return _metrics_for(self.problem, frame.vec(self.y), out)


class H2OSharedTreeEstimator(H2OEstimator):
    """Common GBM/DRF estimator. Subclasses set `_mode` ('gbm' | 'drf')."""

    _mode = "gbm"
    # parameter -> (value the slice runs, ROADMAP item that ports the rest)
    _UNPORTED = dict(
        sample_rate_per_class=(None, "queue A, item 5 (per-class rates)"),
        binomial_double_trees=(False, "queue A, item 5"),
        monotone_constraints=(None, "queue A, item 4"),
        calibrate_model=(False, "queue A, item 5"),
        calibration_frame=(None, "queue A, item 5"),
        goss=(False, "queue A, item 7"),
        score_tree_interval=(0, "queue A, item 5 (scoring history)"),
        balance_classes=(False, "queue A, item 5"),
        class_sampling_factors=(None, "queue A, item 5"),
    )

    def _tree_params(self) -> Dict:
        p = self._parms
        for k, (ok, item) in self._UNPORTED.items():
            if k in p and p[k] != ok:
                raise NotImplementedError(
                    f"{type(self).__name__}: {k}={p[k]!r} is not ported "
                    f"(ROADMAP {item})")
        drf = self._mode == "drf"
        return dict(
            ntrees=int(p.get("ntrees", 50)),
            max_depth=int(p.get("max_depth", 20 if drf else 5)),
            min_rows=float(p.get("min_rows", 1.0 if drf else 10.0)),
            nbins=int(p.get("nbins", 20)),
            learn_rate=float(p.get("learn_rate", 0.1)),
            learn_rate_annealing=float(p.get("learn_rate_annealing", 1.0)),
            sample_rate=float(p.get("sample_rate", 0.632 if drf else 1.0)),
            col_sample_rate=float(p.get("col_sample_rate", 1.0)),
            col_sample_rate_per_tree=float(p.get("col_sample_rate_per_tree", 1.0)),
            min_split_improvement=float(p.get("min_split_improvement", 1e-5)),
            histogram_type=p.get("histogram_type", "AUTO"),
            hist_method=p.get("hist_method", "auto"),
            mtries=int(p.get("mtries", -1)) if "mtries" in p else 0,
            reg_lambda=(float(p["reg_lambda"]) if p.get("reg_lambda") is not None
                        else (0.0 if drf else 1.0)),
            max_abs_leaf=float(p.get("max_abs_leafnode_pred") or np.inf),
        )

    def _resolved_mtries(self, tp, F: int, problem: str) -> int:
        """DRF's per-split column-sample count (`hex/tree/drf/DRF.java`
        _mtry defaults); 0 for GBM."""
        if self._mode != "drf":
            return 0
        mtries = tp["mtries"]
        if mtries in (-1, 0):
            return (max(1, int(np.sqrt(F))) if problem != "regression"
                    else max(1, F // 3))
        if mtries == -2:
            return F
        if mtries > F:
            raise ValueError(
                f"mtries={mtries} exceeds the {F} usable feature columns")
        return mtries

    @staticmethod
    def _validate_tree_params(tp) -> None:
        """Value-range validation (hex.ModelBuilder.init / SharedTree
        checkParams)."""
        if tp["ntrees"] < 1:
            raise ValueError(f"ntrees must be >= 1, got {tp['ntrees']}")
        if tp["max_depth"] < 1:
            raise ValueError(f"max_depth must be >= 1, got {tp['max_depth']}")
        for k in ("learn_rate", "learn_rate_annealing", "sample_rate",
                  "col_sample_rate", "col_sample_rate_per_tree"):
            if not (0.0 < tp[k] <= 1.0):
                raise ValueError(f"{k} must be in (0, 1], got {tp[k]}")
        if tp["nbins"] < 2:
            raise ValueError(f"nbins must be >= 2, got {tp['nbins']}")
        if tp["min_rows"] <= 0:
            raise ValueError(f"min_rows must be > 0, got {tp['min_rows']}")
        if tp["min_split_improvement"] < 0:
            raise ValueError("min_split_improvement must be >= 0, got "
                             f"{tp['min_split_improvement']}")
        if tp["mtries"] not in (-2, -1, 0) and tp["mtries"] < 1:
            raise ValueError(f"mtries must be -2, -1, or >= 1, got {tp['mtries']}")

    def _fit(self, x, y, train: Frame) -> SharedTreeModel:
        tp = self._tree_params()
        self._validate_tree_params(tp)
        dev = devlib.resolve(self._parms.get("device"))
        seed = self._parms["_actual_seed"]
        yvec = train.vec(y)
        problem, nclass, domain = response_info(yvec)
        drf = self._mode == "drf"
        if problem == "multinomial":
            raise NotImplementedError(
                f"multinomial {self._mode.upper()} is not ported "
                "(ROADMAP queue A, item 5)")
        dist = dist_mod.infer_distribution(
            problem, self._parms.get("distribution", "AUTO"))
        if drf and problem == "regression":
            dist = "gaussian"      # DRF trees fit raw response means
        if dist not in dist_mod.FAMILIES:
            raise NotImplementedError(
                f"distribution {dist!r} is not ported (ROADMAP queue A, item 5)")

        t0 = time.perf_counter()
        X, is_cat, doms = frame_to_matrix(train, x)
        n, F = X.shape
        max_card = int(max([len(d) for d, c in zip(doms, is_cat) if c and d],
                           default=0))
        nbins = max(tp["nbins"] + 1, min(max_card + 1, 1 << 10))
        if nbins > 256:
            raise NotImplementedError(
                f"{nbins} bins need 16-bit codes, which the histogram kernel "
                "does not take yet (ROADMAP queue B, item 1)")
        # memory-feasibility depth clamp: the deepest level's histograms
        # take ~2^D·F·nbins·96 bytes; keep them under the histogram budget
        budget = _histogram_budget(dev)
        feas = tp["max_depth"]
        while feas > 4 and (1 << feas) * F * nbins * 96 > budget:
            feas -= 1
        if tp["max_depth"] > feas:
            Log.warn(
                f"max_depth={tp['max_depth']} clamped to {feas}: the "
                f"level-complete heap's deepest histograms (F={F}, "
                f"nbins={nbins}) would exceed the HBM budget "
                f"({budget >> 30} GiB)")
            tp["max_depth"] = feas

        bm = build_bins(X, nbins=nbins, histogram_type=tp["histogram_type"],
                        names=list(x), is_categorical=is_cat, domains=doms,
                        seed=seed)
        t_bins = time.perf_counter()
        if problem == "regression":
            yk = yvec.numeric_np().astype(np.float32)
        else:
            yk = np.asarray(yvec.data, np.float32)
        w = np.ones(n, np.float32)
        f0 = (np.float32(0.0) if drf
              else np.float32(dist_mod.init_margin(dist, yk, w)))

        # rows padded to a multiple of 8 (every pack group divides 8) with
        # zero-weight rows, which contribute nothing
        npad = _pad_to_multiple(n, 8)
        pad = npad - n
        codes_p = np.concatenate([bm.codes, np.zeros((pad, F), bm.codes.dtype)])
        pack_bits = packing.pack_bits_for(nbins, npad)
        # the resident matrix stays packed; each tree widens it once
        codes_d = torch.from_numpy(
            packing.pack_host(codes_p, pack_bits) if pack_bits else codes_p
        ).to(dev)
        y_d = torch.from_numpy(np.concatenate([yk, np.zeros(pad, np.float32)])).to(dev)
        w_d = torch.from_numpy(np.concatenate([w, np.zeros(pad, np.float32)])).to(dev)
        edges = np.full((F, nbins - 2), np.float32(np.inf), np.float32)
        for j, e in enumerate(bm.edges):
            edges[j, : min(len(e), nbins - 2)] = e[: nbins - 2]
        edges_d = torch.from_numpy(edges).to(dev)
        ones = torch.ones(F, dtype=torch.float32, device=dev)
        margins = torch.full((npad,), float(f0), dtype=torch.float32, device=dev)
        cap = tp["max_abs_leaf"] if np.isfinite(tp["max_abs_leaf"]) else 3.4e38
        # sampling: per-row rate, per-tree column product, DRF's per-split
        # mtries rate, each compared in f32 as the reference does
        row_sampled = tp["sample_rate"] < 1.0
        oob = drf and row_sampled        # DRF training metrics are out-of-bag
        colp = tp["col_sample_rate"] * tp["col_sample_rate_per_tree"]
        row_rate = torch.tensor(np.float32(tp["sample_rate"]), device=dev)
        col_rate = torch.tensor(np.float32(colp), device=dev)
        mtries = self._resolved_mtries(tp, F, problem)
        mtries_rate = float(np.float32(mtries / max(F, 1))) if mtries > 0 else None
        # deep trees run their wide levels in active-node compaction; a tree
        # whose live nodes overflow the cap is rebuilt with dense levels
        compact_cap = (max(2, int(os.environ.get("H2O3_COMPACT_CAP", 4096)) // 2 * 2)
                       if tp["max_depth"] > 12 else 0)
        lr = tp["learn_rate"] if not drf else 1.0
        if oob:
            oob_sum = torch.zeros(npad, dtype=torch.float32, device=dev)
            oob_cnt = torch.zeros(npad, dtype=torch.float32, device=dev)
        key = prng.PRNGKey(seed & 0x7FFFFFFF)
        _sync(dev)
        t_up = time.perf_counter()

        trees, covers = [], []
        gains = torch.zeros(F, dtype=torch.float32, device=dev)
        dense_rebuilds = 0
        for m in range(tp["ntrees"]):
            krow, kcol, ktree = prng.split(prng.fold_in(prng.fold_in(key, m), 0), 3)
            ktree = prng.fold_in(ktree, 0)
            if row_sampled:
                row_mask = (prng.uniform(krow, (npad,), dev) < row_rate).to(torch.float32)
                wt = w_d * row_mask
            else:
                wt = w_d
            if colp < 1.0:
                fm = (prng.uniform(kcol, (F,), dev) < col_rate).to(torch.float32)
                fm[0] = torch.maximum(fm[0], 1 - fm.sum().clamp(0, 1))
            else:
                fm = ones
            if drf:
                g, h = -y_d, torch.ones_like(y_d)
            else:
                g, h = dist_mod.grad_hess(dist, margins, y_d)

            def grow(cap_slots):
                return treelib.build_tree(
                    codes_d, g, h, wt, fm, edges_d,
                    max_depth=tp["max_depth"], nbins=nbins,
                    min_rows=tp["min_rows"],
                    min_split_improvement=tp["min_split_improvement"],
                    reg_lambda=tp["reg_lambda"], max_abs_leaf=cap,
                    hist_method=tp["hist_method"], pack_bits=pack_bits,
                    mtries_rate=mtries_rate, key=ktree, compact_cap=cap_slots)

            out = grow(compact_cap)
            if compact_cap and int(out[4]) > 0:
                # exactness is never traded: the same tree (same keys),
                # grown with dense levels
                dense_rebuilds += 1
                out = grow(0)
            tr, leaf_idx, gain_f, cover = out[:4]
            scale = np.float32(np.float32(lr)
                               * np.power(np.float32(tp["learn_rate_annealing"]),
                                          np.float32(m)))
            tr = tr._replace(value=tr.value * torch.tensor(scale, device=dev))
            leaf_vals = treelib.value_at(tr.value, leaf_idx)
            margins = margins + leaf_vals
            if oob:
                # out-of-bag: rows this tree did not sample take its vote
                oob_sum = oob_sum + leaf_vals * (1.0 - row_mask)
                oob_cnt = oob_cnt + (1.0 - row_mask)
            trees.append(tr)
            covers.append(cover)
            gains = gains + gain_f
        if dense_rebuilds:
            _log.warning(
                "%d of %d trees overflowed the compact-node cap %d and were "
                "rebuilt with dense levels", dense_rebuilds, tp["ntrees"],
                compact_cap)
        forest = treelib.Tree(*[torch.stack([getattr(t, f) for t in trees])
                                for f in treelib.Tree._fields])
        _sync(dev)
        t_trees = time.perf_counter()
        model = SharedTreeModel(self, x, y, bm, problem, nclass, domain, dist,
                                float(f0), forest, torch.stack(covers),
                                tp["max_depth"], dev, mode=self._mode)
        model.compact_cap = compact_cap
        model.dense_rebuilds = dense_rebuilds
        gain_total = gains.cpu().numpy().astype(np.float64)
        if gain_total.sum() > 0:
            order = np.argsort(-gain_total)
            model.varimp_table = [
                (list(x)[i], float(gain_total[i]),
                 float(gain_total[i] / gain_total.max()),
                 float(gain_total[i] / gain_total.sum()))
                for i in order]
        ntrees = model.ntrees_built
        if problem == "binomial" and not drf:
            # the whole training-metric reduction runs on the device (AUC2
            # binned design): only the bin counts come back
            qs, npos, nneg, nll, sq = _binom_binned_stats(margins, y_d, n)
            model.training_metrics = ModelMetricsBinomial.from_binned(
                qs.cpu().numpy(), npos.cpu().numpy(), nneg.cpu().numpy(),
                float(nll), float(sq))
        else:
            m_np = margins[:n].cpu().numpy().astype(np.float64)[:, None]
            if oob:
                # DRF training metrics are out-of-bag: each row is scored
                # by the trees that did not sample it; rows every tree
                # sampled fall back to the in-bag forest average
                osum = oob_sum[:n].cpu().numpy().astype(np.float64)[:, None]
                ocnt = oob_cnt[:n].cpu().numpy().astype(np.float64)[:, None]
                m_np = np.where(ocnt > 0, osum / np.maximum(ocnt, 1.0),
                                m_np / max(ntrees, 1)) * max(ntrees, 1)
            model.training_metrics = _metrics_for(
                problem, yvec, probs_from_margins(self._mode, problem, m_np,
                                                  ntrees))
        # host-clock split of the fit (the device is synchronised at each
        # mark): frame→matrix + binning, packing + upload, the boosting loop,
        # training metrics
        model.fit_timings = dict(bins_s=t_bins - t0, upload_s=t_up - t_bins,
                                 trees_s=t_trees - t_up,
                                 metrics_s=time.perf_counter() - t_trees)
        return model
