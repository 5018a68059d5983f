"""H2OUpliftRandomForestEstimator — uplift random forest, single device.

Port of `h2o3_tpu/models/uplift.py` (reference parity:
`hex/tree/uplift/UpliftDRF.java` + `hex/tree/uplift/Divergence.java`,
`uplift_metric` ∈ {KL, Euclidean, ChiSquared}: the split gain is the
weighted divergence between the treatment and control response
distributions after against before the split; leaf prediction
p(y|treated) − p(y|control); metrics `hex/ModelMetricsBinomialUplift.java`,
AUUC / Qini).

Shape on the card. The frame is binned on the host by `build_bins` at B,
the next power of two ≥ nbins + 2 (32 at the default 20 bins), the
reference's codes byte for byte (uint8, or past 254 bins, at B = 512 or
1024, uint16 codes sent as int16 by `packing.device_codes`, as the tree
path sends them); the codes are uploaded once and widened
to feature-major once per fit, and that transient serves every histogram
pass of every tree. Each level of a tree builds TWO histograms through
`ops/histogram.py::build_histograms` — {w_t, y·w_t, 0} over the treatment
rows and {w_c, y·w_c, 0} over the control rows (the row sample and the
arm folded into the weights) — which is B1 (`pallas_factored`,
`csrc/hist.cu`) on the card and `segment` on the CPU: 2 × (max_depth + 1)
passes a tree, each over all 2^d nodes of its level (no sibling
subtraction, as in the reference). The divergence gains, the both-arms
`min_rows` constraint, the `mtries` column sample (the reference's
threefry draws, `ops/prng.py`, key PRNGKey(seed + t), one `split` a
level), the argmax and the row routing by codes run as torch ops where
the codes lie. The counts and label sums are exact in every package (0/1
weights and labels); the gains are f32 logs, which XLA, the CPU and CUDA
may round an ulp apart, so two splits within an ulp of each other could
part (the tests' fixtures hold none).

`predict` walks the stacked forest through the forest kernel
(`score_cuda.forest_score`) over a score table the model builds once on
the card, rows padded to SCORE_ROW_BUCKET, the plain walk on the CPU, and
divides by the trees built; it returns the reference's single
`uplift_predict` column. `auuc_type`, `auuc_nbins` and
`col_sample_rate_per_tree` are accepted by the reference and never read:
only their defaults are ported (ROADMAP §C).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.binning import build_bins
from ..frame.frame import Frame
from ..ops import hist_cuda, histogram, packing, prng, score_cuda
from .metrics import ModelMetricsBase
from .model_base import H2OEstimator, H2OModel, _sync, check_unread
from .shared_tree import frame_to_matrix, padded_rows
from . import tree as treelib

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(auuc_type="AUTO", auuc_nbins=-1, col_sample_rate_per_tree=1.0)
_EPS = 1e-6
_INF = float("inf")


def _divergence(pt: torch.Tensor, pc: torch.Tensor, metric: str):
    pt = torch.clamp(pt, _EPS, 1 - _EPS)
    pc = torch.clamp(pc, _EPS, 1 - _EPS)
    if metric == "KL":
        return (pt * torch.log(pt / pc)
                + (1 - pt) * torch.log((1 - pt) / (1 - pc)))
    if metric == "ChiSquared":
        return (pt - pc) ** 2 / pc + ((1 - pt) - (1 - pc)) ** 2 / (1 - pc)
    return (pt - pc) ** 2 + ((1 - pt) - (1 - pc)) ** 2  # Euclidean


def build_uplift_tree(codes_w: torch.Tensor, y: torch.Tensor,
                      w_t: torch.Tensor, w_c: torch.Tensor,
                      edges: torch.Tensor, max_depth: int, nbins: int,
                      min_rows: float = 10.0, metric: str = "KL",
                      mtries: int = 0, key=None) -> treelib.Tree:
    """One uplift tree on feature-major codes `codes_w` (F, N). w_t/w_c are
    row weights masked to treatment/control (0 elsewhere — also the row
    sample). Leaf value = p_t − p_c at every node."""
    dev = y.device
    F, N = codes_w.shape
    T = treelib.heap_size(max_depth)
    feat_a = torch.zeros(T, dtype=torch.int32, device=dev)
    bin_a = torch.zeros(T, dtype=torch.int32, device=dev)
    thr_a = torch.zeros(T, dtype=torch.float32, device=dev)
    split_a = torch.zeros(T, dtype=torch.bool, device=dev)
    value_a = torch.zeros(T, dtype=torch.float32, device=dev)
    idx = torch.zeros(N, dtype=torch.int64, device=dev)
    active = torch.ones(1, dtype=torch.bool, device=dev)
    if key is None:
        key = prng.PRNGKey(0)
    rate = (torch.tensor(mtries / F, dtype=torch.float32, device=dev)
            if mtries > 0 else None)
    zero_h = torch.zeros_like(y)
    pad_edges = torch.cat(
        [edges.to(torch.float32),
         torch.full((F, 1), _INF, dtype=torch.float32, device=dev)], dim=1)
    bin_ok = torch.arange(nbins, device=dev)[None, None, :] < nbins - 1

    for d in range(max_depth + 1):
        L = 2 ** d
        base = L - 1
        ht = histogram.build_histograms(None, idx, y, zero_h, w_t, L, nbins,
                                        codes_w=codes_w)   # {n_t, Σy_t, 0}
        hc = histogram.build_histograms(None, idx, y, zero_h, w_c, L, nbins,
                                        codes_w=codes_w)
        nt = ht[..., 0].sum(dim=2)[:, 0]   # (L,)
        yt = ht[..., 1].sum(dim=2)[:, 0]
        nc = hc[..., 0].sum(dim=2)[:, 0]
        yc = hc[..., 1].sum(dim=2)[:, 0]
        pt_node = yt / torch.clamp(nt, min=_EPS)
        pc_node = yc / torch.clamp(nc, min=_EPS)
        value_a[base:base + L] = pt_node - pc_node
        if d == max_depth:
            break

        cum_t = torch.cumsum(ht[..., :2], dim=2)
        cum_c = torch.cumsum(hc[..., :2], dim=2)
        cnt_t, cy_t = cum_t[..., 0], cum_t[..., 1]
        cnt_c, cy_c = cum_c[..., 0], cum_c[..., 1]
        NT, YT = nt[:, None, None], yt[:, None, None]
        NC, YC = nc[:, None, None], yc[:, None, None]
        ptL = cy_t / torch.clamp(cnt_t, min=_EPS)
        pcL = cy_c / torch.clamp(cnt_c, min=_EPS)
        ptR = (YT - cy_t) / torch.clamp(NT - cnt_t, min=_EPS)
        pcR = (YC - cy_c) / torch.clamp(NC - cnt_c, min=_EPS)
        nL = cnt_t + cnt_c
        nR = (NT + NC) - nL
        ntot = torch.clamp(NT + NC, min=_EPS)
        d_parent = _divergence(pt_node, pc_node, metric)[:, None, None]
        gain = (nL / ntot * _divergence(ptL, pcL, metric)
                + nR / ntot * _divergence(ptR, pcR, metric)
                - d_parent)
        # both arms must be represented on both sides (UpliftDRF constraint)
        ok = (cnt_t >= min_rows) & (cnt_c >= min_rows)
        ok &= (NT - cnt_t >= min_rows) & (NC - cnt_c >= min_rows)
        ok &= bin_ok
        ok &= active[:, None, None]
        if rate is not None:
            key, keep = treelib._keep_mask(key, L, F, rate)
            ok &= keep[:, :, None]
        gain = torch.where(ok, gain, torch.full_like(gain, -_INF))

        flat = gain.reshape(L, F * nbins)
        best = treelib._nan_first_argmax(flat)
        best_gain = flat.gather(1, best[:, None])[:, 0]
        bf = (best // nbins).to(torch.int32)
        bb = (best % nbins).to(torch.int32)
        do_split = best_gain > 1e-10

        bthr = pad_edges[bf.to(torch.int64),
                         torch.clamp(bb, max=nbins - 2).to(torch.int64)]
        zero_i = torch.zeros_like(bf)
        feat_a[base:base + L] = torch.where(do_split, bf, zero_i)
        bin_a[base:base + L] = torch.where(do_split, bb, zero_i)
        thr_a[base:base + L] = torch.where(do_split, bthr,
                                           torch.zeros_like(bthr))
        split_a[base:base + L] = do_split

        rf = bf.to(torch.int64)[idx]
        rcode = codes_w.gather(0, rf[None, :])[0].to(torch.int32)
        go_right = (rcode > bb[idx]) & do_split[idx]
        idx = 2 * idx + go_right.to(torch.int64)
        active = torch.repeat_interleave(do_split, 2)

    return treelib.Tree(feat_a, bin_a, thr_a, split_a, value_a)


def auuc(y: np.ndarray, treat: np.ndarray, uplift: np.ndarray, nbins: int = 1000,
         kind: str = "qini"):
    """AUUC over the qini (or gain) curve — ModelMetricsBinomialUplift's
    thresholded cumulative-uplift design."""
    order = np.argsort(-uplift, kind="mergesort")
    y, treat = y[order], treat[order]
    n = len(y)
    cum_t = np.cumsum(treat)
    cum_c = np.cumsum(1 - treat)
    cum_yt = np.cumsum(y * treat)
    cum_yc = np.cumsum(y * (1 - treat))
    ks = np.unique(np.linspace(1, n, min(nbins, n)).astype(np.int64)) - 1
    with np.errstate(divide="ignore", invalid="ignore"):
        if kind == "qini":
            vals = cum_yt[ks] - cum_yc[ks] * np.where(cum_c[ks] > 0, cum_t[ks] / np.maximum(cum_c[ks], 1), 0)
        else:  # gain
            vals = (cum_yt[ks] / np.maximum(cum_t[ks], 1)
                    - cum_yc[ks] / np.maximum(cum_c[ks], 1)) * (ks + 1)
    vals = np.nan_to_num(vals)
    return float(np.trapezoid(vals, ks + 1) / n), (ks + 1, vals)


@dataclass
class ModelMetricsBinomialUplift(ModelMetricsBase):
    auuc: float = float("nan")
    qini: float = float("nan")
    auuc_normalized: float = float("nan")
    ate: float = float("nan")  # average treatment effect of predictions


class UpliftRandomForestModel(H2OModel):
    algo = "upliftdrf"

    def __init__(self, params, x, y, bm, forest, max_depth, domain,
                 treatment_col, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self.bm = bm
        self.device = devlib.resolve(device)
        # stacked Tree, (ntrees, T) fields on the scoring device
        self.forest = treelib.Tree(*[f.to(self.device).contiguous()
                                     for f in forest])
        self.max_depth = max_depth
        self.domain = domain
        self.treatment_col = treatment_col
        self.ntrees_built = int(self.forest.feat.shape[0])
        self.fit_timings = {}

    def _score_table(self, n_feat: int) -> score_cuda.ScorePack:
        """The forest's packed score table, built at the first score on
        the card and kept in the model's `__dict__` (the memory ledger
        counts it with the model) while the feature count stays the
        same."""
        pack = self.__dict__.get("_score_pack")
        if pack is None or pack.n_feat != n_feat:
            pack = self._score_pack = score_cuda.build_score_pack(
                self.forest, n_feat)
        return pack

    def _uplift(self, frame: Frame) -> np.ndarray:
        X, _, _ = frame_to_matrix(frame, self.x, expected_domains=self.bm.domains)
        Xd = padded_rows(X, self.device)
        pack = self._score_table(X.shape[1]) if Xd.is_cuda else None
        s = score_cuda.forest_score(self.forest, Xd, self.max_depth, pack=pack)
        return (s.cpu().numpy().astype(np.float64)[:X.shape[0]]
                / self.ntrees_built)

    def predict(self, test_data: Frame) -> Frame:
        u = self._uplift(test_data)
        # h2o returns uplift_predict + p_y1_ct1/p_y1_ct0 columns
        return Frame.from_dict({"uplift_predict": u})

    def _make_metrics(self, frame: Frame):
        u = self._uplift(frame)
        yv = frame.vec(self.y)
        y = np.asarray(yv.data, np.float64) if yv.type == "enum" else yv.numeric_np()
        tv = frame.vec(self.treatment_col)
        t = np.asarray(tv.data, np.float64) if tv.type == "enum" else tv.numeric_np()
        a_qini, _ = auuc(y, t, u, kind="qini")
        a_gain, _ = auuc(y, t, u, kind="gain")
        return ModelMetricsBinomialUplift(
            nobs=len(y), auuc=a_qini, qini=a_qini,
            auuc_normalized=a_qini / max(np.abs(u).mean(), 1e-12) if len(y) else float("nan"),
            ate=float(u.mean()),
        )


class H2OUpliftRandomForestEstimator(H2OEstimator):
    algo = "upliftdrf"
    _param_defaults = dict(
        treatment_column=None,
        uplift_metric="AUTO",      # AUTO→KL
        auuc_type="AUTO",
        auuc_nbins=-1,
        ntrees=50,
        max_depth=10,
        min_rows=10.0,
        nbins=20,
        sample_rate=0.632,
        mtries=-2,
        col_sample_rate_per_tree=1.0,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]):
        p = self._parms
        tcol = p.get("treatment_column")
        if not tcol:
            raise ValueError("upliftdrf requires treatment_column")
        x = [c for c in x if c != tcol]
        yvec = train.vec(y)
        if yvec.type != "enum" or yvec.nlevels != 2:
            raise ValueError("upliftdrf requires a binary categorical response")
        check_unread("UpliftDRF", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        tvec = train.vec(tcol)
        treat = (np.asarray(tvec.data, np.float32) if tvec.type == "enum"
                 else tvec.numeric_np().astype(np.float32))
        yarr = np.asarray(yvec.data, np.float32)
        metric = {"AUTO": "KL", "KL": "KL", "Euclidean": "Euclidean",
                  "ChiSquared": "ChiSquared"}[str(p.get("uplift_metric", "AUTO"))]

        X, is_cat, doms = frame_to_matrix(train, x)
        nbins = int(p.get("nbins", 20))
        # pad bins to a power of two like shared_tree does
        B = 1
        while B < nbins + 2:
            B *= 2
        # past 254 bins B is 512 or 1024 and `build_bins` makes uint16
        # codes, which go to the device as int16 (`packing.device_codes`),
        # as on the tree path; past 1022 B is 2048, more than the histogram
        # kernels take
        if B > hist_cuda.MAX_BINS:
            raise ValueError(
                f"nbins={nbins} pads to {B} bins: the histogram kernels take "
                f"at most {hist_cuda.MAX_BINS}; set nbins below "
                f"{hist_cuda.MAX_BINS - 1} (ROADMAP queue B, item 1: more "
                "than 1024 bins)")
        seed = int(self._parms.get("_actual_seed", 1234))
        bm = build_bins(X, nbins=B, names=list(x), is_categorical=is_cat,
                        domains=doms, seed=seed)
        F = X.shape[1]
        edges = np.full((F, B - 2), np.inf, np.float32)
        for j, e in enumerate(bm.edges):
            edges[j, : min(len(e), B - 2)] = e[: B - 2]
        del X
        t_bin = time.perf_counter()

        n = train.nrow
        # the codes widened to feature-major once: every pass of every
        # tree reads this transient
        codes_w = histogram.feature_major(
            torch.from_numpy(packing.device_codes(bm.codes)).to(dev))
        y_d = torch.from_numpy(yarr).to(dev)
        treat_d = torch.from_numpy(treat).to(dev)
        edges_d = torch.from_numpy(edges).to(dev)
        _sync(dev)
        t_up = time.perf_counter()
        sample_rate = float(p.get("sample_rate", 0.632))
        mtries = int(p.get("mtries", -2))
        if mtries in (-1, -2, 0):
            mtries = max(1, int(np.sqrt(F)))
        ntrees = int(p.get("ntrees", 50))
        max_depth = int(p.get("max_depth", 10))
        rng = np.random.default_rng(seed)

        trees = []
        sample_s = 0.0
        for t in range(ntrees):
            ts = time.perf_counter()
            samp = torch.from_numpy(
                (rng.uniform(size=n) < sample_rate).astype(np.float32)).to(dev)
            sample_s += time.perf_counter() - ts
            trees.append(build_uplift_tree(
                codes_w, y_d, samp * treat_d, samp * (1 - treat_d), edges_d,
                max_depth=max_depth, nbins=B,
                min_rows=float(p.get("min_rows", 10.0)), metric=metric,
                mtries=mtries, key=prng.PRNGKey(seed + t)))
        forest = treelib.Tree(*[torch.stack([getattr(tr, f) for tr in trees])
                                for f in treelib.Tree._fields])
        del codes_w, trees
        _sync(dev)
        t_trees = time.perf_counter()

        model = UpliftRandomForestModel(self, x, y, bm, forest, max_depth,
                                        yvec.domain, tcol, device=dev)
        model.training_metrics = model._make_metrics(train)
        if valid is not None:
            model.validation_metrics = model._make_metrics(valid)
        t_end = time.perf_counter()
        # host-clock split: the host matrix and binning, the upload and
        # widening of the codes, the tree loop (the host's row-sample draws
        # within it as sample_s; synchronised at its end) and the metrics
        model.fit_timings = dict(bin_s=t_bin - t0, h2d_s=t_up - t_bin,
                                 trees_s=t_trees - t_up, sample_s=sample_s,
                                 metrics_s=t_end - t_trees,
                                 total_s=t_end - t0)
        return model

    def _cv_predict(self, model, frame: Frame) -> np.ndarray:
        return model._uplift(frame)


UpliftDRF = H2OUpliftRandomForestEstimator
