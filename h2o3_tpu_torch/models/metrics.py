"""ModelMetrics — per-problem metric hierarchy.

A copy of `h2o3_tpu/models/metrics.py` (host numpy, no JAX). Reference
parity: `h2o-core/src/main/java/hex/ModelMetrics*.java`, `hex/AUC2.java`
(threshold-binned ROC: 400-bin score histogram → AUC / pr-AUC / max-F1).

The reference computes these inside scoring MRTasks via
`ModelMetrics.MetricBuilder` map/reduce; here the reductions are numpy on
gathered predictions (cheap relative to training) with the same binned-AUC
design available for the distributed path. Gini = 2·AUC−1 as in AUC2.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

MAX_AUC_BINS = 400  # AUC2.NBINS


def roc_curve_binned(y: np.ndarray, p: np.ndarray, nbins: int = MAX_AUC_BINS):
    """AUC2's design: histogram scores into <=400 threshold bins, then sweep."""
    y = np.asarray(y).astype(np.float64)
    p = np.asarray(p).astype(np.float64)
    qs = np.unique(np.quantile(p, np.linspace(0, 1, nbins)))
    bins = np.searchsorted(qs, p, side="left")
    npos = np.bincount(bins, weights=y, minlength=len(qs) + 1)
    nneg = np.bincount(bins, weights=1 - y, minlength=len(qs) + 1)
    # descending threshold sweep
    tp = np.cumsum(npos[::-1])[::-1]
    fp = np.cumsum(nneg[::-1])[::-1]
    P, Ntot = y.sum(), (1 - y).sum()
    tpr = tp / max(P, 1e-12)
    fpr = fp / max(Ntot, 1e-12)
    return qs, tpr, fpr, tp, fp, P, Ntot


def auc_exact(y: np.ndarray, p: np.ndarray) -> float:
    """Exact rank AUC (ties handled) — matches AUC2 in the limit of one bin
    per distinct score."""
    y = np.asarray(y).astype(np.float64)
    order = np.argsort(p, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(p) + 1)
    # average ranks over ties (vectorized run-length expansion)
    ps = np.asarray(p)[order]
    uniq, start = np.unique(ps, return_index=True)
    end = np.append(start[1:], len(ps))
    avg = (start + 1 + end) / 2.0
    tie_rank = np.repeat(avg, end - start)
    r = np.empty_like(tie_rank)
    r[order] = tie_rank
    npos = y.sum()
    nneg = len(y) - npos
    if npos == 0 or nneg == 0:
        return float("nan")
    return float((r[y == 1].sum() - npos * (npos + 1) / 2) / (npos * nneg))


class MetricValue(float):
    """Float that is also callable with h2o-py's method signature.

    h2o-py exposes metrics as methods (`perf.auc()`, `perf.rmse()`) while the
    internal code reads attributes (`m.auc`); wrapping plain-float fields in
    this keeps both call styles working.
    """

    __slots__ = ()

    def __call__(self, *_a, **_kw) -> float:
        return float(self)


@dataclass
class ModelMetricsBase:
    mse: float = float("nan")
    rmse: float = float("nan")
    nobs: int = 0
    description: str = ""

    def __setattr__(self, k, v):
        # dataclass __init__ assigns via setattr, so this wraps both
        # construction and later post-hoc assignments (e.g. KMeans metrics)
        if isinstance(v, (float, np.floating)) \
                and not isinstance(v, MetricValue):
            v = MetricValue(v)
        object.__setattr__(self, k, v)

    def _ser(self) -> Dict:
        return {k: float(v) if isinstance(v, MetricValue) else v
                for k, v in self.__dict__.items() if not k.startswith("_")}


@dataclass
class ModelMetricsRegression(ModelMetricsBase):
    mae: float = float("nan")
    rmsle: float = float("nan")
    r2: float = float("nan")
    mean_residual_deviance: float = float("nan")

    @staticmethod
    def make(y: np.ndarray, pred: np.ndarray) -> "ModelMetricsRegression":
        y = np.asarray(y, np.float64)
        pred = np.asarray(pred, np.float64)
        err = pred - y
        mse = float(np.mean(err**2))
        with np.errstate(invalid="ignore"):
            rmsle = (
                float(np.sqrt(np.mean((np.log1p(pred) - np.log1p(y)) ** 2)))
                if (pred > -1).all() and (y > -1).all()
                else float("nan")
            )
        var = float(np.var(y))
        return ModelMetricsRegression(
            mse=mse, rmse=float(np.sqrt(mse)), nobs=len(y),
            mae=float(np.mean(np.abs(err))), rmsle=rmsle,
            r2=1.0 - mse / var if var > 0 else float("nan"),
            mean_residual_deviance=mse,
        )


def gains_lift_table(y: np.ndarray, p: np.ndarray, groups: int = 16):
    """Quantile gains/lift table — `hex/GainsLift.java` (16 groups default):
    per group cumulative capture rate, lift, response rate."""
    y = np.asarray(y, np.float64)
    order = np.argsort(-np.asarray(p), kind="mergesort")
    ys = y[order]
    ps = np.asarray(p)[order]
    n = len(ys)
    total_pos = max(ys.sum(), 1e-12)
    bounds = np.unique((np.arange(1, groups + 1) * n) // groups)
    bounds = bounds[bounds > 0]  # n < groups would emit an empty first group
    rows = []
    prev = 0
    cum_pos = 0.0
    overall_rate = total_pos / n
    for b in bounds:
        grp = ys[prev:b]
        s = grp.sum()
        cum_pos += s
        rate = s / max(len(grp), 1)
        rows.append(dict(
            group=len(rows) + 1,
            cumulative_data_fraction=b / n,
            lower_threshold=float(ps[b - 1]),
            lift=float(rate / overall_rate),
            cumulative_lift=float((cum_pos / b) / overall_rate),
            response_rate=float(rate),
            cumulative_response_rate=float(cum_pos / b),
            capture_rate=float(s / total_pos),
            cumulative_capture_rate=float(cum_pos / total_pos),
            gain=100.0 * (rate / overall_rate - 1),
            cumulative_gain=100.0 * ((cum_pos / b) / overall_rate - 1),
        ))
        prev = b
    return rows


@dataclass
class ModelMetricsBinomial(ModelMetricsBase):
    auc: float = float("nan")
    pr_auc: float = float("nan")
    logloss: float = float("nan")
    gini: float = float("nan")
    mean_per_class_error: float = float("nan")
    f1: float = float("nan")
    accuracy: float = float("nan")
    confusion_matrix: Optional[np.ndarray] = None
    threshold: float = 0.5
    gains_lift_table: Optional[List[Dict]] = None
    _roc: Optional[tuple] = None

    def gains_lift(self):
        return self.gains_lift_table

    def roc(self):
        """(fpr, tpr) arrays over the binned threshold sweep (AUC2)."""
        return self._roc

    @staticmethod
    def make(y: np.ndarray, p: np.ndarray) -> "ModelMetricsBinomial":
        y = np.asarray(y, np.float64)
        p = np.clip(np.asarray(p, np.float64), 1e-15, 1 - 1e-15)
        auc = auc_exact(y, p)
        logloss = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
        mse = float(np.mean((p - y) ** 2))
        # max-F1 threshold via the AUC2-style binned sweep
        qs, tpr, fpr, tp, fp, P, Ntot = roc_curve_binned(y, p)
        fn = P - tp
        prec = tp / np.maximum(tp + fp, 1e-12)
        rec = tp / max(P, 1e-12)
        f1s = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
        bi = int(np.argmax(f1s))
        thr = float(qs[min(bi, len(qs) - 1)]) if len(qs) else 0.5
        yhat = (p >= thr).astype(np.float64)
        tp_, fp_ = float(((yhat == 1) & (y == 1)).sum()), float(((yhat == 1) & (y == 0)).sum())
        tn_, fn_ = float(((yhat == 0) & (y == 0)).sum()), float(((yhat == 0) & (y == 1)).sum())
        cm = np.asarray([[tn_, fp_], [fn_, tp_]])
        err0 = fp_ / max(tn_ + fp_, 1e-12)
        err1 = fn_ / max(tp_ + fn_, 1e-12)
        # pr_auc by trapezoid over recall
        order = np.argsort(rec)
        pr_auc = float(np.trapezoid(prec[order], rec[order])) if len(rec) > 1 else float("nan")
        return ModelMetricsBinomial(
            mse=mse, rmse=float(np.sqrt(mse)), nobs=len(y),
            auc=auc, pr_auc=pr_auc, logloss=logloss, gini=2 * auc - 1,
            mean_per_class_error=(err0 + err1) / 2, f1=float(f1s[bi]),
            accuracy=float((yhat == y).mean()), confusion_matrix=cm, threshold=thr,
            gains_lift_table=gains_lift_table(y, p),
            _roc=(fpr, tpr),
        )

    @staticmethod
    def from_binned(qs: np.ndarray, npos: np.ndarray, nneg: np.ndarray,
                    nll_sum: float, sq_sum: float) -> "ModelMetricsBinomial":
        """Metrics from a 400-bin score histogram — `hex/AUC2.java`'s exact
        design: every statistic (AUC/pr-AUC/max-F1/CM/gains) derives from
        per-threshold-bin (pos, neg) counts, so only ~KBs ever leave the
        device. The AUC is the binned trapezoid, which IS the reference's
        reported AUC semantics (AUC2 sweeps its 400 bins the same way)."""
        qs = np.asarray(qs, np.float64)
        npos = np.asarray(npos, np.float64)
        nneg = np.asarray(nneg, np.float64)
        # merge bins with duplicate thresholds (host roc_curve_binned
        # np.unique semantics: ties collapse into one bin)
        uq = np.unique(qs)
        npos_m = np.zeros(len(uq) + 1)
        nneg_m = np.zeros(len(uq) + 1)
        # bin b of searchsorted(qs,...) maps to searchsorted(uq,...) bins
        edge_map = np.searchsorted(uq, qs, side="left")
        full_map = np.concatenate([edge_map, [len(uq)]])
        np.add.at(npos_m, full_map, npos)
        np.add.at(nneg_m, full_map, nneg)
        npos, nneg, qs = npos_m, nneg_m, uq
        P = float(npos.sum())
        Ntot = float(nneg.sum())
        n = P + Ntot
        tp = np.cumsum(npos[::-1])[::-1]
        fp = np.cumsum(nneg[::-1])[::-1]
        tpr = tp / max(P, 1e-12)
        fpr = fp / max(Ntot, 1e-12)
        order = np.argsort(fpr)
        auc = float(np.trapezoid(
            np.r_[0.0, tpr[order], 1.0], np.r_[0.0, fpr[order], 1.0]))
        prec = tp / np.maximum(tp + fp, 1e-12)
        rec = tpr
        f1s = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
        bi = int(np.argmax(f1s))
        thr = float(qs[min(bi, len(qs) - 1)]) if len(qs) else 0.5
        # confusion at the max-F1 threshold straight from the sweep counts
        tp_, fp_ = float(tp[bi]), float(fp[bi])
        fn_, tn_ = P - tp_, Ntot - fp_
        cm = np.asarray([[tn_, fp_], [fn_, tp_]])
        err0 = fp_ / max(tn_ + fp_, 1e-12)
        err1 = fn_ / max(tp_ + fn_, 1e-12)
        oi = np.argsort(rec)
        pr_auc = (float(np.trapezoid(prec[oi], rec[oi]))
                  if len(rec) > 1 else float("nan"))
        # gains/lift from the bin counts (16 cumulative-count groups)
        glt = []
        tot = npos + nneg
        cum_rows = np.cumsum(tot[::-1])[::-1]          # rows scored >= bin
        cum_pos = tp
        prev_rows = prev_pos = 0.0
        for gidx in range(1, 17):
            target = n * gidx / 16.0
            # the group boundary may fall INSIDE a tied-score block (bins
            # cannot split ties); split the block fractionally, assuming a
            # uniform positive rate within it — the expectation of the
            # exact-sort table's arbitrary tie ordering
            sel = int(np.searchsorted(-cum_rows, -target, side="left"))
            b = min(max(sel - 1, 0), len(tot) - 1)
            if cum_rows[b] < target and b > 0:
                b -= 1
            rows_above = float(cum_rows[b + 1]) if b + 1 < len(tot) else 0.0
            pos_above = float(cum_pos[b + 1]) if b + 1 < len(tot) else 0.0
            blk_rows = max(float(cum_rows[b]) - rows_above, 1e-12)
            blk_pos = float(cum_pos[b]) - pos_above
            f = min(max((target - rows_above) / blk_rows, 0.0), 1.0)
            rows = target
            pos = pos_above + f * blk_pos
            frac = rows / max(n, 1e-12)
            capture = pos / max(P, 1e-12)
            g_rows = max(rows - prev_rows, 0.0)
            g_pos = max(pos - prev_pos, 0.0)
            g_cap = g_pos / max(P, 1e-12)
            g_frac = g_rows / max(n, 1e-12)
            cum_lift = capture / max(frac, 1e-12)
            lift = g_cap / max(g_frac, 1e-12)
            glt.append(dict(
                group=gidx, cumulative_data_fraction=frac,
                lower_threshold=float(qs[min(b, len(qs) - 1)]) if len(qs)
                else 0.0,
                lift=lift, cumulative_lift=cum_lift,
                response_rate=g_pos / max(g_rows, 1e-12),
                cumulative_response_rate=pos / max(rows, 1e-12),
                capture_rate=g_cap, cumulative_capture_rate=capture,
                gain=100.0 * (lift - 1.0),
                cumulative_gain=100.0 * (cum_lift - 1.0),
            ))
            prev_rows, prev_pos = rows, pos
        mse = sq_sum / max(n, 1e-12)
        return ModelMetricsBinomial(
            mse=mse, rmse=float(np.sqrt(mse)), nobs=int(n),
            auc=auc, pr_auc=pr_auc, logloss=nll_sum / max(n, 1e-12),
            gini=2 * auc - 1,
            mean_per_class_error=(err0 + err1) / 2, f1=float(f1s[bi]),
            accuracy=(tp_ + tn_) / max(n, 1e-12),
            confusion_matrix=cm, threshold=thr,
            gains_lift_table=glt,
            _roc=(fpr, tpr),
        )


@dataclass
class ModelMetricsMultinomial(ModelMetricsBase):
    logloss: float = float("nan")
    mean_per_class_error: float = float("nan")
    accuracy: float = float("nan")
    confusion_matrix: Optional[np.ndarray] = None

    @staticmethod
    def make(y: np.ndarray, probs: np.ndarray) -> "ModelMetricsMultinomial":
        y = np.asarray(y).astype(np.int64)
        probs = np.clip(np.asarray(probs, np.float64), 1e-15, 1.0)
        probs = probs / probs.sum(axis=1, keepdims=True)
        K = probs.shape[1]
        n = len(y)
        logloss = float(-np.mean(np.log(probs[np.arange(n), y])))
        yhat = probs.argmax(axis=1)
        cm = np.zeros((K, K))
        np.add.at(cm, (y, yhat), 1)
        with np.errstate(invalid="ignore"):
            per_class_err = 1 - np.diag(cm) / np.maximum(cm.sum(axis=1), 1e-12)
        onehot = np.zeros((n, K))
        onehot[np.arange(n), y] = 1
        mse = float(np.mean((probs - onehot) ** 2))
        return ModelMetricsMultinomial(
            mse=mse, rmse=float(np.sqrt(mse)), nobs=n, logloss=logloss,
            mean_per_class_error=float(np.nanmean(per_class_err)),
            accuracy=float((yhat == y).mean()), confusion_matrix=cm,
        )


@dataclass
class ModelMetricsClustering(ModelMetricsBase):
    tot_withinss: float = float("nan")
    betweenss: float = float("nan")
    totss: float = float("nan")


def ndcg_at_k(y: np.ndarray, score: np.ndarray, qid: np.ndarray, k: int = 10) -> float:
    """NDCG@k grouped by query — the lambdarank objective's eval metric
    (XGBoost `rank:ndcg`, used by the MSLR-WEB30K baseline config).

    The rows are grouped by one stable argsort of `qid`, so each query
    holds its rows in frame order and the queries come in `np.unique`
    order: every term and the sum are the reference's, bit for bit, in
    O(N log N) instead of its mask per query (O(Q·N))."""
    y, score, qid = np.asarray(y), np.asarray(score), np.asarray(qid)
    by_q = np.argsort(qid, kind="stable")
    qs = qid[by_q]
    cuts = np.flatnonzero(qs[1:] != qs[:-1]) + 1
    total, nq = 0.0, 0
    for rows in np.split(by_q, cuts):
        rel = y[rows]
        s = score[rows]
        if len(rel) < 2:
            continue
        order = np.argsort(-s, kind="mergesort")
        gains = (2 ** rel[order][:k] - 1) / np.log2(np.arange(2, min(k, len(rel)) + 2))
        ideal = np.sort(rel)[::-1]
        igains = (2 ** ideal[:k] - 1) / np.log2(np.arange(2, min(k, len(rel)) + 2))
        if igains.sum() > 0:
            total += gains.sum() / igains.sum()
            nq += 1
    return total / max(nq, 1)
