"""H2OIsolationForestEstimator — anomaly detection, single device.

Port of `h2o3_tpu/models/isolation_forest.py` (reference parity:
`hex/tree/isofor/IsolationForest.java`): trees isolate rows by random
(feature, threshold) splits on subsamples; the anomaly score is the
normalized mean path length (`IsolationForestModel.score0`).

The trees grow on the host, as in the reference: `np.random.default_rng`,
one `rng.choice` subsample a tree and one `rng.integers`/`rng.uniform`
draw a node over the static heap, copied verbatim, so `feat`, `thr`,
`is_split` and `leaf_n` are the reference's bit for bit (a device build
would draw in another order and give another model).

Scoring runs on the model's device: the stacked (ntrees, T) arrays walk
the rows of all trees at once in f64 (f64 rows against the f64 uniform
draws, NaN to the right), and each tree's depth + c(leaf size) is added in
tree order, as the reference's numpy walk adds it. The MOJO scorer keeps
that numpy walk (`forest_path_lengths`); its payload stores the thresholds
in f32, as the reference's does. `mtries`, `contamination` and
`score_tree_interval` are accepted by the reference and never read: only
their defaults are ported (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .metrics import ModelMetricsBase
from .model_base import H2OEstimator, H2OModel, _sync, check_unread
from .shared_tree import frame_to_matrix
from .tree import heap_size

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(mtries=-1, contamination=-1.0, score_tree_interval=0)
_EULER = 0.5772156649


def _avg_path_length(n: float) -> float:
    """c(n) from the IF paper — expected path length of an unsuccessful BST
    search (used to normalize scores, IsolationForestModel)."""
    if n <= 1:
        return 0.0
    h = np.log(n - 1) + _EULER
    return 2.0 * h - 2.0 * (n - 1) / n


def forest_path_lengths(trees, X: np.ndarray, max_depth: int) -> np.ndarray:
    """Mean path length per row over the forest, in numpy (the MOJO
    scorer's walk). `trees` = iterable of (feat, thr, is_split, leaf_n)."""
    n = X.shape[0]
    total = np.zeros(n)
    ntrees = 0
    for feat, thr, split, leaf_n in trees:
        ntrees += 1
        node = np.zeros(n, np.int64)
        depth = np.zeros(n)
        for _ in range(max_depth):
            s = split[node]
            xv = X[np.arange(n), feat[node]]
            right = np.isnan(xv) | (xv > thr[node])
            child = 2 * node + 1 + (right & s).astype(np.int64)
            depth = depth + s.astype(np.float64)
            node = np.where(s, child, node)
        # add c(leaf size): unresolved subtree correction
        ln = leaf_n[node]
        with np.errstate(divide="ignore", invalid="ignore"):
            corr = np.where(
                ln > 1,
                2.0 * (np.log(np.maximum(ln - 1, 1)) + _EULER)
                - 2.0 * (ln - 1) / np.maximum(ln, 1),
                0.0,
            )
        total += depth + corr
    return total / max(ntrees, 1)


def forest_path_lengths_device(feat: torch.Tensor, thr: torch.Tensor,
                               split: torch.Tensor, leaf_n: torch.Tensor,
                               X: torch.Tensor, max_depth: int) -> torch.Tensor:
    """`forest_path_lengths` on the stacked (ntrees, T) arrays where they
    lie: one gather round per level for all trees at once on f64 rows X
    (N, F), then depth + c(leaf size) added tree by tree in f64."""
    nt = feat.shape[0]
    N = X.shape[0]
    node = torch.zeros((nt, N), dtype=torch.int64, device=X.device)
    depth = torch.zeros((nt, N), dtype=torch.float64, device=X.device)
    rows = torch.arange(N, device=X.device)[None, :]
    for _ in range(max_depth):
        s = split.gather(1, node)
        xv = X[rows, feat.gather(1, node)]
        right = torch.isnan(xv) | (xv > thr.gather(1, node))
        depth = depth + s.to(torch.float64)
        node = torch.where(s, 2 * node + 1 + (right & s).to(torch.int64),
                           node)
    ln = leaf_n.gather(1, node)
    corr = torch.where(
        ln > 1,
        2.0 * (torch.log(torch.clamp(ln - 1, min=1)) + _EULER)
        - 2.0 * (ln - 1) / torch.clamp(ln, min=1),
        torch.zeros_like(ln))
    per_tree = depth + corr
    total = torch.zeros(N, dtype=torch.float64, device=X.device)
    for t in range(nt):
        total = total + per_tree[t]
    return total / max(nt, 1)


def anomaly_scores(path_lengths: np.ndarray, sample_size: int) -> np.ndarray:
    c = _avg_path_length(sample_size)
    return np.power(2.0, -path_lengths / max(c, 1e-12))


class IsolationForestModel(H2OModel):
    algo = "isolationforest"

    def __init__(self, params, x, trees, sample_size, max_depth, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = None
        self.trees = trees  # list of numpy (feat, thr, is_split, leaf_n)
        self.sample_size = sample_size
        self.max_depth = max_depth
        self.device = devlib.resolve(device)
        # the stacked forest on the scoring device, (ntrees, T) each
        T = heap_size(max_depth)
        self._stacked = tuple(
            torch.from_numpy(np.asarray([t[i] for t in trees], dt).reshape(
                len(trees), T)).to(self.device)
            for i, dt in enumerate((np.int64, np.float64, bool, np.float64)))

    def _path_lengths(self, X: np.ndarray) -> np.ndarray:
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float64)).to(
            self.device)
        return forest_path_lengths_device(*self._stacked, Xd,
                                          self.max_depth).cpu().numpy()

    def predict(self, test_data: Frame) -> Frame:
        X, _, _ = frame_to_matrix(test_data, self.x)
        pl = self._path_lengths(X)
        score = anomaly_scores(pl, self.sample_size)
        return Frame.from_dict({"predict": score, "mean_length": pl})

    def _make_metrics(self, frame: Frame):
        return ModelMetricsBase(nobs=frame.nrow)


class H2OIsolationForestEstimator(H2OEstimator):
    algo = "isolationforest"
    supervised = False
    _param_defaults = dict(
        ntrees=50,
        max_depth=8,
        sample_size=256,
        sample_rate=-1.0,
        mtries=-1,
        contamination=-1.0,
        score_tree_interval=0,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> IsolationForestModel:
        p = self._parms
        check_unread("IsolationForest", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        seed = p["_actual_seed"]
        t0 = time.perf_counter()
        X, _, _ = frame_to_matrix(train, x)
        n, F = X.shape
        rng = np.random.default_rng(seed)
        sample_size = int(p.get("sample_size", 256))
        if p.get("sample_rate", -1.0) and float(p.get("sample_rate", -1.0)) > 0:
            sample_size = max(2, int(float(p["sample_rate"]) * n))
        sample_size = min(sample_size, n)
        D = int(p.get("max_depth", 8))
        T = heap_size(D)
        ntrees = int(p.get("ntrees", 50))

        trees = []
        for t in range(ntrees):
            idx = rng.choice(n, sample_size, replace=False)
            Xs = X[idx]
            feat = np.zeros(T, np.int64)
            thr = np.zeros(T)
            split = np.zeros(T, bool)
            leaf_n = np.zeros(T)
            # iterative random splitting over the static heap
            members = {0: np.arange(sample_size)}
            for node in range(T):
                rows = members.get(node)
                if rows is None:
                    leaf_n[node] = 0
                    continue
                leaf_n[node] = len(rows)
                depth = int(np.floor(np.log2(node + 1)))
                if depth >= D or len(rows) <= 1:
                    continue
                f = rng.integers(0, F)
                col = Xs[rows, f]
                cmin, cmax = np.nanmin(col), np.nanmax(col)
                if not np.isfinite(cmin) or cmin >= cmax:
                    continue
                cut = rng.uniform(cmin, cmax)
                feat[node] = f
                thr[node] = cut
                split[node] = True
                right = np.isnan(col) | (col > cut)
                members[2 * node + 1] = rows[~right]
                members[2 * node + 2] = rows[right]
            trees.append((feat, thr, split, leaf_n))
        t_build = time.perf_counter()

        model = IsolationForestModel(self, x, trees, sample_size, D,
                                     device=dev)
        _sync(dev)
        t_up = time.perf_counter()
        model.training_metrics = ModelMetricsBase(nobs=n)
        scores = model.predict(train).vec("predict").numeric_np()
        model.training_metrics.description = f"mean_score={scores.mean():.4f}"
        t_end = time.perf_counter()
        # host-clock split: the host tree build (frame matrix included),
        # the forest's upload, and scoring the training frame for the
        # metrics
        model.fit_timings = dict(build_s=t_build - t0, h2d_s=t_up - t_build,
                                 metrics_s=t_end - t_up, total_s=t_end - t0)
        return model


IsolationForest = H2OIsolationForestEstimator
