"""H2OExtendedIsolationForestEstimator — EIF anomaly detection, single
device.

Port of `h2o3_tpu/models/extended_isolation_forest.py` (reference parity:
`hex/tree/isoforextended/ExtendedIsolationForest.java`): each node splits
on a random oblique hyperplane — direction n with `extension_level`+1
non-zero components, intercept drawn uniformly inside the node's projected
range; anomaly score 2^(−E[pathlen]/c(sample_size)).

The draws stay on the host, copied verbatim from the reference: per tree
one `rng.choice` subsample, `rng.normal` directions, the extension mask
loop, the f32 normalisation and `rng.uniform` intercept draws, so the
directions and draws are the reference's bit for bit. The matrix is
`DataInfo(standardize=False, use_all_factor_levels=True)`'s f32 expansion,
the reference's byte for byte, uploaded once; all trees' draws are
uploaded together.

Each tree builds on the device level by level over its static heap of
depth ceil(log2(sample_size)): the rows' projections on their node's
direction, the per-node range as `scatter_reduce` amin/amax (the
reference's `segment_min`/`segment_max`, with its 3.4e38 sentinels for
rows that have stopped), the counts, and the intercept
thr = pmin + u·(pmax − pmin) rounded once to f32 (`ops.quantiles.fma_f32`: XLA on the
CPU contracts it into one fused multiply-add). At `extension_level` 0 a
direction has one non-zero component, so the projections are exact and
the thresholds are the reference's bit for bit; above it the projection's
sum adds in another order than `jnp.sum`, and thresholds agree within
f32 rounding.

Scoring walks the rows tree by tree on the device (no (ntrees, N, p)
gather is held at once): each row's stopping depth plus the c(n) credit
of its leaf's training rows, in f32 as the reference; the mean over trees
is taken in f64. `disable_training_metrics` is accepted by the reference
and never read: only its default is ported (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from ..ops.quantiles import fma_f32
from .metrics import ModelMetricsBase
from .model_base import DataInfo, H2OEstimator, H2OModel, _sync, check_unread

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(disable_training_metrics=True)
_BIG = 3.4e38
_EULER = 0.5772156649


def _avg_path(n):
    """c(n): average unsuccessful-search path length in a BST (IF paper)."""
    n = np.maximum(n, 2.0)
    return 2.0 * (np.log(n - 1.0) + _EULER) - 2.0 * (n - 1.0) / n


def build_eif_tree(Xs: torch.Tensor, dirs: torch.Tensor, us: torch.Tensor,
                   depth: int):
    """Build one EIF tree over the (S, p) f32 subsample on its device.

    dirs: (T, p) random directions (already masked to the extension level),
    us: (T,) U(0,1) draws for the intercepts. Returns (thr (T,) f32,
    is_split (T,) bool, counts (2T+1,) f32): the training rows of each
    node where its walk stops (the c(n) credit)."""
    S = Xs.shape[0]
    T = dirs.shape[0]               # internal heap: 2^depth - 1
    Tfull = 2 ** (depth + 1) - 1    # + terminal level
    dev = Xs.device
    idx = torch.zeros(S, dtype=torch.int64, device=dev)
    alive = torch.ones(S, dtype=torch.bool, device=dev)
    thr_a = torch.zeros(T, dtype=torch.float32, device=dev)
    split_a = torch.zeros(T, dtype=torch.bool, device=dev)
    count_a = torch.zeros(Tfull, dtype=torch.float32, device=dev)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    for d in range(depth):
        L = 2 ** d
        base = L - 1
        proj = torch.sum(Xs * dirs[base + idx], dim=1)        # (S,)
        # empty segments keep segment_min/max's identities, ±inf
        pmin = torch.full((L,), float("inf"), device=dev).scatter_reduce(
            0, idx, torch.where(alive, proj, big), "amin")
        pmax = torch.full((L,), float("-inf"), device=dev).scatter_reduce(
            0, idx, torch.where(alive, proj, -big), "amax")
        cnt = torch.zeros(L, dtype=torch.float32, device=dev).index_add_(
            0, idx, alive.to(torch.float32))
        can_split = (cnt > 1.0) & (pmax > pmin)
        thr = fma_f32(pmin, us[base:base + L], pmax - pmin)
        zero = torch.zeros_like(thr)
        thr_a[base:base + L] = torch.where(can_split, thr, zero)
        split_a[base:base + L] = can_split
        # leaf nodes at this level keep their row count (the c(n) credit)
        count_a[base:base + L] = torch.where(can_split, zero, cnt)

        node_splits = can_split[idx]
        go_right = alive & node_splits & (proj > thr[idx])
        idx = torch.where(alive & node_splits,
                          2 * idx + go_right.to(torch.int64), idx)
        alive = alive & node_splits

    # terminal level: count rows per cell
    Lf = 2 ** depth
    count_a[Lf - 1:] = torch.zeros(Lf, dtype=torch.float32,
                                   device=dev).index_add_(
        0, idx, alive.to(torch.float32))
    return thr_a, split_a, count_a


def eif_path_lengths(X: torch.Tensor, dirs: torch.Tensor, thrs: torch.Tensor,
                     splits: torch.Tensor, counts: torch.Tensor,
                     depth: int) -> torch.Tensor:
    """(N,) f64 mean over trees of each row's path length (its stopping
    depth + the c(leaf size) credit, in f32 per tree), walked tree by tree
    where X (N, p) f32 lies."""
    N = X.shape[0]
    dev = X.device
    total = torch.zeros(N, dtype=torch.float64, device=dev)
    nt = dirs.shape[0]
    for t in range(nt):
        dirs_t, thr_t, split_t = dirs[t], thrs[t], splits[t]
        idx = torch.zeros(N, dtype=torch.int64, device=dev)
        depth_stop = torch.full((N,), float(depth), dtype=torch.float32,
                                device=dev)
        stop_node = torch.zeros(N, dtype=torch.int64, device=dev)
        live = torch.ones(N, dtype=torch.bool, device=dev)
        for d in range(depth):
            node = (2 ** d - 1) + idx
            s = split_t[node]
            proj = torch.sum(X * dirs_t[node], dim=1)
            stopping = live & ~s
            depth_stop = torch.where(stopping, float(d), depth_stop)
            stop_node = torch.where(stopping, node, stop_node)
            live = live & s
            go_right = live & (proj > thr_t[node])
            idx = torch.where(live, 2 * idx + go_right.to(torch.int64), idx)
        stop_node = torch.where(live, 2 ** depth - 1 + idx, stop_node)
        # unresolved-subtree credit: c(n) for leaves holding n>1 training rows
        nleaf = counts[t][stop_node]
        credit = torch.where(
            nleaf > 1.5,
            2.0 * (torch.log(torch.clamp(nleaf - 1.0, min=1.0)) + _EULER)
            - 2.0 * (nleaf - 1.0) / torch.clamp(nleaf, min=1.0),
            torch.zeros_like(nleaf))
        total = total + (depth_stop + credit).to(torch.float64)
    return total / max(nt, 1)


class ExtendedIsolationForestModel(H2OModel):
    algo = "extendedisolationforest"

    def __init__(self, params, x, dinfo, dirs, thrs, splits, counts, depth,
                 sample_size, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = None
        self.dinfo = dinfo
        self.device = devlib.resolve(device)
        self.dirs = dirs.to(self.device)        # (ntrees, T, p) f32
        self.thrs = thrs.to(self.device)        # (ntrees, T) f32
        self.splits = splits.to(self.device)    # (ntrees, T) bool
        self.counts = counts.to(self.device)    # (ntrees, 2T+1) f32
        self.depth = depth
        self.sample_size = sample_size

    def predict(self, test_data: Frame) -> Frame:
        X = torch.from_numpy(self.dinfo.transform(test_data)).to(self.device)
        mean_length = eif_path_lengths(X, self.dirs, self.thrs, self.splits,
                                       self.counts, self.depth).cpu().numpy()
        score = 2.0 ** (-mean_length / _avg_path(self.sample_size))
        return Frame.from_dict({"anomaly_score": score,
                                "mean_length": mean_length})

    def _make_metrics(self, frame: Frame):
        return self.training_metrics


class H2OExtendedIsolationForestEstimator(H2OEstimator):
    algo = "extendedisolationforest"
    supervised = False
    _param_defaults = dict(
        ntrees=100,
        sample_size=256,
        extension_level=0,
        disable_training_metrics=True,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]):
        p = self._parms
        check_unread("ExtendedIsolationForest", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        # the reference's own DataInfo: `use_all_factor_levels` stays True
        # on an all-numeric frame too (its payload records it), where
        # `estimator_engine.host_matrix` would normalize it out
        dinfo = DataInfo(train, x, standardize=False,
                         use_all_factor_levels=True)
        X = dinfo.fit_transform(train)
        n, pdim = X.shape
        ntrees = int(p.get("ntrees", 100))
        S = min(int(p.get("sample_size", 256)), n)
        depth = max(int(np.ceil(np.log2(max(S, 2)))), 1)
        T = 2 ** depth - 1  # internal heap levels 0..depth-1
        ext = int(p.get("extension_level", 0))
        if not 0 <= ext <= pdim - 1:
            raise ValueError(f"extension_level must be in [0, {pdim-1}]")
        seed = int(self._parms.get("_actual_seed", 1234))
        rng = np.random.default_rng(seed)

        # the reference's draws, tree by tree in its order
        rows_all, dirs_all, us_all = [], [], []
        for t in range(ntrees):
            rows = rng.choice(n, size=S, replace=False)
            d = rng.normal(size=(T, pdim)).astype(np.float32)
            # extension_level e ⇒ e+1 non-zero components per direction
            if ext < pdim - 1:
                mask = np.zeros((T, pdim), np.float32)
                for i in range(T):
                    keep = rng.choice(pdim, size=ext + 1, replace=False)
                    mask[i, keep] = 1.0
                d = d * mask
            d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
            us = rng.uniform(size=T).astype(np.float32)
            rows_all.append(rows)
            dirs_all.append(d)
            us_all.append(us)
        t_draw = time.perf_counter()
        Xd = torch.from_numpy(X).to(dev)
        rows_d = torch.from_numpy(np.stack(rows_all)).to(dev)
        dirs_d = torch.from_numpy(np.stack(dirs_all)).to(dev)
        us_d = torch.from_numpy(np.stack(us_all)).to(dev)
        _sync(dev)
        t_up = time.perf_counter()
        built = [build_eif_tree(Xd[rows_d[t]], dirs_d[t], us_d[t], depth)
                 for t in range(ntrees)]
        thrs, splits, counts = (torch.stack([b[i] for b in built])
                                for i in range(3))
        _sync(dev)
        t_trees = time.perf_counter()
        model = ExtendedIsolationForestModel(
            self, x, dinfo, dirs_d, thrs, splits, counts, depth, S,
            device=dev)
        model.training_metrics = ModelMetricsBase(nobs=n)
        # host-clock split: the host matrix and draws, their upload, and
        # the tree builds on the device
        model.fit_timings = dict(host_s=t_draw - t0, h2d_s=t_up - t_draw,
                                 trees_s=t_trees - t_up,
                                 total_s=t_trees - t0)
        return model


ExtendedIsolationForest = H2OExtendedIsolationForestEstimator
