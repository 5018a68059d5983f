"""H2OAggregatorEstimator — exemplar-based dataset aggregation, single device.

Port of `h2o3_tpu/models/aggregator.py` (reference parity:
`hex/aggregator/Aggregator.java`: one pass over the rows in order, a row
joining the nearest exemplar within the radius or becoming a new exemplar
with count 1, and the radius rescaled between passes until the exemplar
count lands within `rel_tol_num_exemplars` of `target_num_exemplars`. The
output is the aggregated frame: one row per exemplar plus `counts`).

The design is the reference's `DataInfo` expansion (NORMALIZE standardizes,
all factor levels), in f32. Each pass runs the reference's block step on
the device: `assign_block` takes a block of 4,096 rows against the
exemplars found so far as ‖a‖² − 2·a·eᵀ + ‖e‖² in f32 (the reference's
expansion, not `torch.cdist`, which picks another formula by size; true
f32 products, TF32 off, or the distances move by ≈1e-3 relative and the
exemplar set with them), masks the buffer's unused rows and takes the
first minimum. The design lives on the device once per fit and the
exemplar buffer there grows with the host's. What the reference keeps on
the host stays there, in numpy f32: the rows beyond the radius, in order,
each against the exemplars appended so far (`_aggregate`), and the radius
bisection.

`num_iteration_without_new_exemplar` and `save_mapping_frame` are accepted
by the reference and never read: only their defaults are ported (ROADMAP
§C). `predict` raises, and the MOJO export raises `TypeError`, as in the
reference.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .metrics import ModelMetricsBase
from .model_base import (DataInfo, H2OEstimator, H2OModel, _sync, check_unread,
                         warn_host_solver)

_BLOCK = 4096
_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(num_iteration_without_new_exemplar=500, save_mapping_frame=False)


def assign_block(block: torch.Tensor, ex: torch.Tensor, n_ex: int):
    """Nearest live exemplar id (first on ties) and its squared distance
    for each row of `block` (B, p) f32 against the buffer `ex` (cap, p),
    whose rows ≥ n_ex are masked out."""
    d2 = ((block * block).sum(dim=1, keepdim=True)
          - (2.0 * block) @ ex.t()
          + (ex * ex).sum(dim=1)[None, :])
    live = torch.arange(ex.shape[0], device=ex.device)[None, :] < n_ex
    d2 = torch.where(live, d2, torch.full_like(d2, float("inf")))
    j = torch.argmin(d2, dim=1)
    return j, d2.gather(1, j[:, None])[:, 0]


def aggregate(Xd: torch.Tensor, X: np.ndarray, radius2: float, timings=None):
    """One pass: (exemplar row indices, member counts f64). `Xd` is the
    (n, p) f32 design on the device, `X` the same on the host."""
    n, pdim = X.shape
    dev = Xd.device
    cap = 256
    ex_buf = np.zeros((cap, pdim), np.float32)
    ex_buf[0] = X[0]
    ex_d = torch.zeros((cap, pdim), dtype=torch.float32, device=dev)
    ex_d[0] = Xd[0]
    n_ex = 1
    ex_idx = [0]
    counts = [1]
    t_dev = t_host = 0.0
    i = 1
    while i < n:
        t0 = time.perf_counter()
        j, d2 = assign_block(Xd[i:i + _BLOCK], ex_d, n_ex)
        j = j.cpu().numpy()
        d2 = d2.cpu().numpy()
        t1 = time.perf_counter()
        block = X[i:i + _BLOCK]
        ok = d2 <= radius2
        # rows within the radius of an existing exemplar: bulk-assign
        for jj in j[ok]:
            counts[jj] += 1
        # the rest in order: each may become a new exemplar that absorbs
        # later rows of the same block
        n_before = n_ex
        for ridx in np.nonzero(~ok)[0]:
            row = block[ridx]
            d2r = np.sum((ex_buf[:n_ex] - row) ** 2, axis=1)
            jj = int(np.argmin(d2r))
            if d2r[jj] <= radius2:
                counts[jj] += 1
            else:
                if n_ex == cap:  # grow capacity (power of two)
                    cap *= 2
                    nb = np.zeros((cap, pdim), np.float32)
                    nb[:n_ex] = ex_buf
                    ex_buf = nb
                ex_buf[n_ex] = row
                n_ex += 1
                ex_idx.append(i + int(ridx))
                counts.append(1)
        if n_ex > n_before:
            if ex_d.shape[0] != cap:
                grown = torch.zeros((cap, pdim), dtype=torch.float32, device=dev)
                grown[:n_before] = ex_d[:n_before]
                ex_d = grown
            ex_d[n_before:n_ex] = torch.from_numpy(ex_buf[n_before:n_ex]).to(dev)
        t_dev += t1 - t0
        t_host += time.perf_counter() - t1
        i += _BLOCK
    if timings is not None:
        timings["block_s"] = timings.get("block_s", 0.0) + t_dev
        timings["host_loop_s"] = timings.get("host_loop_s", 0.0) + t_host
    return np.asarray(ex_idx), np.asarray(counts, np.float64)


class AggregatorModel(H2OModel):
    algo = "aggregator"

    def __init__(self, params, x, dinfo, aggregated, exemplar_idx, counts):
        super().__init__(params)
        self.x = list(x)
        self.y = None
        self.dinfo = dinfo
        self._aggregated = aggregated
        self.exemplar_idx = exemplar_idx
        self.counts = counts

    @property
    def aggregated_frame(self) -> Frame:
        return self._aggregated

    def predict(self, test_data: Frame) -> Frame:
        raise ValueError("aggregator does not support predict(); use aggregated_frame")

    def _make_metrics(self, frame: Frame):
        return self.training_metrics


class H2OAggregatorEstimator(H2OEstimator):
    algo = "aggregator"
    supervised = False
    _param_defaults = dict(
        target_num_exemplars=5000,
        rel_tol_num_exemplars=0.5,
        transform="NORMALIZE",
        num_iteration_without_new_exemplar=500,
        save_mapping_frame=False,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> AggregatorModel:
        warn_host_solver('aggregator', train.nrow, 200000)
        p = self._parms
        check_unread("Aggregator", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        transform = p.get("transform", "NORMALIZE")
        dinfo = DataInfo(train, x, standardize=transform != "NONE",
                         use_all_factor_levels=True)
        X = dinfo.fit_transform(train).astype(np.float32)
        n, pdim = X.shape
        target = int(p.get("target_num_exemplars", 5000))
        tol = float(p.get("rel_tol_num_exemplars", 0.5))
        timings = dict(design_s=time.perf_counter() - t0)
        passes = []

        if target >= n:
            # fewer rows than requested exemplars: every row is an exemplar
            # (radius 0, the reference's degenerate small-data case)
            idx, counts = np.arange(n), np.ones(n, np.float64)
        else:
            t1 = time.perf_counter()
            Xd = torch.from_numpy(X).to(dev)
            _sync(dev)
            timings["h2d_s"] = time.perf_counter() - t1
            # radius search: bisection on the radius until the exemplar
            # count is within the relative tolerance of the target
            r2 = float(pdim) * 0.1
            lo, hi = None, None
            best = None
            for _ in range(20):
                idx, counts = aggregate(Xd, X, r2, timings)
                e = len(idx)
                passes.append(dict(radius2=r2, exemplars=e))
                best = (idx, counts)
                if e > target * (1 + tol):   # too many exemplars: grow
                    lo = r2
                    r2 = r2 * 4 if hi is None else (r2 + hi) / 2
                elif e >= target * (1 - tol):
                    break
                else:                        # too few: shrink
                    hi = r2
                    r2 = r2 / 4 if lo is None else (r2 + lo) / 2
            idx, counts = best
            del Xd

        cols = {}
        for name in train.names:
            cols[name] = train.vec(name).take(np.asarray(idx))
        agg = Frame(cols)
        agg["counts"] = counts
        model = AggregatorModel(self, x, dinfo, agg, idx, counts)
        model.training_metrics = ModelMetricsBase(nobs=n)
        timings["total_s"] = time.perf_counter() - t0
        model.fit_timings = timings
        model.passes = passes
        return model


Aggregator = H2OAggregatorEstimator
