"""H2OIsotonicRegressionEstimator — weighted isotonic (monotone) regression.

Port of `h2o3_tpu/models/isotonic.py` (reference parity:
`hex/isotonic/IsotonicRegression.java` +
`hex/isotonic/PoolAdjacentViolatorsDriver.java`: sort by the single
feature, run weighted pool-adjacent-violators, keep the (x, y) knots;
scoring clips or NAs out-of-bounds inputs per `out_of_bounds`).

`pav` is an inherently sequential merge of adjacent pools and stays host
numpy, copied verbatim (the mergesort, the tie aggregation and the stack
loop), so the knots are the reference's bit for bit. Scoring (`_score`)
runs on the model's device in f64: torch has no `interp`, so it finds each
row's knot interval with `torch.searchsorted` and evaluates numpy's own
formula, slope·(x − xp[j]) + fp[j] with the slopes taken over the knots,
`x == xp[-1]` giving fp[-1] and rows outside the knots the end values — the
same values `np.interp` gives. `custom_metric_func` is accepted by the
reference and never read: only its default is ported (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .metrics import ModelMetricsRegression
from .model_base import (H2OEstimator, H2OModel, _sync, check_unread,
                         warn_host_solver)

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(custom_metric_func=None)


def pav(x: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Weighted pool-adjacent-violators on (x, y, w) sorted by x.

    Returns the isotonic knot arrays (thresholds_x, thresholds_y) — one knot
    per final pool, as the reference's PoolAdjacentViolatorsDriver produces.
    """
    order = np.argsort(x, kind="mergesort")
    x, y, w = x[order], y[order], w[order]
    # collapse duplicate x to weighted means first (reference aggregates ties)
    ux, start = np.unique(x, return_index=True)
    end = np.append(start[1:], len(x))
    wy = np.array([np.sum(y[s:e] * w[s:e]) for s, e in zip(start, end)])
    ws = np.array([np.sum(w[s:e]) for s, e in zip(start, end)])
    my = wy / np.maximum(ws, 1e-300)

    # stack-based PAV: each pool = (sum_wy, sum_w, first_idx)
    vals = np.empty(len(ux))
    wts = np.empty(len(ux))
    first = np.empty(len(ux), np.int64)
    top = 0
    for i in range(len(ux)):
        vals[top], wts[top], first[top] = my[i] * ws[i], ws[i], i
        top += 1
        while top > 1 and vals[top - 2] / wts[top - 2] >= vals[top - 1] / wts[top - 1]:
            vals[top - 2] += vals[top - 1]
            wts[top - 2] += wts[top - 1]
            top -= 1
    means = vals[:top] / wts[:top]
    # knots at the first x of each pool plus the trailing x, so interpolation
    # reproduces the step/linear fit on pool boundaries
    tx, ty = [], []
    for k in range(top):
        lo = first[k]
        hi = (first[k + 1] - 1) if k + 1 < top else len(ux) - 1
        tx.append(ux[lo])
        ty.append(means[k])
        if hi > lo:
            tx.append(ux[hi])
            ty.append(means[k])
    return np.asarray(tx, np.float64), np.asarray(ty, np.float64)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """`np.interp(x, xp, fp)` for f64 tensors on their device: xp rising,
    the end values outside [xp[0], xp[-1]], NaN in → NaN out. For j the
    last knot with xp[j] ≤ x < xp[j + 1] it is numpy's
    slope[j]·(x − xp[j]) + fp[j] with slope[j] = (fp[j+1] − fp[j]) /
    (xp[j+1] − xp[j]), and fp[-1] at x == xp[-1]."""
    m = xp.shape[0]
    if m == 1:
        out = fp[0].expand_as(x).clone()
    else:
        j = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, m - 2)
        slope = (fp[1:] - fp[:-1]) / (xp[1:] - xp[:-1])
        out = slope[j] * (x - xp[j]) + fp[j]
        out = torch.where(x == xp[-1], fp[-1], out)
        out = torch.where(x > xp[-1], fp[-1], out)
    out = torch.where(x < xp[0], fp[0], out)
    return torch.where(torch.isnan(x), x, out)


class IsotonicRegressionModel(H2OModel):
    algo = "isotonicregression"

    def __init__(self, params, x, y, tx, ty, out_of_bounds, device=None):
        super().__init__(params)
        self.x = x
        self.y = y
        self.thresholds_x = tx
        self.thresholds_y = ty
        self.out_of_bounds = out_of_bounds
        self.device = devlib.resolve(device)
        self._knots = tuple(torch.from_numpy(np.asarray(a, np.float64)).to(
            self.device) for a in (tx, ty))

    def _score(self, col: np.ndarray) -> np.ndarray:
        tx, ty = self._knots
        cd = torch.from_numpy(np.ascontiguousarray(col, np.float64)).to(
            self.device)
        p = interp(cd, tx, ty)
        if self.out_of_bounds.lower() == "na":
            p = torch.where((cd < tx[0]) | (cd > tx[-1]),
                            torch.full_like(p, float("nan")), p)
        return p.cpu().numpy()

    def predict(self, test_data: Frame) -> Frame:
        p = self._score(test_data.vec(self.x).numeric_np())
        return Frame.from_dict({"predict": p})

    def _make_metrics(self, frame: Frame):
        p = self._score(frame.vec(self.x).numeric_np())
        yv = frame.vec(self.y).numeric_np()
        ok = ~np.isnan(p) & ~np.isnan(yv)
        return ModelMetricsRegression.make(yv[ok], p[ok])


class H2OIsotonicRegressionEstimator(H2OEstimator):
    algo = "isotonicregression"
    _param_defaults = dict(out_of_bounds="NA", custom_metric_func=None)

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]):
        warn_host_solver('isotonicregression', train.nrow, 2000000)
        if len(x) != 1:
            raise ValueError("isotonicregression expects exactly one feature column")
        check_unread("IsotonicRegression", _ITEM10, self._parms, _UNREAD)
        dev = devlib.resolve(self._parms.get("device"))
        t0 = time.perf_counter()
        xn = x[0]
        col = train.vec(xn).numeric_np()
        yv = train.vec(y).numeric_np()
        wcol = self._parms.get("weights_column")
        w = train.vec(wcol).numeric_np() if wcol else np.ones_like(yv)
        ok = ~np.isnan(col) & ~np.isnan(yv)
        tx, ty = pav(col[ok], yv[ok], w[ok])
        t_pav = time.perf_counter()
        model = IsotonicRegressionModel(
            self, xn, y, tx, ty, str(self._parms.get("out_of_bounds", "NA")),
            device=dev)
        model.training_metrics = model._make_metrics(train)
        if valid is not None:
            model.validation_metrics = model._make_metrics(valid)
        _sync(dev)
        t_end = time.perf_counter()
        # host-clock split: the host PAV (sort, ties, pools), the knots'
        # upload and the metrics scored on the device
        model.fit_timings = dict(pav_s=t_pav - t0, metrics_s=t_end - t_pav,
                                 total_s=t_end - t0)
        return model

    def _cv_predict(self, model: IsotonicRegressionModel, frame: Frame) -> np.ndarray:
        return model._score(frame.vec(model.x).numeric_np())
