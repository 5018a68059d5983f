"""H2OModelSelectionEstimator — best-subset GLM predictor selection.

Port of `h2o3_tpu/models/modelselection.py` (reference parity:
`hex/modelselection/ModelSelection.java`, `mode` ∈ {allsubsets, maxr,
maxrsweep, forward, backward}: per subset size the predictor set of the
highest R² (gaussian), or of the lowest logloss, by exhaustive enumeration
(allsubsets), greedy add with a pairwise swap sweep (maxr, maxrsweep),
greedy add alone (forward), or greedy drop (backward)).

The search is the reference's host loop, copied verbatim, with its
`r2 + 1e-12` improvement rule for a swap. Every candidate is a fit of the
port's `H2OGeneralizedLinearEstimator(family, lambda_=0.0, standardize)`
on the model's device, and its R² (−logloss where the metrics have no R²)
is the GLM's training metric: R² at f32 precision, so two candidates
within the GLM's rounding of each other may rank in another order than
the reference's. `p_values_threshold`, `lambda_`, `alpha`, `intercept` and
`build_glm_model` are accepted by the reference and never read: only their
defaults are ported (ROADMAP §C). The reference exports no MOJO of this
model, nor does the port.
"""

from __future__ import annotations

import itertools
import time
from typing import List, Optional

import numpy as np

from .. import device as devlib
from ..frame.frame import Frame
from .glm import H2OGeneralizedLinearEstimator
from .metrics import ModelMetricsBase
from .model_base import H2OEstimator, H2OModel, check_unread

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(p_values_threshold=0.0, lambda_=None, alpha=None,
               intercept=True, build_glm_model=False)


class ModelSelectionModel(H2OModel):
    algo = "modelselection"

    def __init__(self, params, x, y, results, best_glms):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self._results = results    # [{size, predictors, r2, model_idx}]
        self._best = best_glms     # parallel list of fitted GLM estimators

    def result(self) -> Frame:
        return Frame.from_dict({
            "model_size": np.asarray([r["size"] for r in self._results], np.float64),
            "predictor_names": np.asarray(
                [", ".join(r["predictors"]) for r in self._results], dtype=object),
            "r2": np.asarray([r["r2"] for r in self._results], np.float64),
        })

    def get_best_model_predictors(self):
        return [r["predictors"] for r in self._results]

    def get_best_r2_values(self):
        return [r["r2"] for r in self._results]

    def coef(self, predictor_size: Optional[int] = None):
        if predictor_size is None:
            return [g.coef() for g in self._best]
        for r, g in zip(self._results, self._best):
            if r["size"] == predictor_size:
                return g.coef()
        raise ValueError(f"no model of size {predictor_size}")

    def predict(self, test_data: Frame) -> Frame:
        return self._best[-1].predict(test_data)

    def _make_metrics(self, frame: Frame):
        return self._best[-1].model._make_metrics(frame)


class H2OModelSelectionEstimator(H2OEstimator):
    algo = "modelselection"
    _param_defaults = dict(
        family="AUTO",
        mode="maxr",
        max_predictor_number=1,
        min_predictor_number=1,
        p_values_threshold=0.0,
        lambda_=None,
        alpha=None,
        standardize=True,
        intercept=True,
        build_glm_model=False,
    )

    def _glm_r2(self, preds: List[str], y, train: Frame):
        g = H2OGeneralizedLinearEstimator(
            family=self._parms.get("family", "AUTO"),
            lambda_=0.0,
            standardize=bool(self._parms.get("standardize", True)),
            device=self._dev,
        )
        g.train(x=preds, y=y, training_frame=train)
        self._n_fits += 1
        m = g.model.training_metrics
        r2 = getattr(m, "r2", float("nan"))
        if np.isnan(r2):  # classification: use 1 - logloss ordering surrogate
            r2 = -getattr(m, "logloss", float("nan"))
        return g, float(r2)

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> ModelSelectionModel:
        p = self._parms
        check_unread("ModelSelection", _ITEM10, p, _UNREAD)
        self._dev = devlib.resolve(p.get("device"))
        self._n_fits = 0
        t0 = time.perf_counter()
        mode = str(p.get("mode", "maxr")).lower()
        maxp = min(int(p.get("max_predictor_number", 1)), len(x))
        minp = max(int(p.get("min_predictor_number", 1)), 1)
        results, best_glms = [], []

        if mode in ("allsubsets",):
            for size in range(minp, maxp + 1):
                best = (None, -np.inf, None)
                for combo in itertools.combinations(x, size):
                    g, r2 = self._glm_r2(list(combo), y, train)
                    if r2 > best[1]:
                        best = (list(combo), r2, g)
                results.append(dict(size=size, predictors=best[0], r2=best[1]))
                best_glms.append(best[2])
        elif mode in ("maxr", "maxrsweep", "forward"):
            current: List[str] = []
            for size in range(1, maxp + 1):
                # greedy add
                best = (None, -np.inf, None)
                for c in x:
                    if c in current:
                        continue
                    cand = current + [c]
                    g, r2 = self._glm_r2(cand, y, train)
                    if r2 > best[1]:
                        best = (cand, r2, g)
                current, r2, g = best
                if mode in ("maxr", "maxrsweep"):
                    # pairwise replacement sweep until no improvement
                    improved = True
                    while improved:
                        improved = False
                        for i, old in enumerate(list(current)):
                            for c in x:
                                if c in current:
                                    continue
                                cand = current[:i] + [c] + current[i + 1 :]
                                g2, r22 = self._glm_r2(cand, y, train)
                                if r22 > r2 + 1e-12:
                                    current, r2, g = cand, r22, g2
                                    improved = True
                if size >= minp:
                    results.append(dict(size=size, predictors=list(current), r2=r2))
                    best_glms.append(g)
        elif mode == "backward":
            current = list(x)
            g, r2 = self._glm_r2(current, y, train)
            stack = [(list(current), r2, g)]
            while len(current) > minp:
                best = (None, -np.inf, None)
                for i in range(len(current)):
                    cand = current[:i] + current[i + 1 :]
                    g2, r22 = self._glm_r2(cand, y, train)
                    if r22 > best[1]:
                        best = (cand, r22, g2)
                current, r2, g = best
                stack.append((list(current), r2, g))
            for preds, r2, g in reversed(stack):
                results.append(dict(size=len(preds), predictors=preds, r2=r2))
                best_glms.append(g)
        else:
            raise ValueError(f"unknown mode {mode!r}")

        model = ModelSelectionModel(self, x, y, results, best_glms)
        model.training_metrics = ModelMetricsBase(nobs=train.nrow)
        # the number of GLM fits the search ran and its host-clock wall
        model.n_glm_fits = self._n_fits
        model.fit_timings = dict(total_s=time.perf_counter() - t0)
        return model


ModelSelection = H2OModelSelectionEstimator
