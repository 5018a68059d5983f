"""Model framework — the estimator lifecycle and the trained-model surface.

Port of the parts of `h2o3_tpu/models/model_base.py` the tree estimators
use: `H2OModel` (metric accessors, `predict`, `model_performance`, the
scoring history), `H2OEstimator` (parameter checking, `train` with a
validation frame), `ScoringHistory` and `ScoreKeeper` (`hex.ScoreKeeper`'s
moving-average early stopping). Cross-validation, offsets, checkpoints,
jobs, the REST/DKV surface and `DataInfo` are not ported yet (ROADMAP
queue A, items 5, 8 and 11).
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..frame.frame import Frame
from ..frame.vec import Vec
from .metrics import ModelMetricsBase

_model_counter = itertools.count()

# scorer row bucket: tree scoring pads its row dimension to this multiple,
# as the reference does, so scoring inputs keep a fixed grid of shapes
SCORE_ROW_BUCKET = 512


class ScoringHistory(list):
    """Scoring-history rows, list-compatible and callable: h2o-py's
    `model.scoring_history()` returns a table (a `Frame` here; the
    reference's `use_pandas` is not ported), while the drivers index the
    rows directly."""

    def __call__(self) -> Frame:
        cols = {}
        for k in (list(self[0]) if self else []):
            vals = [r.get(k) for r in self]
            if isinstance(vals[0], str):
                cols[k] = np.asarray(vals, dtype=object)
            else:
                cols[k] = np.asarray(
                    [np.nan if v is None else float(v) for v in vals])
        return Frame.from_dict(cols) if cols else Frame({})


class ScoreKeeper:
    """`hex.ScoreKeeper.stopEarly` — moving-average early stopping."""

    def __init__(self, stopping_rounds: int, stopping_metric: str, tolerance: float,
                 larger_is_better: Optional[bool] = None):
        self.k = stopping_rounds
        self.metric = stopping_metric
        self.tol = tolerance
        if larger_is_better is None:
            larger_is_better = stopping_metric.lower() in ("auc", "pr_auc", "accuracy", "r2")
        self.more = larger_is_better
        self.history: List[float] = []

    def record(self, value: float) -> bool:
        """Record a scoring event; True ⇒ stop now (moving average of the
        last k events is not better than the best before them by > tol)."""
        self.history.append(float(value))
        k = self.k
        if k <= 0 or len(self.history) < 2 * k:
            return False
        hist = np.asarray(self.history)
        recent = hist[-k:].mean()
        prior = hist[:-k]
        best_prior = prior.max() if self.more else prior.min()
        margin = self.tol * max(abs(best_prior), 1e-12)
        if self.more:
            return recent <= best_prior + margin
        return recent >= best_prior - margin


class H2OModel:
    """Trained-model half of `hex.Model` + the `h2o-py` ModelBase surface."""

    algo = "base"

    def __init__(self, params: "H2OEstimator"):
        self.parms = params
        user_id = params._parms.get("model_id") if params is not None else None
        self.model_id = user_id or f"{self.algo}_{next(_model_counter)}"
        self.training_metrics: Optional[ModelMetricsBase] = None
        self.validation_metrics: Optional[ModelMetricsBase] = None
        self.scoring_history: ScoringHistory = ScoringHistory()
        self.varimp_table = None
        self.run_time: float = 0.0

    def _m(self, valid=False, xval=False):
        if xval:
            raise NotImplementedError(
                "cross-validation metrics are not ported "
                "(ROADMAP queue A, item 5: CV)")
        if valid and self.validation_metrics:
            return self.validation_metrics
        return self.training_metrics

    def auc(self, valid=False, xval=False):
        return getattr(self._m(valid, xval), "auc", float("nan"))

    def logloss(self, valid=False, xval=False):
        return getattr(self._m(valid, xval), "logloss", float("nan"))

    def rmse(self, valid=False, xval=False):
        return self._m(valid, xval).rmse

    def mse(self, valid=False, xval=False):
        return self._m(valid, xval).mse

    def mean_per_class_error(self, valid=False, xval=False):
        return getattr(self._m(valid, xval), "mean_per_class_error", float("nan"))

    def varimp(self, use_pandas=False):
        return self.varimp_table

    def predict(self, test_data: Frame) -> Frame:
        raise NotImplementedError

    def model_performance(self, test_data: Optional[Frame] = None, **kw):
        if test_data is None:
            return self.training_metrics
        return self._make_metrics(test_data)

    def _make_metrics(self, frame: Frame):
        raise NotImplementedError


class H2OEstimator:
    """Parameter holder + builder (`hex.ModelBuilder` merged with the
    `h2o-py` estimator classes). Subclasses define `_param_defaults` and
    `_fit`; unknown kwargs raise like the reference's schema validation."""

    algo = "base"
    _param_defaults: Dict[str, Any] = {}
    _common_defaults: Dict[str, Any] = dict(
        model_id=None,
        seed=-1,
        ignored_columns=None,
        ignore_const_cols=True,
        weights_column=None,
        offset_column=None,
        fold_column=None,
        nfolds=0,
        stopping_rounds=0,
        stopping_metric="AUTO",
        stopping_tolerance=0.001,
        score_each_iteration=False,
        checkpoint=None,
        device=None,      # the port's own: "cuda" (default) or "cpu"
    )

    def __init__(self, **kwargs):
        self._parms: Dict[str, Any] = dict(self._common_defaults)
        self._parms.update(self._param_defaults)
        for k, v in kwargs.items():
            if k not in self._parms:
                raise TypeError(f"{type(self).__name__}: unknown parameter {k!r}")
            self._parms[k] = v
        self._model: Optional[H2OModel] = None

    def __getattr__(self, name):
        parms = object.__getattribute__(self, "_parms")
        if name in parms:
            return parms[name]
        raise AttributeError(name)

    def train(
        self,
        x: Optional[Sequence[str]] = None,
        y: Optional[str] = None,
        training_frame: Optional[Frame] = None,
        validation_frame: Optional[Frame] = None,
    ) -> "H2OEstimator":
        if training_frame is None:
            raise ValueError("training_frame is required")
        if y is None:
            raise ValueError(f"{self.algo}: response column y is required")
        for k, item in (("offset_column", "offsets"), ("fold_column", "CV"),
                        ("checkpoint", "checkpoints")):
            if self._parms.get(k) is not None:
                raise NotImplementedError(
                    f"{k} is not ported (ROADMAP queue A, item 5: {item})")
        if int(self._parms.get("nfolds") or 0):
            raise NotImplementedError(
                "cross-validation is not ported (ROADMAP queue A, item 5: CV)")
        wc = self._parms.get("weights_column")
        if wc is not None and wc not in training_frame.names:
            raise ValueError(f"weights_column {wc!r} not in the training frame")
        ignored = set(self._parms.get("ignored_columns") or [])
        if x is None:
            x = [n for n in training_frame.names
                 if n != y and n not in ignored and n != wc]
        else:
            x = [training_frame.names[i] if isinstance(i, int) else i for i in x]
            x = [n for n in x if n != y and n not in ignored]
        if self._parms.get("ignore_const_cols", True):
            x = [n for n in x if not _is_const(training_frame.vec(n))]
        # rows with a missing response are dropped before training
        na = training_frame.vec(y).isna_np()
        if na.any():
            training_frame = training_frame.take(np.nonzero(~na)[0])
        if validation_frame is not None:
            nav = validation_frame.vec(y).isna_np()
            if nav.any():
                validation_frame = validation_frame.take(np.nonzero(~nav)[0])
        t0 = time.time()
        seed = int(self._parms.get("seed", -1))
        self._parms["_actual_seed"] = 1234 if seed in (-1, None) else seed
        model = self._fit(x, y, training_frame, validation_frame)
        model.run_time = time.time() - t0
        self._model = model
        return self

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> H2OModel:
        raise NotImplementedError

    @property
    def model(self) -> H2OModel:
        if self._model is None:
            raise ValueError("model not trained; call train() first")
        return self._model

    def predict(self, test_data: Frame) -> Frame:
        return self.model.predict(test_data)

    def model_performance(self, test_data=None, valid=False, xval=False):
        if test_data is not None:
            return self.model.model_performance(test_data)
        return self.model._m(valid=valid, xval=xval)

    def auc(self, **kw):
        return self.model.auc(**kw)

    def logloss(self, **kw):
        return self.model.logloss(**kw)

    def rmse(self, **kw):
        return self.model.rmse(**kw)

    def varimp(self, **kw):
        return self.model.varimp(**kw)

    @property
    def scoring_history(self):
        return self.model.scoring_history


def _is_const(v: Vec) -> bool:
    if v.type == "string":
        return False
    a = v.numeric_np()
    fin = a[~np.isnan(a)]
    return fin.size > 0 and float(fin.min()) == float(fin.max())


def response_info(yvec: Vec):
    """(problem_kind, nclass, domain) from the response Vec."""
    if yvec.type == "enum":
        k = yvec.nlevels
        if k < 2:
            raise ValueError(
                "categorical response has fewer than two classes "
                "(ModelBuilder rejects constant responses)")
        return ("binomial" if k == 2 else "multinomial"), k, yvec.domain
    return "regression", 1, None
