"""H2OStackedEnsembleEstimator — super learning.

A copy of `h2o3_tpu/models/ensemble.py`, rewired to the port. Reference
parity: `h2o-algos/src/main/java/hex/ensemble/StackedEnsemble.java` /
`StackedEnsembleModel.java` / `Metalearner*.java`: a metalearner (GLM with
non-negative weights by default) trained on the cross-validated holdout
predictions of the base models (which must share fold assignment and
`keep_cross_validation_predictions=True`), or on their predictions on a
`blending_frame`. `metalearner_algorithm` ∈ {AUTO/glm/gbm/drf/
deeplearning}; the metalearner runs on the ensemble's `device`.

A multiclass stack's level-one frame holds each base model's K class
probabilities (`m{i}_p{k}`), and its default metalearner is the
multinomial GLM (λ = 0). The reference also sets `non_negative` for it,
which no multinomial fit reads; the port sets it for the binomial and
regression metalearners only, so the model is the same and the
multinomial GLM's raise for a user's `non_negative` stays (ROADMAP §C).

`metalearner_nfolds` and `metalearner_transform` are in the reference's
defaults but its fit never reads them; the port raises for a value other
than the default (ROADMAP §C).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..frame.frame import Frame
from .metrics import (ModelMetricsBinomial, ModelMetricsMultinomial,
                      ModelMetricsRegression)
from .model_base import H2OEstimator, H2OModel, response_info


def _level_one_columns(cols: dict, i: int, p: np.ndarray, problem: str):
    """Base model i's columns of the level-one frame: `m{i}_p{k}` per class
    for multinomial, else `m{i}`."""
    if problem == "multinomial":
        for k in range(p.shape[1]):
            cols[f"m{i}_p{k}"] = p[:, k]
    else:
        cols[f"m{i}"] = p if p.ndim == 1 else p[:, 0]


class StackedEnsembleModel(H2OModel):
    algo = "stackedensemble"

    def __init__(self, params, base_models, meta_est, problem, nclass, domain, y):
        super().__init__(params)
        self.base_models = base_models
        self.meta = meta_est
        self.problem = problem
        self.nclass = nclass
        self.domain = domain
        self.y = y
        self.x = base_models[0].model.x if base_models else []

    def _level_one(self, frame: Frame) -> Frame:
        # the reference keeps each base model's prediction on the frame
        # object and drops it when `Frame._touch` sees a mutation; the
        # port's Frame has no such hook, so every call predicts afresh
        # (the same predictions, computed again)
        cols = {}
        for i, bm in enumerate(self.base_models):
            _level_one_columns(cols, i, bm._cv_predict(bm.model, frame),
                               self.problem)
        return Frame.from_dict(cols)

    def predict(self, test_data: Frame) -> Frame:
        return self.meta.predict(self._level_one(test_data))

    def _score_probs(self, frame: Frame) -> np.ndarray:
        lvl1 = self._level_one(frame)
        return self.meta._cv_predict(self.meta.model, lvl1)

    def _make_metrics(self, frame: Frame):
        out = self._score_probs(frame)
        yv = frame.vec(self.y)
        if self.problem == "binomial":
            return ModelMetricsBinomial.make(np.asarray(yv.data), out)
        if self.problem == "multinomial":
            return ModelMetricsMultinomial.make(np.asarray(yv.data), out)
        return ModelMetricsRegression.make(yv.numeric_np(), out)


class H2OStackedEnsembleEstimator(H2OEstimator):
    algo = "stackedensemble"
    _param_defaults = dict(
        base_models=None,
        metalearner_algorithm="AUTO",
        metalearner_nfolds=0,
        metalearner_params=None,
        metalearner_transform="NONE",
        blending_frame=None,
    )
    # parameters the reference accepts and never reads: (default, why)
    _IGNORED_BY_REFERENCE = dict(
        metalearner_nfolds=(0, "the metalearner is fit without CV"),
        metalearner_transform=("NONE", "the level-one frame is not "
                                       "transformed"),
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]):
        for k, (default, why) in self._IGNORED_BY_REFERENCE.items():
            if self._parms.get(k, default) != default:
                raise NotImplementedError(
                    f"stackedensemble: {k}={self._parms[k]!r} is not ported: "
                    f"the reference ignores it ({why}; ROADMAP §C)")
        base_models: List = list(self._parms.get("base_models") or [])
        if not base_models:
            raise ValueError("stackedensemble: base_models is required")
        problem, nclass, domain = response_info(train.vec(y))

        blend = self._parms.get("blending_frame")
        cols = {}
        for i, bm in enumerate(base_models):
            if blend is not None:
                p = bm._cv_predict(bm.model, blend)
            else:
                p = bm.model._cv_holdout_pred
                if p is None:
                    raise ValueError(
                        f"base model {bm.model.model_id} lacks CV holdout "
                        "predictions; train with nfolds>=2 and "
                        "keep_cross_validation_predictions=True")
            _level_one_columns(cols, i, p, problem)
        target_frame = blend if blend is not None else train
        lvl1 = Frame.from_dict(cols)
        lvl1 = Frame({**lvl1._vecs, "__y__": target_frame.vec(y)})

        algo = self._parms.get("metalearner_algorithm", "AUTO")
        mp = dict(self._parms.get("metalearner_params") or {})
        mp.setdefault("device", self._parms.get("device"))
        if algo in ("AUTO", "glm"):
            from .glm import H2OGeneralizedLinearEstimator

            fam = {"binomial": "binomial", "multinomial": "multinomial"}.get(
                problem, "gaussian")
            mp.setdefault("family", fam)
            mp.setdefault("lambda_", 0.0)
            if "multinomial" not in (problem, mp["family"]):
                mp.setdefault("non_negative", True)
            meta = H2OGeneralizedLinearEstimator(**mp)
        elif algo == "gbm":
            from .gbm import H2OGradientBoostingEstimator

            meta = H2OGradientBoostingEstimator(**mp)
        elif algo == "drf":
            from .drf import H2ORandomForestEstimator

            meta = H2ORandomForestEstimator(**mp)
        elif algo == "deeplearning":
            from .deeplearning import H2ODeepLearningEstimator

            meta = H2ODeepLearningEstimator(**mp)
        else:
            raise ValueError(f"unknown metalearner_algorithm {algo!r}")
        meta.train(y="__y__", training_frame=lvl1)

        model = StackedEnsembleModel(self, base_models, meta, problem, nclass,
                                     domain, y)
        # the SE's training frame is the level-one frame (out-of-fold base
        # predictions), so the metalearner's training metrics are the SE's
        # cross-validated training metrics, as upstream StackedEnsemble
        # scores them
        model.training_metrics = meta.model.training_metrics
        if valid is not None:
            model.validation_metrics = model._make_metrics(valid)
        return model

    def _cv_predict(self, model, frame: Frame) -> np.ndarray:
        return model._score_probs(frame)


StackedEnsemble = H2OStackedEnsembleEstimator
