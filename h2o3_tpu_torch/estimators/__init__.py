"""`h2o.estimators` namespace of the port: the estimators ported so far."""

from ..models.drf import H2ORandomForestEstimator
from ..models.ensemble import H2OStackedEnsembleEstimator
from ..models.gbm import H2OGradientBoostingEstimator
from ..models.glm import H2OGeneralizedLinearEstimator
from ..models.xgboost import H2OXGBoostEstimator

__all__ = ["H2OGeneralizedLinearEstimator", "H2OGradientBoostingEstimator",
           "H2ORandomForestEstimator", "H2OStackedEnsembleEstimator",
           "H2OXGBoostEstimator"]
