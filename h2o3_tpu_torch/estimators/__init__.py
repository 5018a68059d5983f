"""`h2o.estimators` namespace of the port: the estimators ported so far."""

from ..models.drf import H2ORandomForestEstimator
from ..models.gbm import H2OGradientBoostingEstimator

__all__ = ["H2OGradientBoostingEstimator", "H2ORandomForestEstimator"]
