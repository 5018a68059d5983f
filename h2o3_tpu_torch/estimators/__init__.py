"""`h2o.estimators` namespace of the port: the estimators ported so far,
with the grid search and AutoML that drive them."""

from ..automl import H2OAutoML
from ..models.deeplearning import H2ODeepLearningEstimator
from ..models.drf import H2ORandomForestEstimator
from ..models.ensemble import H2OStackedEnsembleEstimator
from ..models.gbm import H2OGradientBoostingEstimator
from ..models.glm import H2OGeneralizedLinearEstimator
from ..models.grid import H2OGridSearch
from ..models.xgboost import H2OXGBoostEstimator

__all__ = ["H2OAutoML", "H2ODeepLearningEstimator",
           "H2OGeneralizedLinearEstimator", "H2OGradientBoostingEstimator",
           "H2OGridSearch", "H2ORandomForestEstimator",
           "H2OStackedEnsembleEstimator", "H2OXGBoostEstimator"]
