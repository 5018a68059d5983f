"""`h2o.estimators` namespace of the port: the estimators ported so far
(the unsupervised K-Means, PCA, SVD and GLRM, the isolation forests and
the uplift DRF among them), with the grid search and AutoML that drive
them."""

from ..automl import H2OAutoML
from ..models.deeplearning import H2ODeepLearningEstimator
from ..models.drf import H2ORandomForestEstimator
from ..models.ensemble import H2OStackedEnsembleEstimator
from ..models.extended_isolation_forest import \
    H2OExtendedIsolationForestEstimator
from ..models.gbm import H2OGradientBoostingEstimator
from ..models.glm import H2OGeneralizedLinearEstimator
from ..models.glrm import H2OGeneralizedLowRankEstimator
from ..models.grid import H2OGridSearch
from ..models.isolation_forest import H2OIsolationForestEstimator
from ..models.kmeans import H2OKMeansEstimator
from ..models.pca import H2OPrincipalComponentAnalysisEstimator
from ..models.svd import H2OSingularValueDecompositionEstimator
from ..models.uplift import H2OUpliftRandomForestEstimator
from ..models.xgboost import H2OXGBoostEstimator

__all__ = ["H2OAutoML", "H2ODeepLearningEstimator",
           "H2OExtendedIsolationForestEstimator",
           "H2OGeneralizedLinearEstimator", "H2OGeneralizedLowRankEstimator",
           "H2OGradientBoostingEstimator", "H2OGridSearch",
           "H2OIsolationForestEstimator", "H2OKMeansEstimator",
           "H2OPrincipalComponentAnalysisEstimator",
           "H2ORandomForestEstimator",
           "H2OSingularValueDecompositionEstimator",
           "H2OStackedEnsembleEstimator", "H2OUpliftRandomForestEstimator",
           "H2OXGBoostEstimator"]
