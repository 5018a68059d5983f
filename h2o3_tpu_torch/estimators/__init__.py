"""`h2o.estimators` namespace of the port: the estimators ported so far
(the unsupervised K-Means, PCA, SVD and GLRM, the isolation forests, the
uplift DRF, NaiveBayes, isotonic regression, the GLM family — GAM,
ANOVA GLM and ModelSelection — CoxPH, PSVM, RuleFit, TargetEncoder,
Aggregator and Word2Vec among them), with the grid search and AutoML that
drive them."""

from ..automl import H2OAutoML
from ..models.aggregator import H2OAggregatorEstimator
from ..models.anovaglm import H2OANOVAGLMEstimator
from ..models.coxph import H2OCoxProportionalHazardsEstimator
from ..models.deeplearning import H2ODeepLearningEstimator
from ..models.drf import H2ORandomForestEstimator
from ..models.ensemble import H2OStackedEnsembleEstimator
from ..models.extended_isolation_forest import \
    H2OExtendedIsolationForestEstimator
from ..models.gam import H2OGeneralizedAdditiveEstimator
from ..models.gbm import H2OGradientBoostingEstimator
from ..models.glm import H2OGeneralizedLinearEstimator
from ..models.glrm import H2OGeneralizedLowRankEstimator
from ..models.grid import H2OGridSearch
from ..models.isolation_forest import H2OIsolationForestEstimator
from ..models.isotonic import H2OIsotonicRegressionEstimator
from ..models.kmeans import H2OKMeansEstimator
from ..models.modelselection import H2OModelSelectionEstimator
from ..models.naive_bayes import H2ONaiveBayesEstimator
from ..models.pca import H2OPrincipalComponentAnalysisEstimator
from ..models.psvm import H2OSupportVectorMachineEstimator
from ..models.rulefit import H2ORuleFitEstimator
from ..models.svd import H2OSingularValueDecompositionEstimator
from ..models.targetencoder import H2OTargetEncoderEstimator
from ..models.uplift import H2OUpliftRandomForestEstimator
from ..models.word2vec import H2OWord2vecEstimator
from ..models.xgboost import H2OXGBoostEstimator

__all__ = ["H2OANOVAGLMEstimator", "H2OAggregatorEstimator", "H2OAutoML",
           "H2OCoxProportionalHazardsEstimator", "H2ODeepLearningEstimator",
           "H2OExtendedIsolationForestEstimator",
           "H2OGeneralizedAdditiveEstimator",
           "H2OGeneralizedLinearEstimator", "H2OGeneralizedLowRankEstimator",
           "H2OGradientBoostingEstimator", "H2OGridSearch",
           "H2OIsolationForestEstimator", "H2OIsotonicRegressionEstimator",
           "H2OKMeansEstimator", "H2OModelSelectionEstimator",
           "H2ONaiveBayesEstimator",
           "H2OPrincipalComponentAnalysisEstimator",
           "H2ORandomForestEstimator", "H2ORuleFitEstimator",
           "H2OSingularValueDecompositionEstimator",
           "H2OStackedEnsembleEstimator", "H2OSupportVectorMachineEstimator",
           "H2OTargetEncoderEstimator", "H2OUpliftRandomForestEstimator",
           "H2OWord2vecEstimator", "H2OXGBoostEstimator"]
