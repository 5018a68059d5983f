"""Carry a trained model across from its numpy arrays.

A tree model's "weights" are its forests: per class forest (K of them for a
multinomial model, else one) and per tree the heap arrays `feat`, `bin`,
`thr`, `is_split` and `value` (plus the node covers), the initial margin
`f0` (a K-vector for multinomial), the bin edges, the heap depth and the
mode (``"gbm"`` sums the trees through the link; ``"drf"`` averages them).
`forest_from_numpy` builds the port's model from them, so a GBM or DRF
model trained by the JAX package (whose arrays the caller reads out as
numpy) scores in the port. A balanced model adds its (prior, model) class
distributions, and a calibrated one its calibration map as data: the
method with Platt's (a, b) or the isotonic knots.

A GLM's weights are its standardized β (intercept last; one row per
class, (K, p+1), for a multinomial model), its family and response domain,
and the state of its `DataInfo`: the column spec, the coefficient names,
the standardization stats, the imputation means and the transfer groups
frozen at fit. `glm_from_numpy` builds the port's `GLMModel` from them.

A DeepLearning model's weights are its layers' (W, b) pairs (W of shape
(fan_in, units), a Maxout hidden layer with twice the units of the next
layer's fan-in), its activation, problem, class count, response domain
and distribution, with the same `DataInfo` state. `dl_from_numpy` builds
the port's `DeepLearningModel` from them.

The unsupervised models' weights are their fitted arrays with the same
`DataInfo` state: a K-Means model's standardized centres, a PCA model's
eigenvectors and eigenvalues (and its DEMEAN means), an SVD model's d, v
and, if kept, u, and a GLRM model's X and Y with its objective.
`kmeans_from_numpy`, `pca_from_numpy`, `svd_from_numpy` and
`glrm_from_numpy` build the port's models from them.

An IsolationForest's weights are its trees' heap arrays (feature, f64
threshold, split flag and training rows per node) with the sample size
and depth; an ExtendedIsolationForest's its directions, thresholds,
splits and node counts with its `DataInfo` state; an UpliftDRF's its
stacked forest with the bin edges and the feature domains of its
`BinnedMatrix`, the response domain and the treatment column.
`isoforest_from_numpy`, `eif_from_numpy` and `uplift_from_numpy` build
the port's models from them.

A NaiveBayes model's weights are its priors, each numeric column's
per-class mean and sd, and each categorical column's probability table
with its domain; an isotonic regression's its knots and `out_of_bounds`;
a GAM's its β, its `DataInfo` state and each spline column's knots and
centres. An ANOVA GLM is its table and terms with its full GLM, and a
ModelSelection model its per-size results with one GLM each, the GLMs
given as `glm_from_numpy` arguments. `naivebayes_from_numpy`,
`isotonic_from_numpy`, `gam_from_numpy`, `anovaglm_from_numpy` and
`modelselection_from_numpy` build the port's models from them.

A CoxPH model's weights are its β, standard errors, log-likelihoods,
concordance and event count with its `DataInfo` state; a PSVM's its
Fourier projection W and offsets b (None for the linear kernel), β, bias,
response domain, kernel and `svs_count` with its standardized `DataInfo`
state; a RuleFit model's its rules (conditions, support and coefficient
each), its linear terms with their stats, and its lasso GLM given as
`glm_from_numpy` arguments. `coxph_from_numpy`, `psvm_from_numpy` and
`rulefit_from_numpy` build the port's models from them.

A TargetEncoder's weights are its per-column tables (the training domain,
the per-level sums and counts, and the KFold out-of-fold tables by fold
id), its prior, blending parameters, noise, leakage mode, training fold
assignment and seed; a Word2Vec model's its vocabulary and (V, d)
vectors; an Aggregator's its exemplar row indices and counts over the
training frame. `targetencoder_from_numpy`, `word2vec_from_numpy` and
`aggregator_from_numpy` build the port's models from them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import device as devlib
from .frame.binning import BinnedMatrix
from .models import tree as treelib
from .models.coxph import CoxPHModel
from .models.deeplearning import ACTIVATIONS, DeepLearningModel
from .models.extended_isolation_forest import ExtendedIsolationForestModel
from .models.anovaglm import ANOVAGLMModel, H2OANOVAGLMEstimator
from .models.gam import GAMModel
from .models.glm import FAMILIES, GLMModel, H2OGeneralizedLinearEstimator
from .models.glrm import GLRMModel
from .models.isolation_forest import IsolationForestModel
from .models.isotonic import IsotonicRegressionModel
from .models.kmeans import KMeansModel
from .models.model_base import DataInfo
from .models.modelselection import ModelSelectionModel
from .models.naive_bayes import NaiveBayesModel
from .models.pca import PCAModel
from .models.psvm import PSVMModel
from .frame.frame import Frame
from .models.aggregator import AggregatorModel
from .models.rulefit import Rule, RuleFitModel
from .models.targetencoder import LEAKAGE_MODES, TargetEncoderModel
from .models.word2vec import Word2VecModel
from .models.svd import SVDModel
from .models.shared_tree import Calibrator, SharedTreeModel
from .models.uplift import UpliftRandomForestModel


def _class_forests(a) -> List[np.ndarray]:
    """One (ntrees, T) array, or a sequence of K of them, as a list of K
    arrays."""
    if isinstance(a, (list, tuple)):
        return [np.asarray(x) for x in a]
    return [np.asarray(a)]


def forest_from_numpy(*, feat, bin, thr, is_split, value, covers, f0,
                      edges: Sequence[np.ndarray], max_depth: int,
                      x: Sequence[str], y: str, nbins: int,
                      domain: Optional[List[str]] = None,
                      problem: str = "binomial",
                      distribution: str = "bernoulli",
                      mode: str = "gbm", algo: Optional[str] = None,
                      balance_dists=None, calibrator=None,
                      device=None) -> SharedTreeModel:
    """Port model from heap arrays: each field one (ntrees, T) array, or K
    of them for a multinomial model (one per class forest, in class order).
    `f0` is a float, or the K-vector of a multinomial model. `edges` are
    the per-feature bin edges of the training `BinnedMatrix`; `domain` the
    response levels of a classifier; `mode` the reference model's `mode`;
    `algo` its algo where it is not the shared tree's ("xgboost").
    `balance_dists` is a balanced model's (prior, model) class
    distributions; `calibrator` a calibrated binomial model's map as a dict
    of `Calibrator`'s fields: ``method`` with ``a`` and ``b`` for Platt
    scaling, ``knots_x`` and ``knots_y`` for ``"IsotonicRegression"``."""
    if mode not in ("gbm", "drf"):
        raise ValueError(f"mode must be 'gbm' or 'drf', got {mode!r}")
    dev = devlib.resolve(device)
    T = treelib.heap_size(max_depth)
    arrays = dict(feat=(feat, torch.int32), bin=(bin, torch.int32),
                  thr=(thr, torch.float32), is_split=(is_split, torch.bool),
                  value=(value, torch.float32))
    fields = {}
    for name, (a, dt) in arrays.items():
        per_class = _class_forests(a)
        for a_k in per_class:
            if a_k.ndim != 2 or a_k.shape[1] != T:
                raise ValueError(f"{name}: expected (ntrees, {T}) for max_depth "
                                 f"{max_depth}, got {a_k.shape}")
        fields[name] = [torch.as_tensor(a_k).to(dt).to(dev) for a_k in per_class]
    K = len(fields["feat"])
    if any(len(v) != K for v in fields.values()):
        raise ValueError("every field needs the same number of class forests")
    forest = [treelib.Tree(**{f: fields[f][k] for f in fields}) for k in range(K)]
    f0_arr = np.asarray(f0, np.float32).reshape(-1)
    if problem == "multinomial":
        if f0_arr.size != K or domain is None or len(domain) != K:
            raise ValueError(f"a multinomial model needs {K} class forests, "
                             "f0 values and domain levels alike")
        f0_v, nclass = f0_arr, K
    else:
        if K != 1 or f0_arr.size != 1:
            raise ValueError(f"a {problem} model has one forest and one f0")
        f0_v, nclass = float(f0_arr[0]), (2 if problem == "binomial" else 1)
    F = len(x)
    bm = BinnedMatrix(codes=None, edges=[np.asarray(e, np.float64) for e in edges],
                      nbins=int(nbins), names=list(x),
                      is_categorical=np.zeros(F, bool), domains=[None] * F)
    cov = ([torch.as_tensor(np.asarray(c, np.float32)).to(dev)
            for c in _class_forests(covers)]
           if covers is not None else None)
    model = SharedTreeModel(None, x, y, bm, problem, nclass, domain,
                            distribution, f0_v, forest, cov, int(max_depth),
                            dev, mode=mode)
    if algo:
        model.algo = algo
    if balance_dists is not None:
        prior, modeld = balance_dists
        model.balance_dists = (np.asarray(prior, np.float64),
                               np.asarray(modeld, np.float64))
    if calibrator is not None:
        if problem != "binomial":
            raise ValueError("a calibrator needs a binomial model")
        model.calibrator = Calibrator(**calibrator)
    return model


def glm_from_numpy(*, beta, family: str, x: Sequence[str], y: str, spec,
                   coef_names: Sequence[str], means=None, stds=None,
                   col_means=None, transfer_groups=None,
                   standardize: bool = True, use_all: bool = False,
                   domain: Optional[List[str]] = None,
                   lambda_best: float = 0.0, algo: Optional[str] = None,
                   device=None) -> GLMModel:
    """Port GLM from a reference GLM's state: `beta` the (p+1,) standardized
    coefficients with the intercept last, or the (K, p+1) of a multinomial
    model, one row per level of `domain`; `spec` the `DataInfo._spec`
    entries ("num", name, None) / ("cat", name, domain); `means`/`stds` the
    standardization stats (None when not standardized); `col_means` the
    imputation means; `transfer_groups` the numeric columns' upload dtypes
    (`DataInfo._transfer_groups`); `domain` the response levels of a
    binomial or multinomial model; `algo` the reference model's algo where
    it is not GLM's (a gblinear XGBoost model's "xgboost")."""
    if family not in FAMILIES or family == "AUTO":
        raise ValueError(f"family {family!r}: expected a fitted family")
    b = np.asarray(beta, np.float64)
    p1 = len(coef_names) + 1
    if family == "multinomial":
        if b.ndim != 2 or domain is None or b.shape != (len(domain), p1):
            raise ValueError(
                f"family 'multinomial' needs a (K, {p1}) beta, one row per "
                f"level of domain, for {len(coef_names)} coefficients; got "
                f"beta {b.shape} and domain {domain!r}")
    elif b.shape != (p1,):
        raise ValueError(f"beta: expected ({p1},) for "
                         f"{len(coef_names)} coefficients, got {b.shape}")
    dinfo = DataInfo.from_state(
        spec=spec, coef_names=coef_names, standardize=standardize,
        use_all=use_all, means=means, stds=stds, col_means=col_means,
        transfer_groups=transfer_groups)
    if list(x) != dinfo.x:
        raise ValueError("x must name the spec's columns in order")
    model = GLMModel(None, x, y, dinfo, family, b, domain,
                     lambda_best=float(lambda_best), device=device)
    if algo:
        model.algo = algo
    return model


def dl_from_numpy(*, net_params, activation: str, problem: str,
                  x: Sequence[str], y: Optional[str], spec,
                  coef_names: Sequence[str], nclass: int = 0,
                  domain: Optional[List[str]] = None,
                  distribution: str = "gaussian", means=None, stds=None,
                  col_means=None, transfer_groups=None,
                  standardize: bool = True, use_all: bool = True,
                  device=None) -> DeepLearningModel:
    """Port DeepLearning model from a reference model's state: `net_params`
    its (W, b) numpy pairs in layer order; `problem` one of "binomial",
    "multinomial", "regression" and "autoencoder", with `nclass` and the
    response `domain` of a classifier and the resolved `distribution`
    (poisson scores exp of the output); `spec`, `coef_names`,
    `means`/`stds`, `col_means` and `transfer_groups` the `DataInfo` state,
    as for `glm_from_numpy`. The layer shapes must chain from the
    coefficient count to the output width of the problem."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {ACTIVATIONS}")
    out_width = {"binomial": nclass, "multinomial": nclass, "regression": 1,
                 "autoencoder": len(coef_names)}.get(problem)
    if out_width is None:
        raise ValueError(f"problem {problem!r}: expected binomial, "
                         "multinomial, regression or autoencoder")
    if problem in ("binomial", "multinomial") and (
            domain is None or len(domain) != nclass):
        raise ValueError(f"a {problem} model needs nclass levels of domain")
    pairs = [(np.array(W, np.float32), np.array(b, np.float32))
             for W, b in net_params]
    fan_in = len(coef_names)
    maxout = activation.startswith("Maxout")
    for i, (W, b) in enumerate(pairs):
        last = i == len(pairs) - 1
        if W.ndim != 2 or W.shape[0] != fan_in or b.shape != (W.shape[1],):
            raise ValueError(f"layer {i}: W {W.shape} and b {b.shape} do not "
                             f"take {fan_in} inputs")
        if last and W.shape[1] != out_width:
            raise ValueError(f"the output layer has {W.shape[1]} units; a "
                             f"{problem} model needs {out_width}")
        fan_in = W.shape[1] // 2 if (maxout and not last) else W.shape[1]
    dinfo = DataInfo.from_state(
        spec=spec, coef_names=coef_names, standardize=standardize,
        use_all=use_all, means=means, stds=stds, col_means=col_means,
        transfer_groups=transfer_groups)
    if list(x) != dinfo.x:
        raise ValueError("x must name the spec's columns in order")
    dev = devlib.resolve(device)
    params = [(torch.from_numpy(W).to(dev), torch.from_numpy(b).to(dev))
              for W, b in pairs]
    return DeepLearningModel(None, x, y, dinfo, problem, nclass, domain,
                             params, activation, distribution, device=dev)


def _dinfo(x, *, spec, coef_names, standardize, use_all, means, stds,
           col_means, impute_missing=True) -> DataInfo:
    dinfo = DataInfo.from_state(
        spec=spec, coef_names=coef_names, standardize=standardize,
        use_all=use_all, means=means, stds=stds, col_means=col_means,
        impute_missing=impute_missing)
    if list(x) != dinfo.x:
        raise ValueError("x must name the spec's columns in order")
    return dinfo


def kmeans_from_numpy(*, centers_std, x: Sequence[str], spec,
                      coef_names: Sequence[str], means=None, stds=None,
                      col_means=None, standardize: bool = True,
                      use_all: bool = True, device=None) -> KMeansModel:
    """Port K-Means model from a reference model's state: `centers_std` the
    (k, p) centres in the standardized space (`KMeansModel.centers_std`),
    with the `DataInfo` state as for `glm_from_numpy`."""
    c = np.asarray(centers_std, np.float32)
    if c.ndim != 2 or c.shape[1] != len(coef_names):
        raise ValueError(f"centers_std: expected (k, {len(coef_names)}), "
                         f"got {c.shape}")
    dinfo = _dinfo(x, spec=spec, coef_names=coef_names,
                   standardize=standardize, use_all=use_all, means=means,
                   stds=stds, col_means=col_means)
    return KMeansModel(None, x, dinfo, c, c.shape[0], device=device)


def pca_from_numpy(*, eigenvectors, eigenvalues, x: Sequence[str], spec,
                   coef_names: Sequence[str], demean_mu=None, means=None,
                   stds=None, col_means=None, standardize: bool = False,
                   use_all: bool = False, device=None) -> PCAModel:
    """Port PCA model from a reference model's state: `eigenvectors`
    (p, k) and `eigenvalues` (k,), `demean_mu` the training means of a
    `transform="DEMEAN"` model (its `_demean_mu`), and the `DataInfo`
    state."""
    V = np.asarray(eigenvectors)
    ev = np.asarray(eigenvalues)
    if V.ndim != 2 or V.shape[0] != len(coef_names) or ev.shape != (V.shape[1],):
        raise ValueError(f"eigenvectors {V.shape} and eigenvalues {ev.shape}: "
                         f"expected (p, k) and (k,) for p = {len(coef_names)}")
    dinfo = _dinfo(x, spec=spec, coef_names=coef_names,
                   standardize=standardize, use_all=use_all, means=means,
                   stds=stds, col_means=col_means)
    model = PCAModel(None, x, dinfo, V, ev, V.shape[1], device=device)
    if demean_mu is not None:
        model._demean_mu = np.asarray(demean_mu, np.float64)
    return model


def svd_from_numpy(*, d, v, x: Sequence[str], spec,
                   coef_names: Sequence[str], u=None, means=None, stds=None,
                   col_means=None, standardize: bool = False,
                   use_all: bool = True, device=None) -> SVDModel:
    """Port SVD model from a reference model's state: the singular values
    `d` (k,), the right singular vectors `v` (p, k), the left ones `u`
    (n, k) where kept, and the `DataInfo` state."""
    d = np.asarray(d)
    v = np.asarray(v)
    if v.ndim != 2 or v.shape[0] != len(coef_names) or d.shape != (v.shape[1],):
        raise ValueError(f"v {v.shape} and d {d.shape}: expected (p, k) and "
                         f"(k,) for p = {len(coef_names)}")
    dinfo = _dinfo(x, spec=spec, coef_names=coef_names,
                   standardize=standardize, use_all=use_all, means=means,
                   stds=stds, col_means=col_means)
    return SVDModel(None, x, dinfo, d, v,
                    None if u is None else np.asarray(u), device=device)


def glrm_from_numpy(*, X, Y, objective: float, x: Sequence[str], spec,
                    coef_names: Sequence[str], means=None, stds=None,
                    standardize: bool = False, device=None) -> GLRMModel:
    """Port GLRM model from a reference model's state: the row weights `X`
    (n, k), the archetypes `Y` (k, p), the final objective, and the
    NaN-keeping `DataInfo` state (no imputation; `means`/`stds` set under
    STANDARDIZE, NORMALIZE or DEMEAN)."""
    Xw = np.asarray(X)
    Y = np.asarray(Y)
    if Y.ndim != 2 or Y.shape[1] != len(coef_names) or Xw.shape[1:] != Y.shape[:1]:
        raise ValueError(f"X {Xw.shape} and Y {Y.shape}: expected (n, k) and "
                         f"(k, p) for p = {len(coef_names)}")
    dinfo = _dinfo(x, spec=spec, coef_names=coef_names,
                   standardize=standardize, use_all=True, means=means,
                   stds=stds, col_means=None, impute_missing=False)
    return GLRMModel(None, x, dinfo, Xw, Y, Y.shape[0], float(objective),
                     device=device)


def isoforest_from_numpy(*, feat, thr, is_split, leaf_n, sample_size: int,
                         max_depth: int, x: Sequence[str],
                         device=None) -> IsolationForestModel:
    """Port IsolationForest model from a reference model's trees: each
    field an (ntrees, T) array (or a sequence of per-tree (T,) arrays) for
    T = 2^(max_depth+1) − 1 — the split feature, the f64 threshold, the
    split flag and the training rows reaching each node."""
    T = treelib.heap_size(max_depth)
    fields = [np.asarray(np.stack(list(a)) if isinstance(a, (list, tuple))
                         else a).astype(dt)
              for a, dt in ((feat, np.int64), (thr, np.float64),
                            (is_split, bool), (leaf_n, np.float64))]
    if any(f.ndim != 2 or f.shape != fields[0].shape or f.shape[1] != T
           for f in fields):
        raise ValueError(f"expected (ntrees, {T}) arrays for max_depth "
                         f"{max_depth}, got {[f.shape for f in fields]}")
    trees = [tuple(f[t] for f in fields) for t in range(fields[0].shape[0])]
    return IsolationForestModel(None, x, trees, int(sample_size),
                                int(max_depth), device=device)


def eif_from_numpy(*, dirs, thrs, splits, counts, depth: int,
                   sample_size: int, x: Sequence[str], spec,
                   coef_names: Sequence[str], col_means=None,
                   use_all: bool = True,
                   device=None) -> ExtendedIsolationForestModel:
    """Port ExtendedIsolationForest model from a reference model's state:
    the directions (ntrees, T, p), thresholds and split flags (ntrees, T)
    for T = 2^depth − 1, the training rows per node (ntrees, 2T + 1), and
    the unstandardized `DataInfo` state."""
    dirs = np.array(dirs, np.float32)
    T = 2 ** int(depth) - 1
    nt = dirs.shape[0]
    if dirs.shape != (nt, T, len(coef_names)):
        raise ValueError(f"dirs: expected ({nt}, {T}, {len(coef_names)}), "
                         f"got {dirs.shape}")
    thrs = np.array(thrs, np.float32)
    splits = np.array(splits, bool)
    counts = np.array(counts, np.float32)
    if thrs.shape != (nt, T) or splits.shape != (nt, T) \
            or counts.shape != (nt, 2 * T + 1):
        raise ValueError(f"thrs {thrs.shape}, splits {splits.shape}, counts "
                         f"{counts.shape}: expected ({nt}, {T}) twice and "
                         f"({nt}, {2 * T + 1})")
    dinfo = _dinfo(x, spec=spec, coef_names=coef_names, standardize=False,
                   use_all=use_all, means=None, stds=None,
                   col_means=col_means)
    return ExtendedIsolationForestModel(
        None, x, dinfo, torch.from_numpy(dirs), torch.from_numpy(thrs),
        torch.from_numpy(splits), torch.from_numpy(counts), int(depth),
        int(sample_size), device=device)


def uplift_from_numpy(*, feat, bin, thr, is_split, value,
                      edges: Sequence[np.ndarray], max_depth: int,
                      x: Sequence[str], y: str, nbins: int,
                      treatment_column: str,
                      domain: Optional[List[str]] = None,
                      feature_domains=None,
                      device=None) -> UpliftRandomForestModel:
    """Port UpliftDRF model from a reference model's stacked forest (each
    field (ntrees, T)), the per-feature bin edges, bin count and feature
    domains of its `BinnedMatrix` (None entries for numeric features), its
    response domain and treatment column."""
    dev = devlib.resolve(device)
    T = treelib.heap_size(max_depth)
    fields = []
    for name, a, dt in (("feat", feat, torch.int32), ("bin", bin, torch.int32),
                        ("thr", thr, torch.float32),
                        ("is_split", is_split, torch.bool),
                        ("value", value, torch.float32)):
        a = np.array(a)
        if a.ndim != 2 or a.shape[1] != T:
            raise ValueError(f"{name}: expected (ntrees, {T}) for max_depth "
                             f"{max_depth}, got {a.shape}")
        fields.append(torch.from_numpy(a).to(dt))
    F = len(x)
    doms = list(feature_domains) if feature_domains is not None else [None] * F
    bm = BinnedMatrix(codes=None,
                      edges=[np.asarray(e, np.float64) for e in edges],
                      nbins=int(nbins), names=list(x),
                      is_categorical=np.asarray([d is not None for d in doms]),
                      domains=doms)
    return UpliftRandomForestModel(None, x, y, bm, treelib.Tree(*fields),
                                   int(max_depth), domain, treatment_column,
                                   device=dev)


def naivebayes_from_numpy(*, priors, num_stats, cat_tables, spec,
                          x: Sequence[str], y: str, domain: List[str],
                          device=None) -> NaiveBayesModel:
    """Port NaiveBayes model from a reference model's state: `priors` the
    (K,) class priors, `num_stats` column → (K, 2) per-class mean and sd,
    `cat_tables` column → ((K, L) probabilities, the column's domain),
    `spec` the (column, "num" | "cat") list in scoring order and `domain`
    the K response levels."""
    priors = np.asarray(priors, np.float64)
    K = len(domain)
    if priors.shape != (K,):
        raise ValueError(f"priors: expected ({K},), got {priors.shape}")
    nums = {k: np.asarray(v, np.float64) for k, v in num_stats.items()}
    cats = {k: (np.asarray(t, np.float64), list(d))
            for k, (t, d) in cat_tables.items()}
    spec = [(str(n), str(kind)) for n, kind in spec]
    for n, kind in spec:
        shape = (nums[n] if kind == "num" else cats[n][0]).shape
        if shape[0] != K or (kind == "num" and shape != (K, 2)):
            raise ValueError(f"{n}: expected {K} class rows, got {shape}")
    return NaiveBayesModel(None, x, y, list(domain), priors, nums, cats,
                           spec, device=device)


def isotonic_from_numpy(*, thresholds_x, thresholds_y, x: str, y: str,
                        out_of_bounds: str = "NA",
                        device=None) -> IsotonicRegressionModel:
    """Port isotonic regression model from a reference model's knots: x
    rising, y never falling, and its `out_of_bounds` ("NA" or "clip")."""
    tx = np.asarray(thresholds_x, np.float64)
    ty = np.asarray(thresholds_y, np.float64)
    if tx.ndim != 1 or tx.shape != ty.shape or not len(tx):
        raise ValueError(f"knots: expected two equal (m,) arrays, got "
                         f"{tx.shape} and {ty.shape}")
    return IsotonicRegressionModel(None, x, y, tx, ty, str(out_of_bounds),
                                   device=device)


def gam_from_numpy(*, beta, family: str, x: Sequence[str], y: str, spec,
                   coef_names: Sequence[str], gam_spec, means=None,
                   stds=None, col_means=None, transfer_groups=None,
                   standardize: bool = False, use_all: bool = False,
                   domain: Optional[List[str]] = None,
                   device=None) -> GAMModel:
    """Port GAM from a reference model's state: `beta` the (p+1,) f64
    coefficients over [linear | splines | 1], the linear columns'
    `DataInfo` state as for `glm_from_numpy`, and `gam_spec` the
    (column, knots, centres) of each spline column in design order."""
    gspec = [(str(c), np.asarray(k, np.float64), np.asarray(m, np.float64))
             for c, k, m in gam_spec]
    b = np.asarray(beta, np.float64)
    p1 = len(coef_names) + sum(len(k) - 1 for _, k, _ in gspec) + 1
    if b.shape != (p1,):
        raise ValueError(f"beta: expected ({p1},), got {b.shape}")
    dinfo = DataInfo.from_state(
        spec=spec, coef_names=coef_names, standardize=standardize,
        use_all=use_all, means=means, stds=stds, col_means=col_means,
        transfer_groups=transfer_groups)
    return GAMModel(None, x, y, dinfo, family, b, domain, gspec,
                    device=device)


def _fitted_glm(kwargs: dict, device) -> H2OGeneralizedLinearEstimator:
    """A carried GLM held by an estimator, as the ANOVA and ModelSelection
    models hold their fitted GLMs."""
    est = H2OGeneralizedLinearEstimator(device=device)
    est._model = glm_from_numpy(**dict(kwargs, device=device))
    return est


def anovaglm_from_numpy(*, table, terms, x: Sequence[str], y: str,
                        full_glm: dict, device=None) -> ANOVAGLMModel:
    """Port ANOVA GLM model from a reference model's table (term, df,
    deviance, p_value per row), its terms (tuples of column names) and its
    full GLM's `glm_from_numpy` arguments (over the columns c0, c1, …)."""
    full = _fitted_glm(full_glm, device)
    terms = [tuple(t) for t in terms]
    table = [dict(term=str(r["term"]), df=int(r["df"]),
                  deviance=float(r["deviance"]), p_value=float(r["p_value"]))
             for r in table]
    return ANOVAGLMModel(None, x, y, table, full, terms,
                         H2OANOVAGLMEstimator()._build_design)


def modelselection_from_numpy(*, results, glms, x: Sequence[str], y: str,
                              device=None) -> ModelSelectionModel:
    """Port ModelSelection model from a reference model's results (size,
    predictors and R² per row) and one GLM's `glm_from_numpy` arguments per
    row, in the same order."""
    if len(results) != len(glms):
        raise ValueError(f"{len(results)} results for {len(glms)} GLMs")
    res = [dict(size=int(r["size"]), predictors=list(r["predictors"]),
                r2=float(r["r2"])) for r in results]
    best = [_fitted_glm(g, device) for g in glms]
    return ModelSelectionModel(None, x, y, res, best)


def coxph_from_numpy(*, beta, se, loglik: float, loglik_null: float,
                     concordance: float, n_event: int, x: Sequence[str],
                     y: str, stop_col: str, spec, coef_names: Sequence[str],
                     col_means=None, use_all: bool = False,
                     device=None) -> CoxPHModel:
    """Port CoxPH from a reference model's state: `beta` and `se` the (p,)
    f64 coefficients and standard errors over the uncentred `DataInfo`
    expansion (`spec`, `coef_names`, `col_means`, `use_all`), the
    log-likelihoods, the concordance and the event count."""
    b = np.asarray(beta, np.float64)
    if b.shape != (len(coef_names),):
        raise ValueError(f"beta: expected ({len(coef_names)},), got {b.shape}")
    dinfo = DataInfo.from_state(spec=spec, coef_names=coef_names,
                                standardize=False, use_all=use_all,
                                col_means=col_means)
    model = CoxPHModel(None, x, y, dinfo, b, np.asarray(se, np.float64),
                       float(loglik), float(loglik_null), float(concordance),
                       int(n_event), stop_col, device=device)
    return model


def psvm_from_numpy(*, W, b, beta, bias: float, domain: List[str],
                    kernel: str, svs_count: int, x: Sequence[str], y: str,
                    spec, coef_names: Sequence[str], means, stds,
                    col_means=None, use_all: bool = False,
                    device=None) -> PSVMModel:
    """Port PSVM from a reference model's state: W (p, D) and b (D,) f32
    (None under the linear kernel), β (D,) or (p,) f64, the bias, the
    response domain, the kernel, `svs_count` and the standardized
    `DataInfo` state."""
    dinfo = DataInfo.from_state(spec=spec, coef_names=coef_names,
                                standardize=True, use_all=use_all,
                                means=means, stds=stds, col_means=col_means)
    W = None if W is None else np.asarray(W, np.float32)
    b = None if b is None else np.asarray(b, np.float32)
    beta = np.asarray(beta, np.float64)
    width = len(coef_names) if W is None else W.shape[1]
    if beta.shape != (width,):
        raise ValueError(f"beta: expected ({width},), got {beta.shape}")
    return PSVMModel(None, x, y, dinfo, W, b, beta, float(bias),
                     list(domain), str(kernel), int(svs_count),
                     device=device)


def rulefit_from_numpy(*, rules, lin_cols: Sequence[str], lin_stats,
                       glm: dict, x: Sequence[str], y: str,
                       domain: Optional[List[str]], problem: str,
                       device=None) -> RuleFitModel:
    """Port RuleFit from a reference model's state: `rules` a list of
    (conditions, support, coef), each condition (column, threshold,
    is-right); `lin_cols` and `lin_stats` (column → (lo, hi, sd)); `glm`
    its lasso GLM's `glm_from_numpy` arguments (over the columns rule_i
    and linear.<col>)."""
    kept = []
    for conds, support, coef in rules:
        r = Rule(tuple((str(f), float(t), bool(rt)) for f, t, rt in conds))
        r.support, r.coef = float(support), float(coef)
        kept.append(r)
    est = _fitted_glm(glm, device)
    stats = {c: tuple(float(v) for v in lin_stats[c]) for c in lin_cols}
    return RuleFitModel(None, x, y, kept, list(lin_cols), stats, est, domain,
                        problem, device=device)


def targetencoder_from_numpy(*, encodings, prior: float, blending: bool,
                             inflection_point: float, smoothing: float,
                             noise: float, data_leakage_handling: str,
                             fold_assign, seed: int, x: Sequence[str], y: str,
                             device=None) -> TargetEncoderModel:
    """Port TargetEncoder from a reference model's state: `encodings`
    column → (domain, sums (K,), counts (K,), {fold id: (sums, counts)}),
    f64; `fold_assign` the training rows' fold ids (KFold) or None."""
    if data_leakage_handling not in LEAKAGE_MODES:
        raise ValueError(f"data_leakage_handling={data_leakage_handling!r}: "
                         f"expected one of {LEAKAGE_MODES}")
    enc = {}
    for col, (dom, sums, cnts, folds) in encodings.items():
        sums = np.asarray(sums, np.float64)
        cnts = np.asarray(cnts, np.float64)
        if sums.shape != cnts.shape or sums.ndim != 1:
            raise ValueError(f"{col}: sums {sums.shape} and counts "
                             f"{cnts.shape} must be equal (K,) arrays")
        enc[col] = (list(dom) if dom is not None else dom, sums, cnts,
                    {fid: (np.asarray(fs, np.float64), np.asarray(fc, np.float64))
                     for fid, (fs, fc) in folds.items()})
    fa = None if fold_assign is None else np.asarray(fold_assign, np.int64)
    return TargetEncoderModel(None, x, y, enc, float(prior), bool(blending),
                              float(inflection_point), float(smoothing),
                              float(noise), str(data_leakage_handling), fa,
                              int(seed), device=device)


def word2vec_from_numpy(*, vocab: Sequence[str], vectors) -> Word2VecModel:
    """Port Word2Vec from a reference model's vocabulary and (V, d) f32
    vectors."""
    vec = np.asarray(vectors, np.float32)
    if vec.ndim != 2 or vec.shape[0] != len(vocab):
        raise ValueError(f"vectors: expected ({len(vocab)}, d), got {vec.shape}")
    return Word2VecModel(None, [str(w) for w in vocab], vec)


def aggregator_from_numpy(*, exemplar_idx, counts, x: Sequence[str],
                          training_frame: Frame) -> AggregatorModel:
    """Port Aggregator from a reference model's exemplar row indices and
    member counts over `training_frame` (the port's Frame of the same
    rows): the aggregated frame is rebuilt from it."""
    idx = np.asarray(exemplar_idx, np.int64)
    cnt = np.asarray(counts, np.float64)
    if idx.shape != cnt.shape or idx.ndim != 1:
        raise ValueError(f"exemplar_idx {idx.shape} and counts {cnt.shape} "
                         "must be equal (E,) arrays")
    agg = Frame({n: training_frame.vec(n).take(idx)
                 for n in training_frame.names})
    agg["counts"] = cnt
    return AggregatorModel(None, x, None, agg, idx, cnt)
