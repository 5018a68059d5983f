"""Carry a trained model across from its numpy arrays.

A tree model's "weights" are its forests: per class forest (K of them for a
multinomial model, else one) and per tree the heap arrays `feat`, `bin`,
`thr`, `is_split` and `value` (plus the node covers), the initial margin
`f0` (a K-vector for multinomial), the bin edges, the heap depth and the
mode (``"gbm"`` sums the trees through the link; ``"drf"`` averages them).
`forest_from_numpy` builds the port's model from them, so a GBM or DRF
model trained by the JAX package (whose arrays the caller reads out as
numpy) scores in the port.

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
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from . import device as devlib
from .frame.binning import BinnedMatrix
from .models import tree as treelib
from .models.deeplearning import ACTIVATIONS, DeepLearningModel
from .models.glm import FAMILIES, GLMModel
from .models.model_base import DataInfo
from .models.shared_tree import SharedTreeModel


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
                      device=None) -> SharedTreeModel:
    """Port model from heap arrays: each field one (ntrees, T) array, or K
    of them for a multinomial model (one per class forest, in class order).
    `f0` is a float, or the K-vector of a multinomial model. `edges` are
    the per-feature bin edges of the training `BinnedMatrix`; `domain` the
    response levels of a classifier; `mode` the reference model's `mode`;
    `algo` its algo where it is not the shared tree's ("xgboost")."""
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
