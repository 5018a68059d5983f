"""Model artifacts — save/load + standalone scoring, for the port's models.

A copy of the tree parts of `h2o3_tpu/mojo.py`, rewired to the port.
Reference parity: `h2o-genmodel/src/main/java/hex/genmodel/` (`MojoModel`,
`easy/EasyPredictModelWrapper`). An artifact is a zip of `model.json`
(metadata) and `arrays.npz` (numpy arrays), scoreable with numpy alone.
The format is the reference's, member for member: a port model's artifact
loads in `h2o3_tpu.mojo.load_model`, and a reference tree artifact loads
here.

A GBM or DRF is written as its K class forests `forest{k}_*` (K = the
class count of a multinomial model, else 1) with ``n_forests = K`` and the
f0 list, each forest's covers as `forest{k}_cover`. A GLM is written as
its standardized β (`beta`, f64, intercept last; (K, p+1), a row per
class, for a multinomial model), the standardization stats (`means`,
`stds`) and its `DataInfo` state (`meta["dinfo"]`: column spec,
coefficient names, flags and imputation means). `MojoScorer` scores tree
artifacts with the reference's numpy walk, summing in f64, through each
distribution's link, and GLM artifacts by the reference's numpy expansion
and matvec in f64 (a multinomial one through a softmax).
A DeepLearning model is written as its layers' weights and biases
(`W{i}`, `b{i}`, f32) with the same `DataInfo` state, and scored by the
reference's numpy forward pass.
A stacked ensemble is written as its `meta` with a child payload per base
model (`base{i}/`) and one for the metalearner (`meta/`); `MojoScorer`
scores it by building the level-one frame from its children. An XGBoost
model is one of these under algo "xgboost": a tree payload for gbtree,
DART (its round scales baked into the leaf values) and lambdarank, a GLM
payload for gblinear.
The unsupervised estimators write the reference's payloads: K-Means its
standardized centres (`centers_std`), PCA its `eigenvectors` and
`eigenvalues`, SVD `svd_d` and `svd_v`, GLRM its archetypes (`glrm_y`,
f64), each with `means`/`stds` where its `DataInfo` holds them and its
`DataInfo` state. Their numpy scorers are the reference's: the K-Means
argmin and the PCA and SVD projections over the imputed expansion, and
GLRM's `reconstr_*` and `transform` through `_glrm_project`, a masked k×k
solve a row. As in the reference, a PCA payload keeps no DEMEAN means and
an SVD payload no DEMEAN/DESCALE stats (ROADMAP §C).
The isolation forests and the uplift DRF write the reference's payloads
too: an IsolationForest its trees as `if_feat` (int32), `if_thr` (f32,
while the live model compares f64 rows with f64 draws: a row within one
f32 rounding of a threshold may walk another way), `if_split` and
`if_leafn` (f64); an ExtendedIsolationForest its directions, thresholds,
splits and counts (`eif_*`) with its `DataInfo` state; an UpliftDRF its
stacked forest as `uforest_*` with the feature domains and the treatment
column. Their numpy scorers are the reference's: the path-length walk of
`isolation_forest.forest_path_lengths` in f64, the EIF walk over the
imputed f64 expansion, and the uplift forest's leaf values summed in f64
and averaged.
NaiveBayes, isotonic regression and GAM write the reference's payloads:
NaiveBayes its priors (`nb_priors`), each numeric column's per-class mean
and sd (`nb_num_<col>`) and each categorical column's probability table
(`nb_cat_<col>`, with its domain in `meta["nb_spec"]`); isotonic
regression its knots (`iso_tx`, `iso_ty`) and `out_of_bounds`; GAM its β
(f64, intercept last), its `DataInfo` state and each spline column's
knots and centres (`gam{i}_knots`, `gam{i}_center`). Their numpy scorers
are the reference's: the f64 log-posterior with a softmax, `np.interp`,
and the f64 design [expansion | splines | 1] through an f64 inverse link.
ANOVA GLM and ModelSelection export nothing, as in the reference.
CoxPH writes its β (`beta`, f64) with its `DataInfo` state and RuleFit its
rules (`meta["rules"]`: each a list of [column, f64 threshold, is-right]
conditions), its linear terms (`lin_cols`) and their winsorizing stats
(`lin_stats`: 2.5 % and 97.5 % quantiles and sd), with its lasso GLM as
the child payload `glm/`; as in the reference. Their numpy scorers are the
reference's: `lp` = the imputed f64 expansion times β, and the rules
evaluated on f64 rows (NaN right), the linear terms clipped and scaled,
scored by the child GLM. PSVM exports nothing, as in the reference.
A TargetEncoder writes its per-column domains and global level sums and
counts (`te{i}_sums`, `te{i}_cnts`, f64) with the prior and the blending
parameters, scored as the model's plain transform (no leakage handling, no
noise); a Word2Vec model its vocabulary and f32 vectors, with `transform`
(`aggregate_method` "NONE" or "AVERAGE") and `find_synonyms`. Aggregator
exports nothing, as in the reference.
`MojoScorer.predict_contributions` runs the plain TreeSHAP of
`models/tree_shap.py` on the host (the serving failover's contributions
scorer). The reference's native C++ scorer (`native/loader.py`) is not
ported yet (ROADMAP queue A, item 11). Exporting any other model raises the
reference's `TypeError`.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np

FORMAT_VERSION = 1


def _model_payload(model) -> Dict[str, Any]:
    """Extract (meta, arrays) from a trained model."""
    from .models.deeplearning import DeepLearningModel
    from .models.ensemble import StackedEnsembleModel
    from .models.coxph import CoxPHModel
    from .models.extended_isolation_forest import \
        ExtendedIsolationForestModel
    from .models.gam import GAMModel
    from .models.glm import GLMModel
    from .models.glrm import GLRMModel
    from .models.isolation_forest import IsolationForestModel
    from .models.isotonic import IsotonicRegressionModel
    from .models.kmeans import KMeansModel
    from .models.naive_bayes import NaiveBayesModel
    from .models.pca import PCAModel
    from .models.rulefit import RuleFitModel
    from .models.shared_tree import SharedTreeModel
    from .models.svd import SVDModel
    from .models.targetencoder import TargetEncoderModel
    from .models.uplift import UpliftRandomForestModel
    from .models.word2vec import Word2VecModel

    if isinstance(model, MojoScorer):
        # a loaded artifact re-exports losslessly: its payload IS its state
        out: Dict[str, Any] = {"meta": dict(model.meta),
                               "arrays": dict(model.arrays)}
        if model.children:
            out["children"] = {k: _model_payload(c)
                               for k, c in model.children.items()}
        return out
    if not isinstance(model, (SharedTreeModel, GLMModel, DeepLearningModel,
                              StackedEnsembleModel, KMeansModel, PCAModel,
                              SVDModel, GLRMModel, IsolationForestModel,
                              ExtendedIsolationForestModel,
                              UpliftRandomForestModel, NaiveBayesModel,
                              IsotonicRegressionModel, GAMModel,
                              CoxPHModel, RuleFitModel, TargetEncoderModel,
                              Word2VecModel)):
        raise TypeError(
            f"cannot export model of type {type(model).__name__}: "
            "not a MOJO-exportable kind (see docs/mojo.md for the "
            "export matrix and ratified cuts)")
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "model_id": model.model_id,
        "algo": model.algo,
        "x": model.x,
        "y": model.y,
    }
    if isinstance(model, StackedEnsembleModel):
        # recursive artifact: every base model + the metalearner ride
        # along as child payloads (hex/genmodel StackedEnsembleMojoModel)
        meta.update(kind="stackedensemble", problem=model.problem,
                    nclass=model.nclass, domain=model.domain,
                    n_base=len(model.base_models))
        children = {
            f"base{i}": _model_payload(bm.model)
            for i, bm in enumerate(model.base_models)
        }
        children["meta"] = _model_payload(model.meta.model)
        return {"meta": meta, "arrays": arrays, "children": children}
    if isinstance(model, GLMModel):
        meta.update(
            kind="glm", family=model.family, domain=model.domain,
            coef_names=model._names(), standardize=model.dinfo.standardize,
        )
        arrays["beta"] = np.asarray(model.beta, np.float64)
        _stats(arrays, model.dinfo)
        meta["dinfo"] = _dinfo_meta(model.dinfo)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, Word2VecModel):
        meta.update(kind="word2vec", dim=int(model.vectors.shape[1]))
        arrays["w2v_vectors"] = np.asarray(model.vectors, np.float32)
        arrays["w2v_vocab"] = np.asarray(model.vocab, dtype="U")
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, TargetEncoderModel):
        te_cols = []
        for i, (col, (dom, sums, cnts, _folds)) in enumerate(
                model.encodings.items()):
            te_cols.append({"col": col, "domain": list(dom)})
            arrays[f"te{i}_sums"] = np.asarray(sums, np.float64)
            arrays[f"te{i}_cnts"] = np.asarray(cnts, np.float64)
        meta.update(kind="targetencoder", te_cols=te_cols,
                    prior=float(model.prior), blending=bool(model.blending),
                    te_k=float(model.k), te_f=float(model.f))
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, GLRMModel):
        meta.update(kind="glrm", k=model.k,
                    dinfo=_dinfo_meta(model.dinfo))
        arrays["glrm_y"] = np.asarray(model.Y, np.float64)
        _stats(arrays, model.dinfo)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, SVDModel):
        meta.update(kind="svd", dinfo=_dinfo_meta(model.dinfo))
        arrays["svd_d"] = np.asarray(model.d, np.float64)
        arrays["svd_v"] = np.asarray(model.v, np.float64)
        _stats(arrays, model.dinfo)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, KMeansModel):
        meta.update(kind="kmeans", k=model.k)
        arrays["centers_std"] = np.asarray(model.centers_std)
        _stats(arrays, model.dinfo)
        meta["dinfo"] = _dinfo_meta(model.dinfo)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, PCAModel):
        meta.update(kind="pca", k=model.k)
        arrays["eigenvectors"] = np.asarray(model.eigenvectors)
        arrays["eigenvalues"] = np.asarray(model.eigenvalues)
        _stats(arrays, model.dinfo)
        meta["dinfo"] = _dinfo_meta(model.dinfo)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, IsolationForestModel):
        meta.update(kind="isoforest", sample_size=model.sample_size,
                    max_depth=model.max_depth, ntrees=len(model.trees))
        for name, i, dt in (("if_feat", 0, np.int32), ("if_thr", 1, np.float32),
                            ("if_split", 2, bool), ("if_leafn", 3, np.float64)):
            arrays[name] = np.stack([t[i] for t in model.trees]).astype(dt)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, ExtendedIsolationForestModel):
        meta.update(kind="eif", depth=model.depth,
                    sample_size=model.sample_size,
                    dinfo=_dinfo_meta(model.dinfo))
        arrays["eif_dirs"] = model.dirs.cpu().numpy().astype(np.float32)
        arrays["eif_thrs"] = model.thrs.cpu().numpy().astype(np.float32)
        arrays["eif_splits"] = model.splits.cpu().numpy().astype(bool)
        arrays["eif_counts"] = model.counts.cpu().numpy().astype(np.float64)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, UpliftRandomForestModel):
        # one forest whose leaves hold treatment−control differences
        meta.update(kind="uplift", max_depth=model.max_depth,
                    ntrees=model.ntrees_built,
                    feature_domains=model.bm.domains,
                    treatment_col=model.treatment_col)
        for field in ("feat", "bin", "thr", "is_split", "value"):
            arrays[f"uforest_{field}"] = getattr(model.forest,
                                                 field).cpu().numpy()
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, NaiveBayesModel):
        nb_spec = []
        for name, knd in model.spec:
            ent = {"name": name, "kind": knd}
            if knd == "num":
                arrays[f"nb_num_{name}"] = np.asarray(
                    model.num_stats[name], np.float64)
            else:
                probs, dom = model.cat_tables[name]
                ent["domain"] = list(dom)
                arrays[f"nb_cat_{name}"] = np.asarray(probs, np.float64)
            nb_spec.append(ent)
        meta.update(kind="naivebayes", domain=model.domain, nb_spec=nb_spec)
        arrays["nb_priors"] = np.asarray(model.priors, np.float64)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, IsotonicRegressionModel):
        meta.update(kind="isotonic", out_of_bounds=model.out_of_bounds)
        arrays["iso_tx"] = np.asarray(model.thresholds_x, np.float64)
        arrays["iso_ty"] = np.asarray(model.thresholds_y, np.float64)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, GAMModel):
        # the spline basis (knots + centring) rides along, so the artifact
        # scores new data as the live model does
        meta.update(kind="gam", family=model.family, domain=model.domain,
                    dinfo=_dinfo_meta(model.dinfo),
                    gam_cols=[c for c, _, _ in model.gam_spec])
        arrays["beta"] = np.asarray(model.beta, np.float64)
        for i, (_col, knots, center) in enumerate(model.gam_spec):
            arrays[f"gam{i}_knots"] = np.asarray(knots, np.float64)
            arrays[f"gam{i}_center"] = np.asarray(center, np.float64)
        _stats(arrays, model.dinfo)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, RuleFitModel):
        meta.update(
            kind="rulefit",
            rules=[[[str(f), float(t), bool(rt)] for (f, t, rt) in r.conds]
                   for r in model.rules],
            lin_cols=list(model.lin_cols),
            lin_stats={c: [float(v) for v in model.lin_stats[c]]
                       for c in model.lin_cols},
        )
        return {"meta": meta, "arrays": arrays,
                "children": {"glm": _model_payload(model._glm.model)}}
    if isinstance(model, CoxPHModel):
        meta.update(kind="coxph", dinfo=_dinfo_meta(model.dinfo))
        arrays["beta"] = np.asarray(model.beta, np.float64)
        _stats(arrays, model.dinfo)
        return {"meta": meta, "arrays": arrays}
    if isinstance(model, DeepLearningModel):
        meta.update(
            kind="deeplearning", problem=model.problem, nclass=model.nclass,
            domain=model.domain, activation=model.activation,
            distribution=model.distribution, n_layers=len(model.net_params),
        )
        for i, (W, b) in enumerate(model.net_params):
            arrays[f"W{i}"] = W.cpu().numpy()
            arrays[f"b{i}"] = b.cpu().numpy()
        _stats(arrays, model.dinfo)
        meta["dinfo"] = _dinfo_meta(model.dinfo)
        return {"meta": meta, "arrays": arrays}
    meta.update(
        kind="tree", problem=model.problem, nclass=model.nclass,
        domain=model.domain, distribution=model.distribution,
        max_depth=model.max_depth, mode=model.mode,
        ntrees=model.ntrees_built,
        f0=np.asarray(model.f0).tolist(),
        feature_domains=model.bm.domains,
    )
    for k, stacked in enumerate(model.forest):
        for field in ("feat", "bin", "thr", "is_split", "value"):
            arrays[f"forest{k}_{field}"] = getattr(stacked, field).cpu().numpy()
        if model.covers:
            # per-node training covers — predict_contributions (TreeSHAP)
            arrays[f"forest{k}_cover"] = (
                model.covers[k].cpu().numpy().astype(np.float32))
    meta["n_forests"] = len(model.forest)
    return {"meta": meta, "arrays": arrays}


def _stats(arrays: Dict[str, np.ndarray], dinfo) -> None:
    """The standardization stats, where the `DataInfo` holds them."""
    if dinfo.means is not None:
        arrays["means"] = dinfo.means
        arrays["stds"] = dinfo.stds


def _dinfo_meta(dinfo) -> Dict:
    return {
        "spec": [[k, n, d] for (k, n, d) in dinfo._spec],
        "coef_names": dinfo.coef_names,
        "standardize": dinfo.standardize,
        "use_all": dinfo.use_all,
        "col_means": dinfo.col_means,
    }


def save_model(est_or_model, path: str = ".", filename: Optional[str] = None,
               force: bool = False) -> str:
    model = getattr(est_or_model, "model", est_or_model)
    payload = _model_payload(model)
    os.makedirs(path, exist_ok=True) if not os.path.splitext(path)[1] else None
    if os.path.isdir(path) or not os.path.splitext(path)[1]:
        fn = filename or f"{model.model_id}.h2o3"
        out = os.path.join(path, fn)
    else:
        out = path
    if os.path.exists(out) and not force:
        raise FileExistsError(f"{out} exists; pass force=True")
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        _write_payload(z, "", payload)
    return out


def _write_payload(z: "zipfile.ZipFile", prefix: str, payload: Dict) -> None:
    """One payload (meta + arrays [+ children, recursively]) under a zip
    prefix — the nested-directory MOJO convention."""
    z.writestr(prefix + "model.json", json.dumps(payload["meta"]))
    buf = io.BytesIO()
    np.savez(buf, **payload["arrays"])
    z.writestr(prefix + "arrays.npz", buf.getvalue())
    for name, child in (payload.get("children") or {}).items():
        _write_payload(z, f"{prefix}{name}/", child)


def _read_payload(z: "zipfile.ZipFile", prefix: str,
                  names: List[str]) -> "MojoScorer":
    meta = json.loads(z.read(prefix + "model.json"))
    arrays = dict(np.load(io.BytesIO(z.read(prefix + "arrays.npz"))))
    kids = sorted({
        n[len(prefix):].split("/", 1)[0]
        for n in names
        if n.startswith(prefix) and "/" in n[len(prefix):]
    })
    children = {k: _read_payload(z, f"{prefix}{k}/", names) for k in kids}
    return MojoScorer(meta, arrays, children=children or None)


def load_model(path: str) -> "MojoScorer":
    with zipfile.ZipFile(path) as z:
        return _read_payload(z, "", z.namelist())


def _remap_codes(codes: np.ndarray, vdom, dom) -> np.ndarray:
    """Align enum codes from a scoring frame's domain to the stored
    training domain (-1 = unseen level)."""
    if vdom != dom and vdom:
        lookup = {d: i for i, d in enumerate(dom)}
        remap = np.asarray([lookup.get(d, -1) for d in vdom], np.int64)
        codes = np.where(codes >= 0, remap[np.maximum(codes, 0)], -1)
    return codes


class MojoScorer:
    """Numpy-only offline scorer — `EasyPredictModelWrapper` equivalent.

    predict() accepts a Frame or a numpy matrix in training-column order and
    returns the same columns the in-process scorer produces."""

    def __init__(self, meta: Dict, arrays: Dict[str, np.ndarray],
                 children: Optional[Dict[str, "MojoScorer"]] = None):
        self.meta = meta
        self.arrays = arrays
        self.children = children or {}
        self.algo = meta["algo"]
        self.model_id = meta.get("model_id", "artifact")
        self.x = meta["x"]
        self.y = meta["y"]

    def scoring_signature(self) -> tuple:
        """Serving-cache key parts, so loaded artifacts ride the same
        scorer cache as live models."""
        x = self.x
        nf = len(x) if isinstance(x, (list, tuple)) else (1 if x else 0)
        return (nf, "float32")

    def _matrix(self, data) -> np.ndarray:
        from .frame.frame import Frame

        if isinstance(data, Frame):
            from .models.shared_tree import frame_to_matrix

            X, _, _ = frame_to_matrix(
                data, self.x, expected_domains=self.meta.get("feature_domains")
            )
            return X
        return np.asarray(data, np.float64)

    @staticmethod
    def _score_one_forest(feat, thr, split, value, D: int,
                          X: np.ndarray) -> np.ndarray:
        """Summed leaf values of one stacked forest over raw feature rows,
        in f64 (the reference's numpy walk); on f32 rows, in f32, the
        trees added in order from 0.0."""
        ntrees = feat.shape[0]
        total = np.zeros(X.shape[0], X.dtype)
        for t in range(ntrees):
            node = np.zeros(X.shape[0], np.int64)
            for _ in range(D):
                f = feat[t][node]
                s = split[t][node]
                xv = X[np.arange(X.shape[0]), f]
                right = np.isnan(xv) | (xv > thr[t][node])
                child = 2 * node + 1 + (right & s).astype(np.int64)
                node = np.where(s, child, node)
            total += value[t][node]
        return total

    def _tree_scores(self, X: np.ndarray) -> np.ndarray:
        meta = self.meta
        D = meta["max_depth"]
        outs = []
        for k in range(meta["n_forests"]):
            a = self.arrays
            total = self._score_one_forest(
                a[f"forest{k}_feat"], a[f"forest{k}_thr"],
                a[f"forest{k}_is_split"].astype(bool),
                a[f"forest{k}_value"], D, X)
            f0 = meta["f0"]
            f0k = f0[k] if isinstance(f0, list) else f0
            outs.append(total.astype(np.float64)
                        + (f0k if meta["mode"] != "drf" else 0.0))
        return np.column_stack(outs)

    def tree_margins(self, data) -> np.ndarray:
        """(N, K) f64 margins of a tree artifact on f32 rows, each class
        forest's trees added in order in f32 from 0.0 and f0 added in f64:
        the forest kernels' order and routing, so they equal the fitted
        model's `_margins` on the card bit for bit."""
        return self._tree_scores(self._matrix(data).astype(np.float32))

    def _expand_raw(self, data, impute: bool) -> np.ndarray:
        """The one-hot expansion of the `DataInfo` spec, f64; numeric NaNs
        filled with the stored column means if `impute`, else kept."""
        from .frame.frame import Frame

        if not isinstance(data, Frame):
            raise TypeError("dinfo models require a Frame input")
        di = self.meta["dinfo"]
        cols = []
        for kind, n, dom in di["spec"]:
            v = data.vec(n)
            if kind == "num":
                c = v.numeric_np()
                if impute:
                    c = np.where(np.isnan(c), di["col_means"].get(n, 0.0), c)
                cols.append(c[:, None])
            else:
                codes = _remap_codes(np.asarray(v.data), v.domain, dom)
                K = len(dom)
                oh = np.zeros((len(codes), K))
                valid = codes >= 0
                oh[np.nonzero(valid)[0], codes[valid]] = 1.0
                if not di["use_all"] and K > 0:
                    oh = oh[:, 1:]
                cols.append(oh)
        return np.concatenate(cols, axis=1)

    def _expand_dinfo(self, data) -> np.ndarray:
        X = self._expand_raw(data, impute=True)
        if self.meta["dinfo"]["standardize"] and "means" in self.arrays:
            X = (X - self.arrays["means"]) / self.arrays["stds"]
        return np.nan_to_num(X, nan=0.0)

    def _glm_predict(self, data):
        from .frame.frame import Frame

        meta = self.meta
        X = self._expand_dinfo(data)
        Xi = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        eta = Xi @ self.arrays["beta"].T
        fam = meta["family"]
        if fam in ("binomial", "quasibinomial", "fractionalbinomial"):
            p1 = 1 / (1 + np.exp(-np.clip(eta, -500, 500)))
            dom = meta["domain"]
            return Frame.from_dict({
                "predict": np.asarray(dom, dtype=object)[(p1 > 0.5).astype(int)],
                str(dom[0]): 1 - p1, str(dom[1]): p1,
            }, column_types={"predict": "enum"})
        if fam == "multinomial":
            e = np.exp(eta - eta.max(axis=1, keepdims=True))
            probs = e / e.sum(axis=1, keepdims=True)
            dom = meta["domain"]
            d = {"predict": np.asarray(dom, dtype=object)[probs.argmax(axis=1)]}
            for i, cls in enumerate(dom):
                d[str(cls)] = probs[:, i]
            return Frame.from_dict(d, column_types={"predict": "enum"})
        if fam in ("poisson", "gamma", "tweedie"):
            eta = np.exp(eta)
        return Frame.from_dict({"predict": eta})

    def _naivebayes_predict(self, data):
        """The reference's numpy NaiveBayes scorer: f64 log-priors plus the
        Gaussian log-densities and table log-probabilities, a softmax."""
        from .frame.frame import Frame

        meta = self.meta
        n = data.nrow
        priors = self.arrays["nb_priors"]
        logp = np.tile(np.log(priors)[None, :], (n, 1))
        for ent in meta["nb_spec"]:
            name = ent["name"]
            v = data.vec(name)
            if ent["kind"] == "num":
                col = v.numeric_np()
                st = self.arrays[f"nb_num_{name}"]
                mean, sd = st[:, 0], st[:, 1]
                valid = ~np.isnan(col)
                ll = (-0.5 * np.log(2 * np.pi * sd[None, :] ** 2)
                      - 0.5 * ((np.where(valid, col, 0.0)[:, None]
                                - mean[None, :]) / sd[None, :]) ** 2)
                logp += np.where(valid[:, None], ll, 0.0)
            else:
                probs = self.arrays[f"nb_cat_{name}"]
                codes = _remap_codes(np.asarray(v.data), v.domain,
                                     ent["domain"])
                valid = codes >= 0
                ll = np.log(probs[:, np.maximum(codes, 0)]).T
                logp += np.where(valid[:, None], ll, 0.0)
        mshift = logp - logp.max(axis=1, keepdims=True)
        probs2 = np.exp(mshift) / np.exp(mshift).sum(axis=1, keepdims=True)
        dom = meta["domain"]
        d = {"predict": np.asarray(dom, dtype=object)[probs2.argmax(axis=1)]}
        for i, cls in enumerate(dom):
            d[str(cls)] = probs2[:, i]
        return Frame.from_dict(d, column_types={"predict": "enum"})

    def _isotonic_predict(self, data):
        from .frame.frame import Frame

        xname = self.x if isinstance(self.x, str) else self.x[0]
        col = data.vec(xname).numeric_np()
        tx, ty = self.arrays["iso_tx"], self.arrays["iso_ty"]
        p = np.interp(col, tx, ty)
        if self.meta["out_of_bounds"].lower() == "na":
            p = np.where((col < tx[0]) | (col > tx[-1]), np.nan, p)
        p = np.where(np.isnan(col), np.nan, p)
        return Frame.from_dict({"predict": p})

    def _gam_predict(self, data):
        """The reference's numpy GAM scorer: the f64 design [expansion |
        centred spline bases | 1] times β, through an f64 inverse link."""
        from .frame.frame import Frame
        from .ops.splines import spline_basis

        meta = self.meta
        parts = []
        if meta["dinfo"]["spec"]:
            parts.append(self._expand_dinfo(data))
        for i, col in enumerate(meta["gam_cols"]):
            raw = np.nan_to_num(data.vec(col).numeric_np())
            parts.append(spline_basis(raw, self.arrays[f"gam{i}_knots"])
                         - self.arrays[f"gam{i}_center"])
        X = np.concatenate(parts, axis=1)
        eta = (np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
               @ self.arrays["beta"])
        fam = meta["family"]
        if fam == "binomial":
            p1 = 1 / (1 + np.exp(-np.clip(eta, -500, 500)))
            dom = meta["domain"]
            return Frame.from_dict({
                "predict": np.asarray(dom, dtype=object)[
                    (p1 > 0.5).astype(int)],
                str(dom[0]): 1 - p1, str(dom[1]): p1,
            }, column_types={"predict": "enum"})
        if fam in ("poisson", "gamma", "tweedie"):
            eta = np.exp(eta)
        return Frame.from_dict({"predict": eta})

    def _rulefit_predict(self, data):
        """The reference's numpy RuleFit scorer: each rule on the f64 rows
        (NaN right), the linear terms clipped and scaled, the child GLM."""
        from .frame.frame import Frame

        meta = self.meta
        cols = [data.vec(n).numeric_np() for n in self.x]
        X = np.column_stack(cols) if cols else np.zeros((data.nrow, 0))
        col_of = {n: i for i, n in enumerate(self.x)}
        d = {}
        for i, conds in enumerate(meta["rules"]):
            m = np.ones(X.shape[0], bool)
            for fname, thr, right in conds:
                col = X[:, col_of[fname]]
                if right:
                    m &= np.isnan(col) | (col > thr)
                else:
                    m &= ~np.isnan(col) & (col <= thr)
            d[f"rule_{i}"] = m.astype(np.float64)
        for c in meta["lin_cols"]:
            lo, hi, sd = meta["lin_stats"][c]
            col = np.clip(np.nan_to_num(data.vec(c).numeric_np()), lo, hi)
            d[f"linear.{c}"] = 0.4 * col / max(sd, 1e-12)
        return self.children["glm"].predict(Frame.from_dict(d))

    def _deeplearning_predict(self, data):
        """The reference's numpy forward pass (f32 weights, f64 rows): the
        hidden activations, then a softmax, exp for the log-link families,
        or the output as it is. An autoencoder's artifact gives its
        reconstruction as the model's `predict` does (`reconstr_<coef>`
        columns; the reference's scorer keeps only the first column, under
        "predict")."""
        from .frame.frame import Frame

        meta = self.meta
        h = self._expand_dinfo(data)
        L = meta["n_layers"]
        act = meta["activation"].replace("WithDropout", "")
        for i in range(L):
            z = h @ self.arrays[f"W{i}"] + self.arrays[f"b{i}"]
            if i < L - 1:
                if act == "Rectifier":
                    h = np.maximum(z, 0)
                elif act == "Tanh":
                    h = np.tanh(z)
                else:  # Maxout
                    h = z.reshape(z.shape[0], -1, 2).max(axis=2)
            else:
                h = z
        problem = meta["problem"]
        if problem == "autoencoder":
            return Frame.from_dict(
                {f"reconstr_{n}": h[:, i]
                 for i, n in enumerate(meta["dinfo"]["coef_names"])})
        if problem in ("binomial", "multinomial"):
            e = np.exp(h - h.max(axis=1, keepdims=True))
            probs = e / e.sum(axis=1, keepdims=True)
            dom = meta["domain"]
            d = {"predict": np.asarray(dom, dtype=object)[probs.argmax(axis=1)]}
            for i, cls in enumerate(dom):
                d[str(cls)] = probs[:, i]
            return Frame.from_dict(d, column_types={"predict": "enum"})
        out = h[:, 0]
        if meta["distribution"] in ("poisson", "gamma", "tweedie"):
            out = np.exp(out)
        return Frame.from_dict({"predict": out})

    def _ensemble_predict(self, data):
        """A stacked ensemble: each base child scores the rows, its class
        probabilities (or values) form the level-one frame, and the
        metalearner child scores that."""
        from .frame.frame import Frame

        meta = self.meta
        lvl1 = {}
        problem = meta["problem"]
        for i in range(meta["n_base"]):
            base = self.children[f"base{i}"]
            pf = base.predict(data)
            bdom = base.meta.get("domain")
            if problem == "multinomial":
                for k2, cls in enumerate(bdom):
                    lvl1[f"m{i}_p{k2}"] = pf.vec(str(cls)).numeric_np()
            elif problem == "binomial":
                lvl1[f"m{i}"] = pf.vec(str(bdom[1])).numeric_np()
            else:
                lvl1[f"m{i}"] = pf.vec("predict").numeric_np()
        return self.children["meta"].predict(Frame.from_dict(lvl1))

    def _unsupervised_predict(self, data):
        """The reference's numpy scorers of the unsupervised kinds: the
        K-Means argmin of ‖x‖² − 2x·cᵀ + ‖c‖², the PCA scores X·V, the SVD
        projection X·v / d (over the imputed, standardized expansion), and
        the GLRM reconstruction X̂·Y of `_glrm_project`'s weights."""
        from .frame.frame import Frame

        kind = self.meta["kind"]
        if kind == "glrm":
            X = self._glrm_project(data)
            R = X @ self.arrays["glrm_y"]
            names = self.meta["dinfo"]["coef_names"]
            return Frame.from_dict(
                {f"reconstr_{names[j]}": R[:, j] for j in range(R.shape[1])})
        X = self._expand_dinfo(data)
        if kind == "kmeans":
            c = self.arrays["centers_std"]
            d2 = (np.sum(X * X, axis=1, keepdims=True) - 2.0 * X @ c.T
                  + np.sum(c * c, axis=1)[None, :])
            return Frame.from_dict({"predict": d2.argmin(axis=1).astype(np.float64)})
        if kind == "pca":
            scores = X @ self.arrays["eigenvectors"]
            return Frame.from_dict(
                {f"PC{i+1}": scores[:, i] for i in range(self.meta["k"])})
        scores = (X @ self.arrays["svd_v"]
                  ) / np.maximum(self.arrays["svd_d"][None, :], 1e-300)
        return Frame.from_dict(
            {f"u{i+1}": scores[:, i] for i in range(scores.shape[1])})

    def _anomaly_predict(self, data):
        """The isolation forests' numpy scorers: IsolationForest's f64
        path-length walk over the raw rows against the f32 thresholds of
        its payload, and the EIF walk over the imputed f64 expansion, each
        tree's stopping depth + the c(leaf size) credit averaged."""
        from .frame.frame import Frame
        from .models.isolation_forest import (anomaly_scores,
                                              forest_path_lengths)

        meta, a = self.meta, self.arrays
        if meta["kind"] == "isoforest":
            X = self._matrix(data)
            trees = zip(a["if_feat"], a["if_thr"], a["if_split"],
                        a["if_leafn"])
            pl = forest_path_lengths(trees, X, meta["max_depth"])
            score = anomaly_scores(pl, meta["sample_size"])
            return Frame.from_dict({"predict": score, "mean_length": pl})
        X = self._expand_dinfo(data)
        depth = meta["depth"]
        dirs, thrs = a["eif_dirs"], a["eif_thrs"]
        splits, counts = a["eif_splits"], a["eif_counts"]
        N = X.shape[0]
        pls = []
        for t in range(dirs.shape[0]):
            idx = np.zeros(N, np.int64)
            depth_stop = np.full(N, float(depth))
            stop_node = np.zeros(N, np.int64)
            live = np.ones(N, bool)
            for d in range(depth):
                node = 2 ** d - 1 + idx
                s = splits[t][node]
                proj = np.sum(X * dirs[t][node], axis=1)
                stopping = live & ~s
                depth_stop[stopping] = d
                stop_node[stopping] = node[stopping]
                live &= s
                go_right = live & (proj > thrs[t][node])
                idx = np.where(live, 2 * idx + go_right.astype(np.int64), idx)
            stop_node = np.where(live, 2 ** depth - 1 + idx, stop_node)
            nleaf = counts[t][stop_node]
            credit = np.where(
                nleaf > 1.5,
                2.0 * (np.log(np.maximum(nleaf - 1.0, 1.0)) + 0.5772156649)
                - 2.0 * (nleaf - 1.0) / np.maximum(nleaf, 1.0),
                0.0)
            pls.append(depth_stop + credit)
        mean_length = np.mean(pls, axis=0)
        S = max(meta["sample_size"], 2.0)
        cS = 2.0 * (np.log(S - 1.0) + 0.5772156649) - 2.0 * (S - 1.0) / S
        return Frame.from_dict({"anomaly_score": 2.0 ** (-mean_length / cS),
                                "mean_length": mean_length})

    def _uplift_predict(self, data):
        """The uplift forest's leaf values summed in f64 and averaged."""
        from .frame.frame import Frame

        a = self.arrays
        total = self._score_one_forest(
            a["uforest_feat"], a["uforest_thr"],
            a["uforest_is_split"].astype(bool), a["uforest_value"],
            self.meta["max_depth"], self._matrix(data))
        return Frame.from_dict(
            {"uplift_predict": total / max(self.meta["ntrees"], 1)})

    def _glrm_project(self, data) -> np.ndarray:
        """GLRM row loadings for new data — the expansion keeps NaNs so
        the observation mask survives (GLRMModel._project semantics); one
        masked k×k solve a row, as in the reference."""
        A = self._expand_raw(data, impute=False)
        if "means" in self.arrays:
            A = (A - self.arrays["means"]) / self.arrays["stds"]
        Y = self.arrays["glrm_y"]
        k = Y.shape[0]
        mask = ~np.isnan(A)
        A0 = np.nan_to_num(A, nan=0.0)
        lam = 1e-6
        Xn = np.zeros((A.shape[0], k))
        YT = Y.T
        for i in range(A.shape[0]):
            m = mask[i]
            G = YT[m].T @ YT[m] + lam * np.eye(k)
            Xn[i] = np.linalg.solve(G, YT[m].T @ A0[i, m])
        return Xn

    def transform(self, data, aggregate_method: str = "NONE"):
        """word2vec words → vectors (``aggregate_method`` "AVERAGE": one
        mean vector per NA-delimited sentence), GLRM archetype loadings
        (`Arch{j}`) and targetencoder column appends, offline."""
        from .frame.frame import Frame

        kind = self.meta["kind"]
        if kind == "glrm":
            Xn = self._glrm_project(data)
            return Frame.from_dict(
                {f"Arch{j+1}": Xn[:, j] for j in range(Xn.shape[1])})
        if kind == "targetencoder":
            return self._targetencoder_predict(data)
        if kind != "word2vec":
            raise ValueError(f"transform is not defined for kind {kind!r}")
        vecs, vocab, index = self._w2v()
        col = data.vecs()[0]
        words = (col.to_numpy() if col.type == "string" else np.asarray(
            [col.domain[c] if c >= 0 else None
             for c in np.asarray(col.data)], dtype=object))
        dim = vecs.shape[1]
        if aggregate_method.upper() == "NONE":
            out = np.full((len(words), dim), np.nan)
            for i, w in enumerate(words):
                if w is not None and w in index:
                    out[i] = vecs[index[w]]
            return Frame.from_dict(
                {f"C{j+1}": out[:, j] for j in range(dim)})
        sents, cur = [], []
        for w in words:
            if w is None:
                sents.append(cur)
                cur = []
            else:
                cur.append(w)
        sents.append(cur)
        rows = []
        for s in sents:
            hit = [vecs[index[w]] for w in s if w in index]
            rows.append(np.mean(hit, axis=0) if hit
                        else np.full(dim, np.nan))
        out = np.stack(rows)
        return Frame.from_dict({f"C{j+1}": out[:, j] for j in range(dim)})

    def _w2v(self):
        """(vectors, vocab, word → index), decoded once per scorer."""
        if "_w2v_cache" not in self.__dict__:
            vocab = [str(w) for w in self.arrays["w2v_vocab"]]
            self._w2v_cache = (self.arrays["w2v_vectors"], vocab,
                               {w: i for i, w in enumerate(vocab)})
        return self._w2v_cache

    def find_synonyms(self, word: str, count: int = 20) -> Dict[str, float]:
        if self.meta["kind"] != "word2vec":
            raise ValueError("find_synonyms requires a word2vec artifact")
        vecs, vocab, index = self._w2v()
        if word not in index:
            return {}
        v = vecs[index[word]]
        norms = (np.linalg.norm(vecs, axis=1)
                 * max(np.linalg.norm(v), 1e-12))
        sims = vecs @ v / np.maximum(norms, 1e-12)
        out = {}
        for i in np.argsort(-sims):
            if vocab[i] == word:
                continue
            out[vocab[i]] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def _targetencoder_predict(self, data):
        """The reference's numpy encoding: each `<col>_te` from the global
        tables (no leakage handling, no noise), f64 then f32."""
        from .frame.frame import Frame
        from .frame.vec import Vec

        meta = self.meta
        out = {n: v for n, v in zip(data.names, data.vecs())}
        for i, ent in enumerate(meta["te_cols"]):
            col, dom = ent["col"], ent["domain"]
            if col not in data.names:
                continue
            v = data.vec(col)
            codes = (np.asarray(v.data) if v.type == "enum"
                     else v.numeric_np().astype(np.int64))
            if v.type == "enum":
                codes = _remap_codes(codes, v.domain, dom)
            sums = self.arrays[f"te{i}_sums"]
            cnts = self.arrays[f"te{i}_cnts"]
            prior = meta["prior"]
            enc = np.full(len(codes), prior)
            ok = (codes >= 0) & (codes < len(sums))
            ci = np.maximum(codes, 0)
            s, c = sums[ci], cnts[ci]
            if meta["blending"]:
                # the model's blend: the mean is s / max(c, 1e-12), 0.0 for
                # an empty level, not the prior
                with np.errstate(over="ignore"):
                    lam = 1.0 / (1.0 + np.exp(
                        -(c - meta["te_k"]) / max(meta["te_f"], 1e-12)))
                e = lam * (s / np.maximum(c, 1e-12)) + (1 - lam) * prior
            else:
                e = np.where(c > 0, s / np.maximum(c, 1e-12), prior)
            enc[ok] = e[ok]
            out[f"{col}_te"] = Vec(enc.astype(np.float32), "real")
        return Frame(out)

    def predict_contributions(self, data):
        """Offline SHAP contributions and BiasTerm (the genmodel side's
        `predictContributions`): tree artifacts with recorded covers only,
        binomial and regression, as the model's. The plain TreeSHAP of
        `models/tree_shap.py` on the host: this scorer never uses the
        card."""
        import torch

        from .frame.frame import Frame
        from .models.tree import Tree
        from .models.tree_shap import compute_contributions

        meta = self.meta
        if meta["kind"] != "tree":
            raise ValueError("predict_contributions requires a tree artifact")
        if meta["problem"] == "multinomial":
            raise ValueError("predict_contributions is not supported for "
                             "multinomial models")
        if "forest0_cover" not in self.arrays:
            raise ValueError("artifact has no node covers (exported before "
                             "TreeSHAP support); re-export the model")
        a = self.arrays
        forest = Tree(*[torch.from_numpy(np.ascontiguousarray(a[f"forest0_{f}"],
                                                             dt))
                        for f, dt in (("feat", np.int32), ("bin", np.int32),
                                      ("thr", np.float32), ("is_split", bool),
                                      ("value", np.float32))])
        cover = torch.from_numpy(np.ascontiguousarray(a["forest0_cover"],
                                                      np.float32))
        X = torch.from_numpy(np.ascontiguousarray(self._matrix(data),
                                                  np.float64))
        scale = 1.0 / max(meta["ntrees"], 1) if meta["mode"] == "drf" else 1.0
        f0 = meta["f0"]
        f0k = f0[0] if isinstance(f0, list) else f0
        contrib = compute_contributions(forest, cover, X, scale,
                                        f0k).numpy()
        names = list(self.x) + ["BiasTerm"]
        return Frame.from_dict({n: contrib[:, j] for j, n in enumerate(names)})

    def predict(self, data):
        from .frame.frame import Frame

        meta = self.meta
        if meta["kind"] == "glm":
            return self._glm_predict(data)
        if meta["kind"] == "stackedensemble":
            return self._ensemble_predict(data)
        if meta["kind"] == "deeplearning":
            return self._deeplearning_predict(data)
        if meta["kind"] in ("kmeans", "pca", "svd", "glrm"):
            return self._unsupervised_predict(data)
        if meta["kind"] in ("isoforest", "eif"):
            return self._anomaly_predict(data)
        if meta["kind"] == "uplift":
            return self._uplift_predict(data)
        if meta["kind"] == "naivebayes":
            return self._naivebayes_predict(data)
        if meta["kind"] == "isotonic":
            return self._isotonic_predict(data)
        if meta["kind"] == "gam":
            return self._gam_predict(data)
        if meta["kind"] == "rulefit":
            return self._rulefit_predict(data)
        if meta["kind"] == "word2vec":
            return self.transform(data)
        if meta["kind"] == "targetencoder":
            return self._targetencoder_predict(data)
        if meta["kind"] == "coxph":
            return Frame.from_dict(
                {"lp": self._expand_dinfo(data) @ self.arrays["beta"]})
        if meta["kind"] != "tree":
            raise NotImplementedError(
                f"scoring a {meta['kind']!r} artifact is not ported "
                "(ROADMAP queue A, item 11)")
        X = self._matrix(data)
        m = self._tree_scores(X)
        problem = meta["problem"]
        if meta["mode"] == "drf":
            m = m / max(meta["ntrees"], 1)
            if problem == "binomial":
                p1 = np.clip(m[:, 0], 0, 1)
                probs = np.column_stack([1 - p1, p1])
            elif problem == "multinomial":
                p = np.clip(m, 0, None)
                probs = p / np.maximum(p.sum(axis=1, keepdims=True), 1e-12)
            else:
                return Frame.from_dict({"predict": m[:, 0]})
        else:
            if problem == "binomial":
                p1 = 1 / (1 + np.exp(-m[:, 0]))
                probs = np.column_stack([1 - p1, p1])
            elif problem == "multinomial":
                e = np.exp(m - m.max(axis=1, keepdims=True))
                probs = e / e.sum(axis=1, keepdims=True)
            else:
                out = m[:, 0]
                if meta["distribution"] in ("poisson", "gamma", "tweedie"):
                    out = np.exp(out)
                return Frame.from_dict({"predict": out})
        dom = meta["domain"]
        d = {"predict": np.asarray(dom, dtype=object)[probs.argmax(axis=1)]}
        for i, cls in enumerate(dom):
            d[str(cls)] = probs[:, i]
        return Frame.from_dict(d, column_types={"predict": "enum"})
