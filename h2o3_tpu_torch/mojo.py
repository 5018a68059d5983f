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
`MojoScorer.predict_contributions` runs the plain TreeSHAP of
`models/tree_shap.py` on the host (the serving failover's contributions
scorer). The reference's native C++ scorer (`native/loader.py`) and the other
algorithms' payloads are not ported yet (ROADMAP queue A, items 8, 10 and
11). Exporting any other model raises the reference's `TypeError`.
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
    from .models.glm import GLMModel
    from .models.shared_tree import SharedTreeModel

    if isinstance(model, MojoScorer):
        # a loaded artifact re-exports losslessly: its payload IS its state
        out: Dict[str, Any] = {"meta": dict(model.meta),
                               "arrays": dict(model.arrays)}
        if model.children:
            out["children"] = {k: _model_payload(c)
                               for k, c in model.children.items()}
        return out
    if not isinstance(model, (SharedTreeModel, GLMModel, DeepLearningModel,
                              StackedEnsembleModel)):
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
        if model.dinfo.means is not None:
            arrays["means"] = model.dinfo.means
            arrays["stds"] = model.dinfo.stds
        meta["dinfo"] = _dinfo_meta(model.dinfo)
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
        if model.dinfo.means is not None:
            arrays["means"] = model.dinfo.means
            arrays["stds"] = model.dinfo.stds
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
        in f64 (the reference's numpy walk)."""
        ntrees = feat.shape[0]
        total = np.zeros(X.shape[0])
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
            outs.append(total + (f0k if meta["mode"] != "drf" else 0.0))
        return np.column_stack(outs)

    def _expand_dinfo(self, data) -> np.ndarray:
        from .frame.frame import Frame

        di = self.meta["dinfo"]
        cols = []
        for kind, n, dom in di["spec"]:
            if isinstance(data, Frame):
                v = data.vec(n)
                raw = v.numeric_np()
                codes = np.asarray(v.data) if v.type == "enum" else None
                vdom = v.domain
            else:
                raise TypeError("dinfo models require a Frame input")
            if kind == "num":
                c = np.where(np.isnan(raw), di["col_means"].get(n, 0.0), raw)
                cols.append(c[:, None])
            else:
                codes = _remap_codes(codes, vdom, dom)
                K = len(dom)
                oh = np.zeros((len(codes), K))
                valid = codes >= 0
                oh[np.nonzero(valid)[0], codes[valid]] = 1.0
                if not di["use_all"] and K > 0:
                    oh = oh[:, 1:]
                cols.append(oh)
        X = np.concatenate(cols, axis=1)
        if di["standardize"] and "means" in self.arrays:
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
