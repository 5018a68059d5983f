"""H2OANOVAGLMEstimator — type-III ANOVA decomposition via GLM refits.

Port of `h2o3_tpu/models/anovaglm.py` (reference parity:
`hex/anovaglm/ANOVAGLM.java`: expand predictors, and interactions up to
`highest_interaction_term`, into effect terms, fit the full GLM, then
refit with each term dropped; the deviance increase gives a
likelihood-ratio chi-square test per term, the `result()` table).

The term blocks (`_build_design`: numbers as they are, categoricals
one-hot dropping the first level, interactions as products of the member
blocks), the f64 deviances and the chi-square tail are the reference's
host code, copied verbatim. The full fit and every refit go through the
port's `H2OGeneralizedLinearEstimator(family, lambda_=0.0,
standardize=False)` on the model's device, as the reference refits
through its GLM. Each deviance is computed in f64 from the GLM's f32
scores, so the statistic of a term with no effect, a difference of two
large deviances, is as small as their f32 rounding and the max(·, 0)
clamp may hide its sign. `link`, `lambda_`, `alpha`, `standardize`,
`type`, `early_stopping` and `save_transformed_framekeys` are accepted by
the reference and never read (every refit uses λ 0 and no
standardization): only their defaults are ported (ROADMAP §C). The
reference exports no MOJO of this model, nor does the port.
"""

from __future__ import annotations

import itertools
import time
from typing import List, Optional

import numpy as np

from .. import device as devlib
from ..frame.frame import Frame
from .glm import H2OGeneralizedLinearEstimator
from .metrics import ModelMetricsBase
from .model_base import H2OEstimator, H2OModel, check_unread, response_info

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(link="family_default", lambda_=None, alpha=None,
               standardize=True, type=3, early_stopping=False,
               save_transformed_framekeys=False)

def _chi2_sf(x, df):
    """The chi-square tail: scipy's where it is installed, else the
    reference's Wilson–Hilferty approximation. scipy is imported here, at
    the first ANOVA table, because `scipy.stats` takes seconds to import
    and every import of the port's estimators would pay it."""
    try:
        from scipy.stats import chi2
    except ImportError:  # scipy not guaranteed
        if df <= 0:
            return float("nan")
        z = ((x / df) ** (1 / 3) - (1 - 2 / (9 * df))) / np.sqrt(2 / (9 * df))
        return float(0.5 * np.erfc(z / np.sqrt(2))) if hasattr(np, "erfc") else float(
            0.5 * (1 - np.tanh(0.7978845608 * (z + 0.044715 * z**3)))
        )
    return float(chi2.sf(x, df))


def _deviance(family: str, y: np.ndarray, mu: np.ndarray, w: np.ndarray) -> float:
    mu = np.clip(mu, 1e-15, None)
    if family == "binomial":
        mu = np.clip(mu, 1e-15, 1 - 1e-15)
        return float(-2 * np.sum(w * (y * np.log(mu) + (1 - y) * np.log(1 - mu))))
    if family == "poisson":
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(y > 0, y * np.log(y / mu), 0.0)
        return float(2 * np.sum(w * (t - (y - mu))))
    return float(np.sum(w * (y - mu) ** 2))


class ANOVAGLMModel(H2OModel):
    algo = "anovaglm"

    def __init__(self, params, x, y, table, full_glm, terms, builder):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self._table = table
        self._full = full_glm
        self._terms = terms
        self._builder = builder

    def result(self) -> Frame:
        """The ANOVA table — model_names / degrees of freedom / SS-deviance /
        p-values (ANOVAGLMModel.result())."""
        return Frame.from_dict({
            "model": np.asarray([r["term"] for r in self._table], dtype=object),
            "df": np.asarray([r["df"] for r in self._table], np.float64),
            "deviance": np.asarray([r["deviance"] for r in self._table], np.float64),
            "p_value": np.asarray([r["p_value"] for r in self._table], np.float64),
        })

    def _as_design(self, frame: Frame) -> Frame:
        blocks = self._builder(frame, self._terms)
        X = np.concatenate([blocks[t] for t in self._terms], axis=1)
        return Frame.from_numpy(X.astype(np.float64),
                                names=[f"c{i}" for i in range(X.shape[1])])

    def predict(self, test_data: Frame) -> Frame:
        return self._full.predict(self._as_design(test_data))

    def _make_metrics(self, frame: Frame):
        fr = self._as_design(frame)
        fr[self.y] = np.asarray(frame.vec(self.y).data)
        if frame.vec(self.y).type == "enum":
            fr = fr.asfactor(self.y)
        return self._full.model._make_metrics(fr)


class H2OANOVAGLMEstimator(H2OEstimator):
    algo = "anovaglm"
    _param_defaults = dict(
        family="AUTO",
        link="family_default",
        lambda_=None,
        alpha=None,
        standardize=True,
        highest_interaction_term=2,
        type=3,
        early_stopping=False,
        save_transformed_framekeys=False,
    )

    def _terms(self, x: List[str]) -> List[tuple]:
        hi = int(self._parms.get("highest_interaction_term") or 2)
        hi = max(1, min(hi, len(x)))
        terms = []
        for k in range(1, hi + 1):
            terms += [t for t in itertools.combinations(x, k)]
        return terms

    def _build_design(self, train: Frame, terms) -> tuple:
        """Column blocks per term: numeric cols as-is, categoricals one-hot
        (drop-first), interactions as elementwise products of member blocks."""
        blocks = {}
        for t in terms:
            mats = []
            for c in t:
                v = train.vec(c)
                if v.type == "enum":
                    codes = np.asarray(v.data)
                    K = v.nlevels
                    oh = np.zeros((len(codes), max(K - 1, 1)))
                    for lvl in range(1, K):
                        oh[:, lvl - 1] = (codes == lvl).astype(np.float64)
                    mats.append(oh)
                else:
                    col = v.numeric_np()
                    mats.append(np.nan_to_num(col)[:, None])
            # interaction block = all pairwise products across member blocks
            out = mats[0]
            for m in mats[1:]:
                out = (out[:, :, None] * m[:, None, :]).reshape(len(m), -1)
            blocks[t] = out
        return blocks

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> ANOVAGLMModel:
        p = self._parms
        check_unread("ANOVAGLM", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        yvec = train.vec(y)
        problem, nclass, domain = response_info(yvec)
        family = p.get("family", "AUTO")
        if family == "AUTO":
            family = "binomial" if problem == "binomial" else "gaussian"
        if family == "binomial":
            yarr = (np.asarray(yvec.data, np.float64) if yvec.type == "enum"
                    else yvec.numeric_np())
        else:
            yarr = yvec.numeric_np()
        w = np.ones(train.nrow)

        terms = self._terms(list(x))
        blocks = self._build_design(train, terms)
        walls = []   # (fit, host-clock seconds) of every GLM fit

        def _glm():
            return H2OGeneralizedLinearEstimator(
                family=family, lambda_=0.0, standardize=False, device=dev)

        def fit_dev(active_terms) -> float:
            cols = [blocks[t] for t in active_terms]
            if not cols:
                X = np.zeros((train.nrow, 0))
            else:
                X = np.concatenate(cols, axis=1)
            names = [f"c{i}" for i in range(X.shape[1])]
            fr = Frame.from_numpy(X.astype(np.float64), names=names) if X.shape[1] else None
            if fr is None:
                mu = np.full(train.nrow, yarr.mean())
                return _deviance(family, yarr, mu, w)
            fr[y] = (np.asarray(yvec.data) if yvec.type == "enum" else yarr)
            if yvec.type == "enum":
                fr = fr.asfactor(y)
            g = _glm()
            g.train(x=names, y=y, training_frame=fr)
            mu = g.model._score(fr)
            return _deviance(family, yarr, mu, w)

        ts = time.perf_counter()
        dev_full = fit_dev(terms)
        walls.append(("full", time.perf_counter() - ts))
        table = []
        for term in terms:
            ts = time.perf_counter()
            others = [u for u in terms if u != term]
            dev_wo = fit_dev(others)
            df = blocks[term].shape[1]
            lr = max(dev_wo - dev_full, 0.0)
            table.append(dict(
                term=":".join(term), df=df, deviance=lr, p_value=_chi2_sf(lr, df)
            ))
            walls.append(("-" + ":".join(term), time.perf_counter() - ts))

        ts = time.perf_counter()
        full_glm = _glm()
        Xf = np.concatenate([blocks[t] for t in terms], axis=1)
        names = [f"c{i}" for i in range(Xf.shape[1])]
        fr = Frame.from_numpy(Xf.astype(np.float64), names=names)
        fr[y] = np.asarray(yvec.data) if yvec.type == "enum" else yarr
        if yvec.type == "enum":
            fr = fr.asfactor(y)
        full_glm.train(x=names, y=y, training_frame=fr)
        walls.append(("model", time.perf_counter() - ts))

        model = ANOVAGLMModel(self, x, y, table, full_glm, terms, self._build_design)
        model.training_metrics = ModelMetricsBase(nobs=train.nrow)
        model.fit_walls = walls
        return model


ANOVAGLM = H2OANOVAGLMEstimator
