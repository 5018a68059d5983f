"""H2ORuleFitEstimator — interpretable rules + linear terms (RuleFit).

Port of `h2o3_tpu/models/rulefit.py` (reference parity:
`hex/rulefit/RuleFit.java` + `hex/rulefit/RuleExtractor.java`: tree
ensembles at depths `min_rule_length`..`max_rule_length` (`algorithm` ∈
{AUTO, DRF, GBM}), every leaf's root→leaf conjunction a binary rule,
winsorized linear terms by `model_type`, then a sparse lasso GLM over
rules + linear terms; the surviving rules in `rule_importance()`).

The trees are the port's DRF (or GBM under `algorithm="GBM"`), fit on
RuleFit's own device: on the card every histogram pass is B1
(`hist_method="auto"`). `Rule`, `describe` and `_extract_rules` are the
reference's, read from the port's stacked forest (`feat`, `thr`,
`is_split` in heap order), so a forest carried across gives the same rules
in the same order. The dedupe by key, the drop of rules whose support is 0
or 1, the host `np.quantile` winsorizing of the linear terms, the lasso
GLM (`alpha=1`, `lambda_search`, unstandardized) and the `max_num_rules`
walk along its λ path are the reference's, step for step.

Rule evaluation runs on the device (`evaluate_rules`): every condition of
every rule as an elementwise compare of the f64 column with the f64 value
of the f32 threshold (NaN goes right: `col > thr` or NaN is right, `col <=
thr` and not NaN is left), ANDed per rule; the 0/1 columns and the
supports (count / n in f64) equal the host's bit for bit. The feature
frame then goes through the GLM's host pack (ROADMAP A5f).

`distribution`, `remove_duplicates` (the dedupe always runs) and
`lambda_` are accepted by the reference and never read: only their
defaults are ported (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .drf import H2ORandomForestEstimator
from .gbm import H2OGradientBoostingEstimator
from .glm import H2OGeneralizedLinearEstimator
from .model_base import (H2OEstimator, H2OModel, _sync, check_unread,
                         response_info, warn_host_solver)

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(distribution="AUTO", remove_duplicates=True, lambda_=None)
# rules a chunk of `evaluate_rules` holds ((rows, rules, conditions) bools)
RULE_CHUNK_ELEMS = 1 << 27


class Rule:
    """Conjunction of (feature_name, thr, is_right) conditions."""

    __slots__ = ("conds", "support", "coef")

    def __init__(self, conds: Tuple):
        self.conds = conds
        self.support = 0.0
        self.coef = 0.0

    def key(self):
        return self.conds

    def describe(self) -> str:
        parts = []
        for fname, thr, right in self.conds:
            parts.append(f"({fname} > {thr:.6g} or NA)" if right
                         else f"({fname} <= {thr:.6g})")
        return " & ".join(parts)

    def evaluate(self, X: np.ndarray, col_of: dict) -> np.ndarray:
        """The host evaluation of the reference (the oracle of
        `evaluate_rules`)."""
        m = np.ones(X.shape[0], bool)
        for fname, thr, right in self.conds:
            col = X[:, col_of[fname]]
            if right:
                m &= np.isnan(col) | (col > thr)
            else:
                m &= ~np.isnan(col) & (col <= thr)
        return m.astype(np.float64)


def _extract_rules(model, x: List[str], max_len: int) -> List[Rule]:
    """Walk each stacked heap tree; every effective leaf (non-split node
    whose ancestors all split) yields one rule — RuleExtractor
    semantics."""
    rules = []
    for stacked in model.forest:
        nt = stacked.feat.shape[0]
        feat = stacked.feat.cpu().numpy()
        thr = stacked.thr.cpu().numpy()
        issp = stacked.is_split.cpu().numpy()
        T = feat.shape[1]
        for t in range(nt):
            stack = [(0, ())]
            while stack:
                node, conds = stack.pop()
                if node < T and issp[t, node] and len(conds) < max_len:
                    fname = x[int(feat[t, node])]
                    tv = float(thr[t, node])
                    stack.append((2 * node + 1, conds + ((fname, tv, False),)))
                    stack.append((2 * node + 2, conds + ((fname, tv, True),)))
                elif conds:
                    rules.append(Rule(conds))
    return rules


def evaluate_rules(Xd: torch.Tensor, rules: List[Rule], col_of: dict,
                   chunk_elems: int = RULE_CHUNK_ELEMS) -> torch.Tensor:
    """(n, R) bool: every rule on the f64 rows `Xd` (n, p) on their
    device, rules padded to the longest with always-true conditions."""
    n = Xd.shape[0]
    R = len(rules)
    dev = Xd.device
    out = torch.empty((n, R), dtype=torch.bool, device=dev)
    if R == 0:
        return out
    L = max(len(r.conds) for r in rules)
    cols = np.zeros((R, L), np.int64)
    thr = np.full((R, L), np.nan)
    kind = np.full((R, L), 2, np.int64)        # 0 left, 1 right, 2 pad
    for i, r in enumerate(rules):
        for j, (fname, tv, right) in enumerate(r.conds):
            cols[i, j], thr[i, j], kind[i, j] = col_of[fname], tv, int(right)
    cols_d = torch.from_numpy(cols).to(dev)
    thr_d = torch.from_numpy(thr).to(dev)
    kind_d = torch.from_numpy(kind).to(dev)
    step = max(1, chunk_elems // max(n * L, 1))
    for lo in range(0, R, step):
        c, t, k = cols_d[lo:lo + step], thr_d[lo:lo + step], kind_d[lo:lo + step]
        v = Xd[:, c]                                 # (n, r, L)
        nan = torch.isnan(v)
        right = nan | (v > t)
        left = ~nan & (v <= t)
        ok = torch.where(k == 1, right, torch.where(k == 0, left,
                                                    torch.ones_like(left)))
        out[:, lo:lo + step] = ok.all(dim=2)
    return out


def _device_rows(frame: Frame, x: List[str], dev) -> torch.Tensor:
    cols = [frame.vec(n).numeric_np() for n in x]
    X = np.column_stack(cols) if cols else np.zeros((frame.nrow, 0))
    return torch.from_numpy(np.ascontiguousarray(X, np.float64)).to(dev)


class RuleFitModel(H2OModel):
    algo = "rulefit"

    def __init__(self, params, x, y, rules, lin_cols, lin_stats, glm, domain,
                 problem, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self.rules = rules           # kept rules (nonzero coef)
        self.lin_cols = lin_cols     # linear-term column names
        self.lin_stats = lin_stats   # col -> (q025, q975, std)
        self._glm = glm              # fitted sparse GLM over [rules | linear]
        self.domain = domain
        self.problem = problem
        self._col_of = {n: i for i, n in enumerate(self.x)}
        self.device = devlib.resolve(device)

    def _features(self, frame: Frame) -> Frame:
        d = {}
        if self.rules:
            M = evaluate_rules(_device_rows(frame, self.x, self.device),
                               self.rules, self._col_of)
            M = M.cpu().numpy()
            for i in range(len(self.rules)):
                d[f"rule_{i}"] = M[:, i].astype(np.float64)
        for c in self.lin_cols:
            lo, hi, sd = self.lin_stats[c]
            col = np.clip(np.nan_to_num(frame.vec(c).numeric_np()), lo, hi)
            d[f"linear.{c}"] = 0.4 * col / max(sd, 1e-12)
        return Frame.from_dict(d)

    def rule_importance(self) -> Frame:
        imp = [(f"rule_{i}", r.coef, r.describe(), r.support)
               for i, r in enumerate(self.rules) if abs(r.coef) > 1e-10]
        coefs = self._glm.coef()
        for c in self.lin_cols:
            v = coefs.get(f"linear.{c}", 0.0)
            if v:
                imp.append((f"linear.{c}", v, f"linear({c})", float("nan")))
        imp.sort(key=lambda t: -abs(t[1]))
        return Frame.from_dict({
            "variable": np.asarray([i[0] for i in imp], dtype=object),
            "coefficient": np.asarray([i[1] for i in imp], np.float64),
            "rule": np.asarray([i[2] for i in imp], dtype=object),
            "support": np.asarray([i[3] for i in imp], np.float64),
        })

    def predict(self, test_data: Frame) -> Frame:
        return self._glm.predict(self._features(test_data))

    def _make_metrics(self, frame: Frame):
        fr = self._features(frame)
        yv = frame.vec(self.y)
        fr[self.y] = np.asarray(yv.data) if yv.type == "enum" else yv.numeric_np()
        if yv.type == "enum":
            fr = fr.asfactor(self.y)
        return self._glm.model._make_metrics(fr)


class H2ORuleFitEstimator(H2OEstimator):
    algo = "rulefit"
    _param_defaults = dict(
        algorithm="AUTO",          # AUTO→DRF
        min_rule_length=3,
        max_rule_length=3,
        max_num_rules=-1,
        model_type="rules_and_linear",
        rule_generation_ntrees=50,
        distribution="AUTO",
        remove_duplicates=True,
        lambda_=None,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> RuleFitModel:
        warn_host_solver('rulefit', train.nrow, 500000)
        p = self._parms
        yvec = train.vec(y)
        problem, nclass, domain = response_info(yvec)
        if problem == "multinomial":
            raise ValueError("rulefit supports binomial/regression responses")
        check_unread("RuleFit", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        t_start = time.perf_counter()
        model_type = str(p.get("model_type", "rules_and_linear"))
        want_rules = "rules" in model_type
        want_linear = "linear" in model_type

        lo_d = int(p.get("min_rule_length", 3))
        hi_d = int(p.get("max_rule_length", 3))
        depths = list(range(min(lo_d, hi_d), max(lo_d, hi_d) + 1))
        ntrees_total = int(p.get("rule_generation_ntrees", 50))
        per_depth = max(1, ntrees_total // max(len(depths), 1))
        algo = str(p.get("algorithm", "AUTO")).upper()
        TreeEst = H2OGradientBoostingEstimator if algo == "GBM" else H2ORandomForestEstimator
        seed = int(self._parms.get("_actual_seed", 1234))

        rules: List[Rule] = []
        tree_models = []
        if want_rules:
            for d in depths:
                est = TreeEst(ntrees=per_depth, max_depth=d, seed=seed + d,
                              device=str(dev))
                est.train(x=x, y=y, training_frame=train)
                tree_models.append(est.model)
                rules += _extract_rules(est.model, x, d)
        _sync(dev)
        t_trees = time.perf_counter()

        col_of = {n: i for i, n in enumerate(x)}
        # dedupe by key, then drop degenerate (all-0/all-1) rules
        seen = {}
        uniq: List[Rule] = []
        for r in rules:
            k = r.key()
            if k in seen:
                continue
            seen[k] = True
            uniq.append(r)
        n = train.nrow
        kept: List[Rule] = []
        feats = {}
        if uniq:
            M = evaluate_rules(_device_rows(train, x, dev), uniq, col_of)
            counts = M.sum(dim=0).cpu().numpy()
            keep = np.flatnonzero((counts > 0) & (counts < n))
            Mk = M[:, torch.from_numpy(keep).to(dev)].cpu().numpy()
            del M
            for j, i in enumerate(keep):
                r = uniq[i]
                r.support = float(np.float64(counts[i]) / np.float64(n))
                feats[f"rule_{len(kept)}"] = Mk[:, j].astype(np.float64)
                kept.append(r)
            del Mk
        _sync(dev)
        t_eval = time.perf_counter()

        lin_cols, lin_stats = [], {}
        if want_linear:
            for c in x:
                v = train.vec(c)
                if v.type == "enum":
                    continue
                col = v.numeric_np()
                ok = col[~np.isnan(col)]
                if ok.size == 0 or ok.min() == ok.max():
                    continue
                lo, hi = np.quantile(ok, [0.025, 0.975])
                sd = float(np.std(np.clip(ok, lo, hi)))
                lin_cols.append(c)
                lin_stats[c] = (float(lo), float(hi), sd)
                feats[f"linear.{c}"] = 0.4 * np.clip(np.nan_to_num(col), lo, hi) / max(sd, 1e-12)

        if not feats:
            raise ValueError("rulefit: no usable rule/linear features")
        fr = Frame.from_dict(feats)
        fr[y] = np.asarray(yvec.data) if yvec.type == "enum" else yvec.numeric_np()
        if yvec.type == "enum":
            fr = fr.asfactor(y)
        t_frame = time.perf_counter()

        family = "binomial" if problem == "binomial" else "gaussian"
        glm = H2OGeneralizedLinearEstimator(
            family=family, alpha=1.0, lambda_search=True, standardize=False,
            device=str(dev),
        )
        glm.train(x=list(feats.keys()), y=y, training_frame=fr)
        t_glm = time.perf_counter()

        # honour max_num_rules by walking the lambda path to the smallest
        # lambda whose active rule set fits (RuleFit's rule-count control);
        # linear terms do not count against the rule budget
        max_rules = int(p.get("max_num_rules", -1))
        gm = glm.model
        feat_names = list(feats.keys())
        is_rule = np.asarray([nm.startswith("rule_") for nm in feat_names])
        chosen_index = None
        if max_rules > 0 and gm.full_path is not None:
            chosen = None
            for i, (lam, beta) in enumerate(gm.full_path):
                nnz_rules = int((np.abs(beta[:-1])[is_rule] > 1e-10).sum())
                if nnz_rules <= max_rules:
                    chosen, chosen_index = (lam, beta), i
            if chosen is not None:
                gm.beta = chosen[1]
                gm.lambda_best = chosen[0]
                # metrics must describe the beta predict() will use
                gm.training_metrics = gm._make_metrics(fr)

        coefs = gm.coef()
        for i, r in enumerate(kept):
            r.coef = float(coefs.get(f"rule_{i}", 0.0))
        survivors = [r for r in kept if abs(r.coef) > 1e-10]
        model = RuleFitModel(self, x, y, kept, lin_cols, lin_stats, glm,
                             domain, problem, device=dev)
        # importance shows the survivors; evaluation keeps every kept rule
        model._survivors = survivors
        model._tree_models = tree_models
        model.training_metrics = gm.training_metrics
        if valid is not None:
            model.validation_metrics = model._make_metrics(valid)
        t_end = time.perf_counter()
        # host-clock split (the device is synchronised at each mark): the
        # tree fits, the dedupe and rule evaluation, the feature frame, the
        # lasso GLM path, the max_num_rules walk and metrics
        model.fit_timings = dict(trees_s=t_trees - t_start,
                                 rules_s=t_eval - t_trees,
                                 frame_s=t_frame - t_eval,
                                 glm_s=t_glm - t_frame,
                                 select_s=t_end - t_glm,
                                 total_s=t_end - t_start)
        model.rule_counts = dict(extracted=len(rules), unique=len(uniq),
                                 kept=len(kept), active=len(survivors),
                                 chosen_index=chosen_index)
        return model

    def _cv_predict(self, model: RuleFitModel, frame: Frame) -> np.ndarray:
        return model._glm._cv_predict(model._glm.model, model._features(frame))


RuleFit = H2ORuleFitEstimator
