"""H2ONaiveBayesEstimator — Naive Bayes classifier, single device.

Port of `h2o3_tpu/models/naive_bayes.py` (reference parity:
`hex/naivebayes/NaiveBayes.java`: per-class priors; numeric features →
per-(class, feature) Gaussian moments; categorical features →
per-(class, feature, level) counts with Laplace smoothing and the
`min_sdev`/`min_prob` floors).

The priors (a `bincount`) and the categorical tables (`np.add.at`, Laplace,
the `min_prob`·1e-3 floor) stay host numpy, copied verbatim: they are the
reference's bit for bit. The numeric moments {Σw, Σx·w, Σx²·w} per class
run on the card in f32, as the reference's `segment_sum` sums them: all
numeric columns at once as ONE product of the class one-hot (n, K)ᵀ with
the (n, 3F) stack, in true f32 (TF32 stays off). A matrix product sums in
a fixed order, so two fits on the card are equal bit for bit, where
`index_add_`'s f32 atomics would add in arrival order. The order differs
from XLA's, so the moments agree with the reference's to f32 rounding.
The f64 `mean`, `var` and `sd` with the `min_sdev` floor follow on the
host as the reference has them: a one-pass Σx²/n − mean² (ROADMAP §C).

Scoring (`_log_probs`) runs on the model's device in f64: the Gaussian
log-densities of the numeric columns, the tables' log-probabilities
gathered by code (a level unseen in training, or NA, adds nothing), and
the softmax. `eps_sdev`, `eps_prob`, `compute_metrics`, `balance_classes`,
`class_sampling_factors` and `max_after_balance_size` are accepted by the
reference and never read: only their defaults are ported (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .metrics import ModelMetricsBinomial, ModelMetricsMultinomial
from .model_base import (H2OEstimator, H2OModel, _sync, check_unread,
                         response_info, warn_host_solver)

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(eps_sdev=0.0, eps_prob=0.0, compute_metrics=True,
               balance_classes=False, class_sampling_factors=None,
               max_after_balance_size=5.0)


def class_moments(codes: torch.Tensor, cols: torch.Tensor,
                  K: int) -> torch.Tensor:
    """Per class {Σw, Σx·w, Σx²·w} of every column of `cols` (n, F) f32,
    NaN rows weighing 0, as one f32 product of the (n, K) class one-hot
    with the (n, 3F) stack: returns (K, 3, F) f32, in a fixed summation
    order on the device."""
    ok = ~torch.isnan(cols)
    w = ok.to(torch.float32)
    c = torch.where(ok, cols, torch.zeros_like(cols))
    stack = torch.cat([w, c * w, c * c * w], dim=1)           # (n, 3F)
    onehot = (codes[:, None] == torch.arange(
        K, device=codes.device)[None, :]).to(torch.float32)   # (n, K)
    return (onehot.t() @ stack).reshape(K, 3, cols.shape[1])


class NaiveBayesModel(H2OModel):
    algo = "naivebayes"

    def __init__(self, params, x, y, domain, priors, num_stats, cat_tables,
                 spec, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self.domain = domain
        self.priors = priors          # (K,) f64
        self.num_stats = num_stats    # dict col -> (K, 2) mean/sd, f64
        self.cat_tables = cat_tables  # dict col -> ((K, L) probs, domain)
        self.spec = spec              # list of (name, kind)
        self.device = devlib.resolve(device)

    def _log_probs(self, frame: Frame) -> torch.Tensor:
        """(n, K) f64 log-posterior numerators on the model's device."""
        dev = self.device
        n = frame.nrow
        logp = torch.log(torch.from_numpy(
            np.asarray(self.priors, np.float64)).to(dev))[None, :].repeat(n, 1)
        for name, kind in self.spec:
            v = frame.vec(name)
            if kind == "num":
                col = torch.from_numpy(np.ascontiguousarray(
                    v.numeric_np(), np.float64)).to(dev)
                st = torch.from_numpy(self.num_stats[name]).to(dev)
                mean, sd = st[:, 0], st[:, 1]
                valid = ~torch.isnan(col)
                xv = torch.where(valid, col, torch.zeros_like(col))
                ll = (-0.5 * torch.log(2 * np.pi * sd[None, :] ** 2)
                      - 0.5 * ((xv[:, None] - mean[None, :])
                               / sd[None, :]) ** 2)
                logp += torch.where(valid[:, None], ll, torch.zeros_like(ll))
            else:
                probs, dom = self.cat_tables[name]
                codes = np.asarray(v.data)
                if v.domain != dom and v.domain:
                    remap = np.asarray(
                        [dom.index(d) if d in dom else -1 for d in v.domain],
                        np.int64)
                    codes = np.where(codes >= 0, remap[np.maximum(codes, 0)],
                                     -1)
                cd = torch.from_numpy(np.asarray(codes, np.int64)).to(dev)
                valid = cd >= 0
                lt = torch.log(torch.from_numpy(
                    np.asarray(probs, np.float64)).to(dev))       # (K, L)
                ll = lt[:, torch.clamp(cd, min=0)].t()           # (n, K)
                logp += torch.where(valid[:, None], ll, torch.zeros_like(ll))
        return logp

    def _probs(self, frame: Frame) -> np.ndarray:
        logp = self._log_probs(frame)
        m = logp - logp.max(dim=1, keepdim=True).values
        e = torch.exp(m)
        return (e / e.sum(dim=1, keepdim=True)).cpu().numpy()

    def predict(self, test_data: Frame) -> Frame:
        probs = self._probs(test_data)
        lab = probs.argmax(axis=1)
        d = {"predict": np.asarray(self.domain, dtype=object)[lab]}
        for i, cls in enumerate(self.domain):
            d[str(cls)] = probs[:, i]
        return Frame.from_dict(d, column_types={"predict": "enum"})

    def _make_metrics(self, frame: Frame):
        probs = self._probs(frame)
        yv = frame.vec(self.y)
        if len(self.domain) == 2:
            return ModelMetricsBinomial.make(np.asarray(yv.data), probs[:, 1])
        return ModelMetricsMultinomial.make(np.asarray(yv.data), probs)


class H2ONaiveBayesEstimator(H2OEstimator):
    algo = "naivebayes"
    _param_defaults = dict(
        laplace=0.0,
        min_sdev=0.001,
        eps_sdev=0.0,
        min_prob=0.001,
        eps_prob=0.0,
        compute_metrics=True,
        balance_classes=False,
        class_sampling_factors=None,
        max_after_balance_size=5.0,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> NaiveBayesModel:
        warn_host_solver('naivebayes', train.nrow, 2000000)
        p = self._parms
        yvec = train.vec(y)
        problem, K, domain = response_info(yvec)
        if problem == "regression":
            raise ValueError("naivebayes requires a categorical response")
        check_unread("NaiveBayes", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        ycodes = np.asarray(yvec.data, np.int64)
        laplace = float(p.get("laplace", 0.0))
        min_sdev = max(float(p.get("min_sdev", 0.001)), 1e-10)

        counts = np.bincount(ycodes, minlength=K).astype(np.float64)
        priors = counts / counts.sum()

        cat_tables = {}
        num_names = []
        spec = []
        for name in x:
            v = train.vec(name)
            if v.type == "enum":
                L = max(v.nlevels, 1)
                codes = np.asarray(v.data)
                ok = codes >= 0
                tab = np.zeros((K, L))
                np.add.at(tab, (ycodes[ok], codes[ok]), 1.0)
                tab = (tab + laplace) / (
                    tab.sum(axis=1, keepdims=True) + laplace * L + 1e-300
                )
                tab = np.maximum(tab, float(p.get("min_prob", 0.001)) * 1e-3)
                cat_tables[name] = (tab, v.domain)
                spec.append((name, "cat"))
            else:
                num_names.append(name)
                spec.append((name, "num"))
        t_tab = time.perf_counter()

        num_stats = {}
        if num_names:
            # per class {Σw, Σx, Σx²} of every numeric column — one f32
            # product on the device (the reference's NBTask segment sum)
            cols = torch.from_numpy(np.stack(
                [train.vec(nm).numeric_np() for nm in num_names],
                axis=1).astype(np.float32)).to(dev)
            yd = torch.from_numpy(ycodes).to(dev)
            stats = class_moments(yd, cols, K).cpu().numpy().astype(np.float64)
            del cols, yd
            for j, name in enumerate(num_names):
                st = stats[:, :, j]
                cnt = np.maximum(st[:, 0], 1.0)
                mean = st[:, 1] / cnt
                var = np.maximum(st[:, 2] / cnt - mean**2, 0.0)
                sd = np.maximum(np.sqrt(var * cnt / np.maximum(cnt - 1, 1.0)),
                                min_sdev)
                num_stats[name] = np.column_stack([mean, sd])
        _sync(dev)
        t_mom = time.perf_counter()

        model = NaiveBayesModel(self, x, y, domain, priors, num_stats,
                                cat_tables, spec, device=dev)
        model.training_metrics = model._make_metrics(train)
        if valid is not None:
            model.validation_metrics = model._make_metrics(valid)
        t_end = time.perf_counter()
        # host-clock split: the priors and categorical tables on the host,
        # the numeric moments on the device (upload included), the metrics
        model.fit_timings = dict(tables_s=t_tab - t0, moments_s=t_mom - t_tab,
                                 metrics_s=t_end - t_mom, total_s=t_end - t0)
        return model

    def _cv_predict(self, model: NaiveBayesModel, frame: Frame) -> np.ndarray:
        probs = model._probs(frame)
        return probs[:, 1] if len(model.domain) == 2 else probs


NaiveBayes = H2ONaiveBayesEstimator
