"""H2OSupportVectorMachineEstimator — binary SVM (PSVM).

Port of `h2o3_tpu/models/psvm.py` (reference parity:
`hex/psvm/PSVM.java`; estimator surface `h2o-py/h2o/estimators/psvm.py`:
`kernel_type`, `hyper_param` = C, a ±1 response, `rank_ratio`, predict →
label and `decision_function`).

As in the reference, the gaussian kernel is random Fourier features, not
the Java's incomplete Cholesky factor with an interior-point solve
(ROADMAP §C): z(x) = √(2/D)·cos(xW + b) with W ~ N(0, 2γ) of shape (p, D)
and b ~ U(0, 2π), and the primal squared hinge ½‖β‖² + C·Σ cw·max(0,
1 − y f)² minimised by full-batch Adam at 0.05.

The host half is the reference's: the binary-response check, the ±1
response, the standardized `DataInfo` expansion, γ = 1/p by default, D
from `rank_ratio` (else min(max(8√n, 64), 1024)) and the numpy draws of W
and b from `default_rng(seed)`, cast to f32: bit-equal to the reference's.
The features Z are built once on the model's device in f32 (a true-f32
product; TF32 must stay off) and never copied to f64. Every Adam step runs
there: f = Zβ + bias, the gradient written out (β + Zᵀg, Σg with g =
−2C·cw·y·max(0, 1 − y f)) and optax's `adam` update as optax computes it
(`adam_step`), one host read of the loss a step for the reference's stop
rule. The f64 β, `svs_count` and `decision_function` take the f64 product
of the f32 features with β in row chunks on the device.

`fact_threshold`, `feasible_threshold`, `surrogate_gap_threshold` and
`mu_factor` are accepted by the reference and never read: only their
defaults are ported (ROADMAP §C). PSVM exports no MOJO, as in the
reference.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .metrics import ModelMetricsBinomial
from .model_base import (DataInfo, H2OEstimator, H2OModel, _sync,
                         check_unread, warn_host_solver)

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(fact_threshold=1e-5, feasible_threshold=1e-3,
               surrogate_gap_threshold=1e-3, mu_factor=10.0)
# rows a chunk of the f64 products with β (a (rows, D) f64 copy at most)
F64_CHUNK_ROWS = 8192
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_LR = 0.9, 0.999, 1e-8, 0.05


def fourier_features(X: torch.Tensor, W: Optional[torch.Tensor],
                     b: Optional[torch.Tensor]) -> torch.Tensor:
    """Z = √(2/D)·cos(XW + b) in f32 (X itself without W)."""
    if W is None:
        return X
    D = W.shape[1]
    return float(np.sqrt(2.0 / D)) * torch.cos(X @ W + b)


def decision_f64(Z: torch.Tensor, beta: torch.Tensor, bias: float,
                 rows: int = F64_CHUNK_ROWS) -> torch.Tensor:
    """Z·β + bias in f64 from f32 features, in row chunks."""
    out = torch.empty(Z.shape[0], dtype=torch.float64, device=Z.device)
    for lo in range(0, Z.shape[0], rows):
        out[lo:lo + rows] = Z[lo:lo + rows].to(torch.float64) @ beta
    return out + bias


def loss_and_grad(Z, y, cw, C: float, beta, bias):
    """The reference's loss ½‖β‖² + C·Σ cw·max(0, 1 − y f)² in f32 and its
    gradient in β and the bias."""
    f = Z @ beta + bias
    margin = torch.clamp(1.0 - y * f, min=0.0)
    loss = 0.5 * torch.sum(beta * beta) + C * torch.sum(cw * margin * margin)
    g = -2.0 * C * cw * margin * y
    return loss, beta + Z.t() @ g, g.sum()


def adam_step(params, grads, mu, nu, count: int):
    """One step of optax's `adam(0.05)`: mu = (1−b1)·g + b1·mu, nu =
    (1−b2)·g² + b2·nu, the bias corrections 1 − b^count in f32 with the
    int step count, update = −lr·m̂ / (√v̂ + ε). Returns the new params and
    moments."""
    out_p, out_m, out_v = [], [], []
    c1 = float(np.float32(1) - np.float32(ADAM_B1) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(ADAM_B2) ** np.float32(count))
    for p, g, m, v in zip(params, grads, mu, nu):
        m = (1 - ADAM_B1) * g + ADAM_B1 * m
        v = (1 - ADAM_B2) * (g ** 2) + ADAM_B2 * v
        u = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS)
        out_p.append(p + (-ADAM_LR) * u)
        out_m.append(m)
        out_v.append(v)
    return out_p, out_m, out_v


class PSVMModel(H2OModel):
    algo = "psvm"

    def __init__(self, params, x, y, dinfo, W, b, beta, bias, domain, kernel,
                 svs_count, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self.dinfo = dinfo
        self.W = W          # (p, D) f32 Fourier projection (None: linear)
        self.b = b          # (D,) f32
        self.beta = beta    # (D,) or (p,) f64 weights
        self.bias = bias
        self.domain = domain
        self.kernel = kernel
        self.svs_count = svs_count  # rows inside the margin
        self.device = devlib.resolve(device)

    def _features(self, X: np.ndarray) -> torch.Tensor:
        """f32 features of a host design on the model's device."""
        dev = self.device
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
        if self.kernel == "linear" or self.W is None:
            return Xd
        return fourier_features(Xd, torch.from_numpy(self.W).to(dev),
                                torch.from_numpy(self.b).to(dev))

    def decision_function(self, frame: Frame) -> np.ndarray:
        Z = self._features(self.dinfo.transform(frame))
        beta = torch.from_numpy(np.asarray(self.beta, np.float64)).to(Z.device)
        return decision_f64(Z, beta, float(self.bias)).cpu().numpy()

    def predict(self, test_data: Frame) -> Frame:
        f = self.decision_function(test_data)
        lab = (f > 0).astype(int)
        return Frame.from_dict(
            {"predict": np.asarray(self.domain, dtype=object)[lab],
             "decision_function": f},
            column_types={"predict": "enum"},
        )

    def _make_metrics(self, frame: Frame):
        f = self.decision_function(frame)
        yv = frame.vec(self.y)
        # decision values as ranking scores: AUC is defined without probs
        score = 1.0 / (1.0 + np.exp(-np.clip(f, -30, 30)))
        return ModelMetricsBinomial.make(np.asarray(yv.data), score)


class H2OSupportVectorMachineEstimator(H2OEstimator):
    algo = "psvm"
    _param_defaults = dict(
        hyper_param=1.0,
        kernel_type="gaussian",
        gamma=-1.0,
        rank_ratio=-1.0,
        positive_weight=1.0,
        negative_weight=1.0,
        disable_training_metrics=False,
        sv_threshold=1e-4,
        fact_threshold=1e-5,
        max_iterations=200,
        feasible_threshold=1e-3,
        surrogate_gap_threshold=1e-3,
        mu_factor=10.0,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> PSVMModel:
        warn_host_solver('psvm', train.nrow, 100000)
        p = self._parms
        yvec = train.vec(y)
        if yvec.type != "enum" or yvec.nlevels != 2:
            raise ValueError("psvm requires a binary categorical response")
        check_unread("PSVM", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        t_start = time.perf_counter()
        domain = yvec.domain
        ypm = np.asarray(yvec.data, np.float32) * 2.0 - 1.0  # ±1

        dinfo = DataInfo(train, x, standardize=True)
        X = dinfo.fit_transform(train)
        n, pdim = X.shape
        kernel = str(p.get("kernel_type", "gaussian")).lower()
        gamma = float(p.get("gamma", -1.0))
        if gamma <= 0:
            gamma = 1.0 / max(pdim, 1)
        C = float(p.get("hyper_param", 1.0))
        wpos = float(p.get("positive_weight", 1.0))
        wneg = float(p.get("negative_weight", 1.0))
        seed = int(self._parms.get("_actual_seed", 1234))
        rng = np.random.default_rng(seed)

        W = b = Wd = bd = None
        if kernel != "linear":
            # rank_ratio sets the ICF rank in the reference's Java; here the
            # Fourier feature count (default √n·8 within [64, 1024])
            rr = float(p.get("rank_ratio", -1.0))
            D = int(rr * n) if rr > 0 else int(min(max(8 * np.sqrt(n), 64), 1024))
            W = rng.normal(scale=np.sqrt(2 * gamma), size=(pdim, D)).astype(np.float32)
            b = rng.uniform(0, 2 * np.pi, D).astype(np.float32)
            Wd, bd = torch.from_numpy(W).to(dev), torch.from_numpy(b).to(dev)
        t_draw = time.perf_counter()
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
        Z = fourier_features(Xd, Wd, bd)
        del Xd
        yd = torch.from_numpy(ypm).to(dev)
        cw = torch.from_numpy(np.where(ypm > 0, wpos, wneg).astype(np.float32)).to(dev)
        _sync(dev)
        t_feat = time.perf_counter()

        params = [torch.zeros(Z.shape[1], dtype=torch.float32, device=dev),
                  torch.zeros((), dtype=torch.float32, device=dev)]
        mu = [torch.zeros_like(t) for t in params]
        nu = [torch.zeros_like(t) for t in params]
        prev = np.inf
        steps, stopped = 0, False
        bound = max(int(p.get("max_iterations", 200)), 50) * 5
        losses = []
        for it in range(bound):
            v, gb, gbias = loss_and_grad(Z, yd, cw, C, params[0], params[1])
            params, mu, nu = adam_step(params, [gb, gbias], mu, nu, it + 1)
            v = float(v)
            losses.append(v)
            steps = it + 1
            if abs(prev - v) < 1e-7 * max(abs(v), 1.0):
                stopped = True
                break
            prev = v
        t_adam = time.perf_counter()
        beta = params[0].cpu().numpy().astype(np.float64)
        bias = float(params[1])
        f = decision_f64(Z, torch.from_numpy(beta).to(dev), bias)
        svs = int((yd.to(torch.float64) * f
                   < 1.0 + float(p.get("sv_threshold", 1e-4))).sum())
        del Z, f
        model = PSVMModel(self, x, y, dinfo, W, b, beta, bias, domain, kernel,
                          svs, device=dev)
        _sync(dev)
        t_svs = time.perf_counter()
        if not p.get("disable_training_metrics"):
            model.training_metrics = model._make_metrics(train)
            if valid is not None:
                model.validation_metrics = model._make_metrics(valid)
        t_end = time.perf_counter()
        # host-clock split (the device is synchronised at each mark): the
        # expansion and the host draws, the features' upload and build,
        # the Adam loop (steps and ms a step), β and the support vectors,
        # the metrics
        model.fit_timings = dict(draw_s=t_draw - t_start,
                                 features_s=t_feat - t_draw,
                                 adam_s=t_adam - t_feat,
                                 svs_s=t_svs - t_adam,
                                 metrics_s=t_end - t_svs,
                                 total_s=t_end - t_start)
        # the loss at every step (f32, read by the stop rule)
        model.adam = dict(steps=steps, stopped_on_rule=stopped, bound=bound,
                          ms_a_step=1e3 * (t_adam - t_feat) / max(steps, 1),
                          losses=losses)
        return model

    def _cv_predict(self, model: PSVMModel, frame: Frame) -> np.ndarray:
        f = model.decision_function(frame)
        return 1.0 / (1.0 + np.exp(-np.clip(f, -30, 30)))


PSVM = H2OSupportVectorMachineEstimator
