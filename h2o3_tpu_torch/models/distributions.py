"""Distribution families — gradients, hessians and links for boosting.

Port of `h2o3_tpu/models/distributions.py` (`hex/Distribution.java`
subclasses: gaussian, bernoulli, multinomial, poisson, gamma, tweedie,
laplace, quantile, huber). Every family exposes (g, h) on the margin scale
and trees take one Newton step -G/(H+λ) per leaf. `init_margin` runs on
the host in numpy, as the reference's does; `grad_hess`,
`multinomial_grad_hess` and `link_inv` take tensors on any device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

FAMILIES = (
    "gaussian", "bernoulli", "multinomial", "poisson", "gamma",
    "tweedie", "laplace", "quantile", "huber",
)


def infer_distribution(problem: str, requested: str = "AUTO") -> str:
    if requested and requested != "AUTO":
        return requested
    return {"binomial": "bernoulli", "multinomial": "multinomial"}.get(problem, "gaussian")


def init_margin(dist: str, y: np.ndarray, w: np.ndarray, **kw) -> float:
    """Initial constant margin f0 (Distribution.init / GBM initial value).
    quantile and laplace start at the response's order statistic
    (unweighted, as the reference); the log-link families at the log of the
    weighted mean."""
    if dist == "quantile":
        return float(np.quantile(y, kw.get("alpha", 0.5)))
    if dist == "laplace":
        return float(np.median(y))
    mu = float(np.average(y, weights=w))
    if dist == "bernoulli":
        mu = min(max(mu, 1e-10), 1 - 1e-10)
        return float(np.log(mu / (1 - mu)))
    if dist in ("poisson", "gamma", "tweedie"):
        return float(np.log(max(mu, 1e-10)))
    return mu


def grad_hess(dist: str, margin: torch.Tensor, y: torch.Tensor,
              **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g, h) of the deviance with respect to the margin (Newton form), the
    pseudo-residual pass of `GBMDriver.buildNextKTrees`. `tweedie_power`,
    `alpha` (quantile) and `huber_delta` default as in the reference."""
    if dist == "gaussian":
        return margin - y, torch.ones_like(y)
    if dist == "bernoulli":
        p = torch.sigmoid(margin)
        return p - y, p * (1 - p)
    if dist == "poisson":
        mu = torch.exp(margin)
        return mu - y, mu
    if dist == "gamma":
        ey = y * torch.exp(-margin)
        return 1.0 - ey, ey
    if dist == "tweedie":
        p = kw.get("tweedie_power", 1.5)
        a = y * torch.exp((1 - p) * margin)
        b = torch.exp((2 - p) * margin)
        return b - a, (2 - p) * b - (1 - p) * a
    if dist == "laplace":
        return torch.sign(margin - y), torch.ones_like(y)
    if dist == "quantile":
        alpha = kw.get("alpha", 0.5)
        return (torch.where(y > margin, torch.full_like(y, -alpha),
                            torch.full_like(y, 1 - alpha)),
                torch.ones_like(y))
    if dist == "huber":
        delta = kw.get("huber_delta", 1.0)
        return torch.clamp(margin - y, -delta, delta), torch.ones_like(y)
    raise ValueError(f"unknown distribution {dist!r}")


def softmax(margins: torch.Tensor) -> torch.Tensor:
    """Row softmax of (N, K) margins, written out as `jax.nn.softmax`
    computes it: exp of the margins less the row max, over their sum."""
    e = torch.exp(margins - margins.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def multinomial_grad_hess(margins: torch.Tensor, y_onehot: torch.Tensor):
    """Per-class (g, h): softmax cross-entropy. margins (N, K)."""
    p = softmax(margins)
    return p - y_onehot, p * (1 - p)


def link_inv(dist: str, margin):
    if dist == "bernoulli":
        return torch.sigmoid(margin)
    if dist in ("poisson", "gamma", "tweedie"):
        return torch.exp(margin)
    return margin


def deviance_name(dist: str) -> str:
    return {"bernoulli": "logloss", "multinomial": "logloss"}.get(dist, "deviance")
