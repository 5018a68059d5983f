"""H2OGeneralizedLinearEstimator — GLM, on one device or across ranks.

Port of `h2o3_tpu/models/glm.py` (reference parity: `hex/glm/GLM.java`'s
IRLSM, `hex/glm/GLMTask.java`'s Gram task, `hex/DataInfo.java`). The
Airlines-logistic IRLS fit is a BASELINE.json headline.

Shape of IRLSM on the card: the design matrix is built on the device from
compact columns (`DataInfo.device_design`); each iteration's Gram X'WX and
X'Wz are `torch.matmul` in true f32 (the reference's einsums at
`Precision.HIGHEST`; TF32 stays off), and the penalized p×p solve runs on
the device too — LU for ridge, 500 projected-ISTA steps when l1 > 0 or
`non_negative` (`_solve_pen_device`). The reference fuses the IRLS loop
into one `lax.while_loop`; the port runs it as a Python loop over device
tensors whose host reads Δβ once per iteration for the convergence test.
The λ path (`_glm_path_device`, a `lax.scan` in the reference) is a Python
loop over λ the same way. The chosen λ and the `H2O3_EST_LEGACY=1`
comparator solve on the host in f64 (`_solve_penalized`), after a Gram on
the device.

`nfolds` and `fold_column` cross-validate through `model_base._run_cv`,
each fold re-fit on its own rows and scored by `_cv_predict`.

The multinomial family (and AUTO on a response of three or more classes)
fits a (K, p+1) β by L-BFGS on the softmax loss (`_fit_multinomial`), as
the reference runs `optax.lbfgs` (`h2o3_tpu/models/glm.py:1083-1150`):
from zeros, a memory of 10, one step a turn, the reference's stop rule
and step cap; `torch.optim.LBFGS` with its strong-Wolfe line search
takes the steps. The logits and the gradient are true f32 matrix
products on the device; the loss's row terms are summed in f64, so the
stop rule's 1e-9 reads the loss's change and not its f32 rounding (in
f32, two losses of order 1 differ by an ulp, ≈6e-8, or not at all, and
torch's line search then stalls short of the optimum). The reference's Adam fallback,
reached only when `optax.lbfgs` is missing, is not ported. Where the
reference's multinomial fit silently ignores a parameter
(`lambda_search`, the L1 share of α, `non_negative`), the port raises
naming it (ROADMAP §C).

The single-λ IRLS fit runs under the estimator engine's shard plan
(`estimator_engine.shard_plan`): "off" on one rank; "blocks" under
``H2O3_EST_SHARD=1``, S ordered row blocks, each block's Gram and X'Wz
one augmented product (W·w·X)ᵀ[X | z] (`_gram_fn`), the partials folded
in block order; "mesh" on a pod, each rank holding S/N whole blocks of the
canonical row layout (its design, y and w), the partials gathered in rank
order and folded, β₀ from the gathered y and w, so a pod fit equals the
blocks-lane fit that shares S bit for bit on an unstandardized design.
Every rank then solves the same folded Gram: β, Δβ, the iteration count
and the f32-divergence fallback (voted all the same) agree; p-values
invert the folded Gram and fold the Pearson sums. A pod's training and
validation metrics are its rank's own rows.

λ search and the multinomial family run on the same lanes. The λ path
takes every Gram and X'Wz from `_gram_fn` (λ_max from the folded X'Wz at
β = 0), Σw from the global weights, and each λ's deviance as block
partials folded in block order (`_deviance_fn`), against the validation
frame's rows laid out on their own canonical grid when one is given; the
f32-divergence guard is voted, and the f64 re-solve of λ_best reads the
folded Gram. The multinomial loss's f64 row sums and its (K, p) gradient
products are block partials folded in block order, over the true global
row count (`_softmax_fn`), so L-BFGS takes the same steps on every rank.
The reference fits both on row-sharded global arrays; on one rank
without ``H2O3_EST_SHARD`` both keep their full-row reductions.
"""

from __future__ import annotations

import math
import time
from math import erfc, sqrt
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from ..parallel import distdata
from ..parallel import mesh as cloudlib
from . import estimator_engine as _est
from .metrics import (ModelMetricsBinomial, ModelMetricsMultinomial,
                      ModelMetricsRegression)
from .model_base import (SCORE_ROW_BUCKET, DataInfo, H2OEstimator, H2OModel,
                         _sync, check_unread, pod_check_frame, response_info)

# parameters the reference's GLM accepts and never reads
_UNREAD = dict(balance_classes=False, class_sampling_factors=None,
               max_after_balance_size=5.0)

FAMILIES = (
    "AUTO", "gaussian", "binomial", "quasibinomial", "multinomial",
    "poisson", "gamma", "tweedie", "negativebinomial", "ordinal", "fractionalbinomial",
)
_LOGIT = ("binomial", "quasibinomial", "fractionalbinomial")
_MULTINOMIAL = "queue A, item 8: multinomial GLM"
ISTA_STEPS = 500
# the reference's L-BFGS loop (optax.lbfgs at its defaults): stop when two
# successive losses differ by less than LBFGS_TOL, or after
# max(LBFGS_MIN_STEPS, 4·max_iterations) steps; a memory of LBFGS_MEMORY
# pairs; up to LS_EVALS loss evaluations a line search (torch's default)
LBFGS_TOL, LBFGS_MIN_STEPS, LBFGS_MEMORY, LS_EVALS = 1e-9, 100, 10, 25


# -- link functions (hex/glm/GLMModel.GLMParameters.Link) --------------------
def _linkinv(family: str, eta: torch.Tensor) -> torch.Tensor:
    if family in _LOGIT:
        return torch.sigmoid(eta)
    if family in ("poisson", "gamma", "tweedie", "negativebinomial"):
        return torch.exp(eta)
    return eta


def _family_deviance_sum(family: str, y, mu, w, tweedie_p=1.5, xp=torch):
    """Σ w·d(y,μ) with the per-family unit deviance d — the quantity lambda
    search minimizes (hex/glm/GLMModel.GLMParameters.deviance per family;
    squared error only for gaussian). `xp` is torch (device path) or np
    (host f64 path)."""
    if family in _LOGIT:
        mu_c = xp.clip(mu, 1e-15, 1 - 1e-15)
        return -2.0 * xp.sum(w * (y * xp.log(mu_c)
                                  + (1 - y) * xp.log(1 - mu_c)))
    if family == "poisson":
        mu_c = xp.clip(mu, 1e-10, None)
        ylogy = xp.where(y > 0, y * xp.log(xp.clip(y, 1e-10, None) / mu_c), 0.0)
        return 2.0 * xp.sum(w * (ylogy - (y - mu_c)))
    if family == "gamma":
        mu_c = xp.clip(mu, 1e-10, None)
        y_c = xp.clip(y, 1e-10, None)
        return 2.0 * xp.sum(w * (-xp.log(y_c / mu_c) + (y - mu_c) / mu_c))
    if family == "tweedie":
        p = float(tweedie_p)
        if abs(p - 1.0) < 1e-8:     # limit form: poisson deviance
            return _family_deviance_sum("poisson", y, mu, w, xp=xp)
        if abs(p - 2.0) < 1e-8:     # limit form: gamma deviance
            return _family_deviance_sum("gamma", y, mu, w, xp=xp)
        mu_c = xp.clip(mu, 1e-10, None)
        y_c = xp.clip(y, 0.0, None)
        return 2.0 * xp.sum(w * (
            y_c ** (2 - p) / ((1 - p) * (2 - p))
            - y_c * mu_c ** (1 - p) / (1 - p)
            + mu_c ** (2 - p) / (2 - p)))
    return xp.sum(w * (y - mu) ** 2)


def _irls_weights(family: str, eta, mu, y, tweedie_p=1.5):
    """(W, z): working weights and response for one IRLS iteration."""
    if family in _LOGIT:
        W = torch.clip(mu * (1 - mu), 1e-10, None)
        z = eta + (y - mu) / W
    elif family == "poisson":
        W = torch.clip(mu, 1e-10, None)
        z = eta + (y - mu) / W
    elif family == "gamma":
        W = torch.ones_like(mu)
        z = eta + (y - mu) / torch.clip(mu, 1e-10, None)
    elif family == "tweedie":
        W = torch.clip(mu ** (2 - tweedie_p), 1e-10, None)
        z = eta + (y - mu) / torch.clip(mu, 1e-10, None)  # log link
    else:  # gaussian
        W = torch.ones_like(mu)
        z = y
    return W, z


def _wsums(y, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σw, Σw·y) as device scalars."""
    return torch.sum(w), torch.sum(w * y)


def _deviance_device(X, y, w, beta, family: str, tweedie_p: float):
    mu = _linkinv(family, X @ beta)
    return _family_deviance_sum(family, y, mu, w, tweedie_p)


def _pearson_sums(X, y, w, beta, family: str, tweedie_p: float):
    """(Σ w·(y−μ)²/V(μ), Σw) — the Pearson X² pieces of the dispersion
    estimate as device reductions."""
    mu = _linkinv(family, X @ beta)
    if family == "gamma":
        vfun = torch.clamp(mu, min=1e-12) ** 2
    elif family == "tweedie":
        vfun = torch.clamp(mu, min=1e-12) ** tweedie_p
    else:
        vfun = torch.ones_like(mu)
    return torch.sum(w * (y - mu) ** 2 / vfun), torch.sum(w)


def _gram_step(X, y, w, beta, family: str, tweedie_p: float = 1.5):
    """One GLMIterationTask: the Gram X'WX and X'Wz, two f32 matrix
    products. X·(W·w) is an (N, p) temporary that lives only for the
    product."""
    eta = X @ beta
    mu = _linkinv(family, eta)
    W, z = _irls_weights(family, eta, mu, y, tweedie_p)
    Ww = W * w
    Xw = X * Ww[:, None]
    gram = Xw.T @ X
    del Xw
    xy = X.T @ (Ww * z)
    return gram, xy


def _row_blocks(X, y, w, local_blocks: int):
    """(X, y, w) of each of this rank's row blocks, each a tensor of its
    own (`estimator_engine.row_blocks`), or None without blocks."""
    if not local_blocks:
        return None
    return list(zip(*(_est.row_blocks(t, local_blocks) for t in (X, y, w))))


def _gram_fn(X, y, w, family: str, tweedie_p: float, blocks=None,
             axis_name: Optional[str] = None):
    """β → (X'WX, X'Wz) of one fit under its shard plan. Off (`blocks`
    None): `_gram_step` over every row. The blocks and mesh lanes: each of
    this rank's row blocks (`_row_blocks`) gives η, W and z from its own
    rows and its Gram and X'Wz as ONE augmented product (W·w·X)ᵀ[X | z]
    (the reference's form: one product per block gives the same bits in
    both lanes); the block partials fold in block order over the ranks
    (`estimator_engine.fold_blocks`). Pad rows weigh 0."""
    if blocks is None:
        return lambda b: _gram_step(X, y, w, b, family, tweedie_p)

    def gram(b):
        parts = []
        for Xb, yb, wb in blocks:
            eta = Xb @ b
            mu = _linkinv(family, eta)
            W, z = _irls_weights(family, eta, mu, yb, tweedie_p)
            Xw = Xb * (W * wb)[:, None]
            parts.append(Xw.T @ torch.cat([Xb, z[:, None]], dim=1))
        gz = _est.fold_blocks(torch.stack(parts), axis_name)
        return gz[:, :-1], gz[:, -1]

    return gram


def _deviance_fn(X, y, w, family: str, tweedie_p: float, blocks=None,
                 axis_name: Optional[str] = None):
    """β → the deviance Σ w·d(y, μ) of (X, y, w) as a device scalar under
    the fit's shard plan: one full-row sum (off), or each row block's sum a
    partial, folded in block order over the ranks (pad rows weigh 0 and
    add exact zeros)."""
    if blocks is None:
        return lambda b: _deviance_device(X, y, w, b, family, tweedie_p)

    def deviance(b):
        return _est.fold_blocks(torch.stack(
            [_deviance_device(Xb, yb, wb, b, family, tweedie_p)
             for Xb, yb, wb in blocks]), axis_name)

    return deviance


def _eta_by_columns(X: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """X·β with each row's sum taken column by column in a fixed order, as
    two exactly rounded elementwise operations a column: a row's value
    does not depend on how many rows the matrix holds or where the row
    sits, which a gemv does not promise (its kernels group rows and peel
    for alignment). CV holdouts score through it, so a pod rank's holdout
    rows equal the same rows of the one-process fit's."""
    Xt = X.t().contiguous()
    eta = Xt[0] * beta[0]
    for j in range(1, Xt.shape[0]):
        eta = eta + Xt[j] * beta[j]
    return eta


def _f32(v) -> float:
    """A host value rounded to f32, as the reference's device scalars
    hold it."""
    return float(np.float32(v))


def _penalties(lam, alpha, n_obs) -> Tuple[np.float32, np.float32]:
    """(l1, l2) as the f32 products the reference's device scalars give."""
    lam, alpha, n_obs = np.float32(lam), np.float32(alpha), np.float32(n_obs)
    return lam * alpha * n_obs, lam * (np.float32(1.0) - alpha) * n_obs


def _uses_ista(lam, alpha, n_obs, non_negative: bool) -> bool:
    """Whether the penalized solve iterates (l1 > 0 or non_negative)
    rather than solving the ridge system."""
    return bool(_penalties(lam, alpha, n_obs)[0] > 0 or non_negative)


def _solve_pen_device(gram, xy, lam, alpha, n_obs, pen_mask, beta_prev,
                      non_negative: bool) -> torch.Tensor:
    """Penalized IRLS-quadratic solve ON DEVICE — LU for ridge, 500-step
    projected ISTA when l1 > 0 or non_negative (the same quadratic
    COORDINATE_DESCENT iterates on), with no early exit. Shared by the λ
    path and the fused single-λ IRLS loop so the two can never drift.

    An ISTA step is b − (A·b − xy)/L, soft-thresholded as v − clamp(v, −t,
    t) (equal bit for bit to sign(v)·max(|v| − t, 0)), then projected:
    five launches (`addmv` is a copy and a gemv), six with non_negative."""
    pdim = gram.shape[0]
    l1, l2 = _penalties(lam, alpha, n_obs)
    A = gram + torch.diag(pen_mask * float(l2))
    if not _uses_ista(lam, alpha, n_obs, non_negative):
        eye = torch.eye(pdim, dtype=torch.float32, device=gram.device)
        return torch.linalg.solve(A + 1e-6 * eye, xy)
    L = torch.linalg.eigvalsh(A)[-1] + 1e-8
    thr = float(l1) / L * pen_mask
    b = beta_prev
    for _ in range(ISTA_STEPS):
        v = torch.addmv(xy, A, b, beta=-1.0)           # A·b − xy
        v = torch.addcdiv(b, v, L, value=-1.0)         # b − (A·b − xy)/L
        b = v - torch.clamp(v, -thr, thr)
        if non_negative:
            b[:pdim - 1].clamp_(min=0.0)
    return b


def _penalty_mask(pdim: int, dev) -> torch.Tensor:
    """1 for every slope, 0 for the intercept (last): it is never
    penalized."""
    m = torch.ones(pdim, dtype=torch.float32, device=dev)
    m[pdim - 1] = 0.0
    return m


def _glm_path_device(gram, deviance, pdim: int, dev, lams, alpha, n_obs,
                     beta0, beta_eps, family: str, max_iter: int,
                     non_negative: bool, fitplan: Dict, pod: bool = False):
    """The elastic-net regularization path on the device: a loop over λ
    (warm-started), an IRLS loop per λ whose host reads Δβ once per
    iteration, each iteration's Gram and X'Wz from `gram` (`_gram_fn`
    under the fit's shard plan), the penalized solve on the device, the
    deviance from `deviance` (`_deviance_fn`: the validation set when
    given, else training). Returns (betas (nλ, p), deviances (nλ,)) as
    device tensors; the caller re-solves the chosen λ on the host in f64
    (hex/glm/GLM.java lambda search). For gaussian the IRLS weights do not
    depend on β, so the Gram and X'Wz are computed ONCE for the whole
    path. On a pod every rank holds the same folded Gram and so the same
    β; the divergence guard is voted all the same. `fitplan` receives the
    IRLS iterations and ISTA steps run."""
    pen_mask = _penalty_mask(pdim, dev)
    eps = _f32(beta_eps)
    if family == "gaussian":
        gram_g, xy_g = gram(beta0)
    betas, devs = [], []
    beta = beta0
    iters = ista = 0
    for lam in lams:
        lam = float(lam)
        ista_each = ISTA_STEPS if _uses_ista(lam, alpha, n_obs,
                                             non_negative) else 0
        it, delta = 0, float("inf")
        while it < max_iter and delta >= eps:
            if family == "gaussian":
                g, xy = gram_g, xy_g
            else:
                g, xy = gram(beta)
            nb = _solve_pen_device(g, xy, lam, alpha, n_obs, pen_mask,
                                   beta, non_negative)
            delta = float(torch.max(torch.abs(nb - beta)))
            beta = nb
            it += 1
            ista += ista_each
        iters += it
        # f32 divergence guard: a non-finite β would NaN-poison the
        # warm-start carry for every later λ — reset instead, and report
        # +inf deviance so this λ can never be selected
        ok = torch.isfinite(beta).all()
        if pod:
            ok = torch.tensor(distdata.global_all(bool(ok)), device=dev)
        beta = torch.where(ok, beta, torch.zeros_like(beta))
        d = deviance(beta)
        devs.append(torch.where(ok, d, torch.full_like(d, float("inf"))))
        betas.append(beta)
    fitplan.update(irls_iterations=iters, ista_steps=ista)
    return torch.stack(betas), torch.stack(devs)


def _solve_penalized(gram, xy, lam, alpha, n_obs, intercept_idx, beta0,
                     non_negative=False):
    """Solve the IRLS quadratic with elastic-net penalty (host, p×p, f64).

    Ridge part closed-form; L1 (and the non_negative constraint, used by
    the StackedEnsemble metalearner) via projected ISTA on the quadratic,
    stopping once no coefficient moves by 1e-9 — the same subproblem
    hex/glm COORDINATE_DESCENT iterates on."""
    p = gram.shape[0]
    pen_mask = np.ones(p)
    pen_mask[intercept_idx] = 0.0  # intercept is never penalized
    l2 = lam * (1 - alpha) * n_obs
    l1 = lam * alpha * n_obs
    A = gram + np.diag(pen_mask * l2)
    if l1 == 0 and not non_negative:
        try:
            return np.linalg.solve(A + 1e-8 * np.eye(p), xy)
        except np.linalg.LinAlgError:
            return np.linalg.lstsq(A, xy, rcond=None)[0]
    # (projected) ISTA
    L = np.linalg.eigvalsh(A).max() + 1e-8
    b = beta0.copy()
    for _ in range(500):
        grad = A @ b - xy
        b_new = b - grad / L
        thr = l1 / L * pen_mask
        b_new = np.sign(b_new) * np.maximum(np.abs(b_new) - thr, 0)
        if non_negative:
            b_new[:intercept_idx] = np.maximum(b_new[:intercept_idx], 0.0)
        if np.max(np.abs(b_new - b)) < 1e-9:
            b = b_new
            break
        b = b_new
    return b


def _softmax_parts(Xd, ycodes, wd, B, n: int):
    """(Σ_i w_i·(⟨x_i, B_{y_i}⟩ − logsumexp(x_i Bᵀ)) as an f64 scalar,
    ((P − Y)·w)ᵀX / n as an f32 (K, p)) of the rows of (Xd, ycodes, wd): the
    data terms of the multinomial loss and its gradient, the row terms f32
    and their sum f64, the gradient two f32 matrix products. A zero-weight
    row adds exact zeros to both."""
    logits = Xd @ B.T                                    # (n, K)
    lse = torch.logsumexp(logits, dim=1)
    picked = logits.gather(1, ycodes[:, None]).squeeze(1)
    ll = torch.sum((picked - lse) * wd, dtype=torch.float64)
    G = torch.exp(logits - lse[:, None])                 # softmax
    G.scatter_add_(1, ycodes[:, None],
                   torch.full_like(lse[:, None], -1.0))  # P − Y
    return ll, (G * (wd / n)[:, None]).T @ Xd


def _softmax_loss(ll, grad, B, l2: float, n: int):
    """(loss, gradient) from the data terms: −ll / n + ½·l2·‖B without its
    intercept column‖² (f64), and the gradient plus l2·B (intercept column
    0)."""
    slopes = B[:, :-1]
    loss = -ll / n + 0.5 * l2 * torch.sum(slopes * slopes,
                                         dtype=torch.float64)
    grad[:, :-1] += l2 * slopes
    return loss, grad


def _softmax_loss_grad(Xd, ycodes, wd, B, l2: float, n: int):
    """(loss, ∂loss/∂B) of the reference's multinomial objective as device
    tensors: −Σ_i w_i·(⟨x_i, B_{y_i}⟩ − logsumexp(x_i Bᵀ)) / n + ½·l2·‖B
    without its intercept column‖², with n the row count (not Σw). The
    row terms are f32 and their sum f64 (an f64 scalar); the gradient is
    the closed form ((P − Y)·w)ᵀX / n + l2·B (intercept column 0), f32,
    from two f32 matrix products."""
    ll, grad = _softmax_parts(Xd, ycodes, wd, B, n)
    return _softmax_loss(ll, grad, B, l2, n)


def _softmax_fn(Xd, ycodes, wd, l2: float, n: int, blocks=None,
                axis_name: Optional[str] = None):
    """B → (loss, gradient) of one multinomial fit under its shard plan,
    `n` the true global row count. Off: `_softmax_loss_grad` over every
    row. The blocks and mesh lanes: each row block's (ll, (K, p) gradient
    product) packed as one f64 row (the f32 gradient widens exactly),
    gathered in rank order in one gather, then the ll column folded in
    block order in f64 and the gradient columns, back in f32, in f32 —
    the same loss and gradient on every rank."""
    if blocks is None:
        return lambda b: _softmax_loss_grad(Xd, ycodes, wd, b, l2, n)

    def fun(b):
        parts = []
        for Xb, yb, wb in blocks:
            ll, g = _softmax_parts(Xb, yb, wb, b, n)
            parts.append(torch.cat([ll.reshape(1), g.reshape(-1).double()]))
        every = torch.stack(parts)
        if axis_name is not None:
            every = cloudlib.gather_blocks(every)
        ll = _est.fold_blocks(every[:, 0], None)
        grad = _est.fold_blocks(every[:, 1:].float(), None).reshape(b.shape)
        return _softmax_loss(ll, grad, b, l2, n)

    return fun


def _lbfgs(fun, x, max_steps: int):
    """Minimise `fun` (x ↦ (loss, gradient), device tensors) from `x` as
    the reference's loop runs `optax.lbfgs`, one step a turn: here
    `torch.optim.LBFGS` (a memory of LBFGS_MEMORY pairs, a strong-Wolfe
    line search of up to LS_EVALS evaluations) with its own stopping
    tests off. A turn's loss is the one at x before its step; the loop
    stops after the turn whose loss differs from the last turn's by less
    than LBFGS_TOL, or after `max_steps` turns. Returns (x, plan): the
    turns, whether the loss rule stopped them, the loss evaluations, and
    the loss and the gradient's norm at x."""
    param = x.clone().requires_grad_()
    opt = torch.optim.LBFGS([param], lr=1.0, max_iter=1,
                            max_eval=LS_EVALS + 1, tolerance_grad=0.0,
                            tolerance_change=0.0, history_size=LBFGS_MEMORY,
                            line_search_fn="strong_wolfe")

    def closure():
        loss, param.grad = fun(param.detach())
        return loss

    prev, steps, converged = math.inf, 0, False
    for steps in range(1, max_steps + 1):
        v = float(opt.step(closure))
        if abs(prev - v) < LBFGS_TOL:
            converged = True
            break
        prev = v
    x = param.detach()
    loss, grad = fun(x)
    return x, dict(iterations=steps, converged=converged,
                   func_evals=int(opt.state[param]["func_evals"]),
                   loss=float(loss), grad_norm=float(torch.linalg.norm(grad)))


def attach_linear_artifacts(model: "GLMModel", train, valid, Xd,
                            n: int) -> "GLMModel":
    """Training/validation metrics + |coefficient| varimp for a fitted
    linear model. Training metrics reuse the fit's design matrix when it
    has exactly the frame's rows (`Xd` None: never)."""
    model.training_metrics = model._make_metrics(
        train, Xd=Xd if Xd is not None and int(Xd.shape[0]) == n else None)
    if valid is not None:
        model.validation_metrics = model._make_metrics(valid)
    # GLM varimp = |standardized coefficient| magnitudes (a multinomial
    # model's: the mean over classes of |B_k|)
    b = np.asarray(model.beta)
    if model.family == "multinomial":
        b = np.abs(b).mean(axis=0)
    mags = np.abs(b[:-1])
    if mags.sum() > 0:
        order = np.argsort(-mags)
        model.varimp_table = [
            (model.dinfo.coef_names[i], float(mags[i]),
             float(mags[i] / mags.max()), float(mags[i] / mags.sum()))
            for i in order if mags[i] > 0]
    return model


class _PathLane(NamedTuple):
    """The reductions of one λ search under its shard plan."""
    gram: Callable           # β → (X'WX, X'Wz), `_gram_fn`
    deviance: Callable       # f32 device β → deviance, `_deviance_fn`
    host_deviance: Callable  # f64 host β → deviance (the host loop's)
    n_obs: float             # Σw of the path's penalties
    warm_n_obs: float        # Σw of the f64 re-solve
    pod: bool                # vote the divergence guard over the ranks


class GLMModel(H2OModel):
    algo = "glm"

    def __init__(self, params, x, y, dinfo: DataInfo, family, beta, domain,
                 lambda_best=0.0, stderr=None, full_path=None, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self.dinfo = dinfo
        self.family = family
        # (p+1,) f64 with the intercept last, or (K, p+1) multinomial
        self.beta = beta
        self.domain = domain
        self.lambda_best = lambda_best
        self.stderr = stderr
        self.full_path = full_path  # lambda-search path [(lam, beta), ...]
        self.covmat = None  # (p+1)² dispersion-scaled covariance (p-values)
        self.device = devlib.resolve(device)

    def _names(self) -> List[str]:
        return self.dinfo.coef_names + ["Intercept"]

    def coef(self) -> Dict[str, float]:
        """De-standardized coefficients (GLMModel.coefficients); a
        multinomial model's per class, keyed by response level."""
        if self.family == "multinomial":
            return {f"{cls}": dict(zip(self._names(),
                                       self._destandardize(self.beta[k])))
                    for k, cls in enumerate(self.domain)}
        return dict(zip(self._names(), self._destandardize(self.beta)))

    def coef_norm(self) -> Dict[str, float]:
        if self.family == "multinomial":
            return {f"{cls}": dict(zip(self._names(),
                                       np.asarray(self.beta[k])))
                    for k, cls in enumerate(self.domain)}
        return dict(zip(self._names(), np.asarray(self.beta)))

    def summary(self):
        s = super().summary()
        # intercepts excluded; a multinomial predictor is active if it is
        # in any class
        if self.family == "multinomial":
            slopes = np.abs(np.asarray(self.beta)[:, :-1]).max(axis=0)
        else:
            slopes = np.abs(np.asarray(self.beta)[:-1])
        s.update(family=self.family,
                 number_of_predictors_total=len(self.dinfo.coef_names),
                 number_of_active_predictors=int((slopes > 1e-10).sum()),
                 lambda_=self.lambda_best)
        return s

    def coef_with_p_values(self):
        """Coefficient table with std errors / z / p-values on the DATA scale
        (matches coef()) — requires compute_p_values=True and lambda=0
        (GLMModel p-value output)."""
        if self.stderr is None:
            raise ValueError(
                "p-values unavailable: train with compute_p_values=True "
                "and lambda_=0")
        b = np.asarray(self.beta, np.float64)
        pdim = len(b) - 1
        cov = self.covmat
        if self.dinfo.standardize and self.dinfo.means is not None and cov is not None:
            # affine destandardization T: slope_j /= σ_j, intercept absorbs
            # −Σ β_j μ_j/σ_j; covariance transforms as T Cov Tᵀ
            T = np.zeros((pdim + 1, pdim + 1))
            T[np.arange(pdim), np.arange(pdim)] = 1.0 / self.dinfo.stds
            T[pdim, :pdim] = -self.dinfo.means / self.dinfo.stds
            T[pdim, pdim] = 1.0
            b = T @ b
            se = np.sqrt(np.maximum(np.diag(T @ cov @ T.T), 0.0))
        else:
            b = self._destandardize(b)
            se = np.asarray(self.stderr, np.float64)
        z = b / np.maximum(se, 1e-300)
        # two-sided normal p-value (the reference uses z-tests for binomial)
        pv = [erfc(abs(zz) / sqrt(2.0)) for zz in z]
        return [
            dict(names=n, coefficients=float(bb), std_error=float(s),
                 z_value=float(zz), p_value=float(p))
            for n, bb, s, zz, p in zip(self._names(), b, se, z, pv)
        ]

    def _destandardize(self, b):
        b = np.asarray(b, np.float64)
        if not self.dinfo.standardize or self.dinfo.means is None:
            return b
        out = b.copy()
        out[:-1] = b[:-1] / self.dinfo.stds
        out[-1] = b[-1] - float((b[:-1] * self.dinfo.means / self.dinfo.stds).sum())
        return out

    def _eta_dev(self, frame: Frame, Xd=None,
                 by_columns: bool = False) -> torch.Tensor:
        """Linear predictor as a DEVICE tensor. Expansion + matvec run on
        the device (compact upload, see DataInfo.device_design), in true
        f32; `Xd` lets the fit reuse its design matrix for training
        metrics. The scoring design pads to SCORE_ROW_BUCKET rows: the
        result may carry up to 511 PAD ROWS, which callers slice off on
        the host."""
        if Xd is None:
            Xd = self.dinfo.device_design(frame, fit=False,
                                          add_intercept=True,
                                          row_bucket=SCORE_ROW_BUCKET,
                                          device=self.device)
        beta = torch.as_tensor(np.asarray(self.beta, np.float32),
                               device=Xd.device)
        if by_columns:
            return (_eta_by_columns(Xd, beta) if beta.dim() == 1 else
                    torch.stack([_eta_by_columns(Xd, b) for b in beta], 1))
        return Xd @ beta.t()       # (rows,), or (rows, K) multinomial

    def _score(self, frame: Frame, Xd=None,
               by_columns: bool = False) -> np.ndarray:
        # link inverse (a multinomial model's softmax) applied on the
        # device: ONE transfer per scoring; the host-side slice drops any
        # row-bucket pad
        eta = self._eta_dev(frame, Xd=Xd, by_columns=by_columns)
        if self.family == "multinomial":
            mu = torch.softmax(eta, dim=1)
        else:
            mu = _linkinv(self.family, eta)
        return mu.cpu().numpy().astype(np.float64)[: frame.nrow]

    def predict(self, test_data: Frame) -> Frame:
        out = self._score(test_data)
        if self.family in ("binomial", "quasibinomial"):
            p1 = out
            d = {"predict": np.asarray(self.domain, dtype=object)[(p1 > 0.5).astype(int)],
                 str(self.domain[0]): 1 - p1, str(self.domain[1]): p1}
            return Frame.from_dict(d, column_types={"predict": "enum"})
        if self.family == "multinomial":
            d = {"predict": np.asarray(self.domain,
                                       dtype=object)[out.argmax(axis=1)]}
            for i, cls in enumerate(self.domain):
                d[str(cls)] = out[:, i]
            return Frame.from_dict(d, column_types={"predict": "enum"})
        return Frame.from_dict({"predict": out})

    def _make_metrics(self, frame: Frame, Xd=None):
        out = self._score(frame, Xd=Xd)
        yv = frame.vec(self.y)
        if self.family in ("binomial", "quasibinomial"):
            return ModelMetricsBinomial.make(np.asarray(yv.data), out)
        if self.family == "multinomial":
            return ModelMetricsMultinomial.make(np.asarray(yv.data), out)
        return ModelMetricsRegression.make(yv.numeric_np(), out)


class H2OGeneralizedLinearEstimator(H2OEstimator):
    algo = "glm"
    _pod_lane = True
    _param_defaults = dict(
        family="AUTO",
        solver="AUTO",
        alpha=None,
        lambda_=None,
        lambda_search=False,
        nlambdas=-1,
        lambda_min_ratio=-1.0,
        standardize=True,
        intercept=True,
        non_negative=False,
        max_iterations=-1,
        beta_epsilon=1e-4,
        objective_epsilon=-1.0,
        gradient_epsilon=-1.0,
        link="family_default",
        tweedie_variance_power=0.0,
        tweedie_link_power=1.0,
        theta=1e-10,
        missing_values_handling="MeanImputation",
        compute_p_values=False,
        remove_collinear_columns=False,
        balance_classes=False,
        class_sampling_factors=None,
        max_after_balance_size=5.0,
        prior=-1.0,
        cold_start=False,
        interactions=None,
        beta_constraints=None,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> GLMModel:
        p = self._parms
        check_unread("GLM", None, p, _UNREAD)
        if p.get("offset_column") is not None:
            # the reference's GLM never reads the offset (it drops the
            # column and fits without it); the port does not copy that
            raise NotImplementedError(
                "offset_column is not ported for GLM (ROADMAP queue A, item "
                "5: offsets; the reference's GLM ignores it, ROADMAP §C)")
        yvec = train.vec(y)
        problem, nclass, domain = response_info(yvec)
        family = p.get("family", "AUTO")
        if family not in FAMILIES:
            raise ValueError(f"family {family!r}: expected one of {FAMILIES}")
        for av in np.atleast_1d(np.asarray(p.get("alpha")
                                           if p.get("alpha") is not None
                                           else 0.5, np.float64)):
            if not (0.0 <= av <= 1.0):
                raise ValueError(f"alpha must be in [0, 1], got {av}")
        lam = p.get("lambda_")
        if lam is not None:
            for lv in np.atleast_1d(np.asarray(lam, np.float64)):
                if lv < 0:
                    raise ValueError(f"lambda must be >= 0, got {lv}")
        if family == "AUTO":
            family = {"binomial": "binomial", "multinomial": "multinomial"}.get(
                problem, "gaussian"
            )
        alpha = p.get("alpha")
        alpha = float(alpha[0] if isinstance(alpha, (list, tuple)) else (alpha if alpha is not None else 0.5))
        lam_v = float(lam[0] if isinstance(lam, (list, tuple)) else (lam or 0.0))
        if family == "multinomial":
            if yvec.type != "enum":
                raise ValueError("family='multinomial' needs a categorical "
                                 "response; call asfactor on it")
            self._check_multinomial(p, alpha, lam_v)
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        std_flag = bool(p.get("standardize", True))
        n = train.nrow
        w = (
            train.vec(p["weights_column"]).numeric_np()
            if p.get("weights_column")
            else np.ones(n)
        ).astype(np.float32)

        if family in _LOGIT:
            yarr = np.asarray(yvec.data, np.float32) if yvec.type == "enum" else yvec.numeric_np().astype(np.float32)
        elif family == "multinomial":
            yarr = np.asarray(yvec.data, np.int64)     # class codes
        else:
            yarr = yvec.numeric_np().astype(np.float32)

        lambda_search = bool(p.get("lambda_search"))
        tweedie_p = float(p.get("tweedie_variance_power") or 1.5)
        max_iter = int(p.get("max_iterations", -1))
        if max_iter <= 0:
            max_iter = 50
        beta_eps = float(p.get("beta_epsilon", 1e-4))

        # -- estimator-engine dispatch: the fused device loops, or the host
        # loops under H2O3_EST_LEGACY=1. The shard plan: "off" on one rank,
        # "blocks" under H2O3_EST_SHARD=1, "mesh" on a pod; every fit (one
        # λ, the λ path, the multinomial family) runs on the plan's lane
        engine_on = not _est.legacy()
        cloud = cloudlib.cloud()
        multiproc = distdata.multiprocess()
        shard_mode, n_shards = _est.shard_plan(cloud.size, multiproc)
        pod = shard_mode == "mesh"
        local_blocks, axis = _est.local_plan(cloud, shard_mode, n_shards)
        if pod:
            pod_check_frame(train, x, y)
        design_t: Dict[str, float] = {}
        dinfo, Xd = _est.design_matrix(
            train, x, standardize=std_flag, add_intercept=True,
            n_shards=n_shards, device=dev, timings=design_t)
        npad = int(Xd.shape[0])
        y_host, w_host = yarr, w
        n_glob = n
        if pod:
            # this rank's canonical slice of y and w (zero-weight pad at the
            # global tail), and the exact global columns for β₀'s f64 sums:
            # rank order is the global ingest order, so they equal the
            # one-process np.sum bit for bit
            counts, npad = _est.pod_rows(n, n_shards)
            y_loc = distdata.to_canonical(yarr, npad, counts=counts)
            w_loc = distdata.to_canonical(w, npad, counts=counts)
            y_host = distdata.allgather_rows(yarr)
            w_host = distdata.allgather_rows(w)
            n_glob = int(counts.sum())
        else:
            y_loc = np.concatenate([yarr, np.zeros(npad - n, yarr.dtype)])
            w_loc = np.concatenate([w, np.zeros(npad - n, np.float32)])
        yd = torch.from_numpy(y_loc).to(dev)
        wd = torch.from_numpy(w_loc).to(dev)
        blocks = _row_blocks(Xd, yd, wd, local_blocks)
        gram = _gram_fn(Xd, yd, wd, family, tweedie_p, blocks, axis)
        nfeat = len(dinfo.coef_names)
        fitplan: Dict[str, object] = dict(path="legacy")
        t_design = time.perf_counter()

        full_path = None
        stderr = None
        cov = None
        if family == "multinomial":
            beta = self._fit_multinomial(
                _softmax_fn(Xd, yd, wd, lam_v * (1.0 - alpha), n_glob,
                            blocks, axis),
                (nclass, int(Xd.shape[1])), dev, max_iter, fitplan)
            lam_best = lam_v
        elif lambda_search:
            # the deviances read the validation rows when given (each rank
            # its own, laid out on their canonical grid), else training's
            Xe, ye, we, eblocks = Xd, yd, wd, blocks
            if valid is not None:
                Xe, ye, we = self._valid_data(dinfo, valid, y, domain, dev,
                                              n_shards)
                eblocks = _row_blocks(Xe, ye, we, local_blocks)
            # Σw of the global rows (the gathered weights on a pod); the
            # one-rank full-row path keeps the device sum for its re-solve
            n_obs = float(np.asarray(w_host, np.float32).sum())
            lane = _PathLane(
                gram=gram,
                deviance=_deviance_fn(Xe, ye, we, family, tweedie_p,
                                      eblocks, axis),
                host_deviance=self._host_deviance_fn(
                    Xe, ye, we, family, tweedie_p, eblocks, axis),
                n_obs=n_obs,
                warm_n_obs=(n_obs if blocks is not None
                            else float(_wsums(yd, wd)[0])),
                pod=pod)
            beta, lam_best, full_path = self._lambda_path(
                lane, int(Xd.shape[1]), dev, family, alpha, n_glob, nfeat,
                max_iter, beta_eps, p, fitplan=fitplan)
        else:
            if engine_on:
                beta = self._irls_fused(
                    Xd, gram, family, lam_v, alpha, max_iter, beta_eps,
                    fitplan, y_host=y_host, w_host=w_host, pod=pod)
                if fitplan["path"] == "fused":
                    fitplan["path"] = _est.fused_path(shard_mode)
            else:
                beta = self._irls(Xd, yd, wd, family, lam_v, alpha, max_iter, beta_eps, tweedie_p)
            lam_best = lam_v
        _sync(dev)
        t_irls = time.perf_counter()
        # no p-values for a multinomial model (the reference's neither):
        # its stderr stays None and coef_with_p_values raises
        if (p.get("compute_p_values") and lam_best == 0
                and family != "multinomial"):
            cov, stderr = self._covariance(Xd, yd, wd, beta, family,
                                           tweedie_p, gram, blocks, axis)
        t_pv = time.perf_counter()

        _est.record_fit(
            "glm", str(fitplan.get("path", "legacy")),
            iterations=fitplan.get("iterations"),
            converged=fitplan.get("converged"),
            n_shards=n_shards,
            n_devices=cloud.size if pod else 1, family=family)
        model = GLMModel(self, x, y, dinfo, family, beta, domain,
                         lambda_best=lam_best, stderr=stderr,
                         full_path=full_path, device=dev)
        model.covmat = cov
        model.fitplan = fitplan
        if pod:
            # the pod the model was fit on: its blocks and this rank's
            model._pod = dict(ranks=cloud.size, rank=cloud.self_idx,
                              n_shards=n_shards, local_blocks=local_blocks,
                              npad=npad, quota=int(Xd.shape[0]))
        # a pod's training and validation metrics are this rank's own rows
        # (as the tree lane's), scored through a design of those rows
        attach_linear_artifacts(model, train, valid,
                                None if pod else Xd, n)
        # host-clock split of the fit (the device is synchronised at each
        # mark): the design's host pack, upload and expansion, the IRLS
        # loop (or the λ path with its re-solve), the p-value covariance,
        # the training and validation metrics
        t_end = time.perf_counter()
        solve = "lbfgs_s" if family == "multinomial" else "irls_s"
        model.fit_timings = dict(
            design_t, **{solve: t_irls - t_design}, pvalues_s=t_pv - t_irls,
            metrics_s=t_end - t_pv, total_s=t_end - t0)
        return model

    @staticmethod
    def _check_multinomial(p, alpha: float, lam: float) -> None:
        """Raise for what the reference's multinomial fit would silently
        ignore: it never reads `lambda_search` or `non_negative`, and its
        loss holds only the ridge share of α (ROADMAP §C)."""
        ignored = [
            ("lambda_search=True", bool(p.get("lambda_search")),
             "the reference fits the given λ only"),
            (f"an L1 share (alpha={alpha:g} with lambda_={lam:g})",
             alpha > 0 and lam > 0,
             "the reference's loss holds only the ridge part; pass "
             "alpha=0 or lambda_=0"),
            ("non_negative=True", bool(p.get("non_negative")),
             "the reference's fit does not constrain β"),
        ]
        for what, given, why in ignored:
            if given:
                raise NotImplementedError(
                    f"family='multinomial' with {what} is not ported: the "
                    f"reference ignores it ({why}; ROADMAP {_MULTINOMIAL}, "
                    "§C)")

    def _fit_multinomial(self, fun, shape, dev, max_iter: int,
                         fitplan) -> np.ndarray:
        """The softmax GLM (the reference's `_fit_multinomial`): B (K, p+1)
        from f32 zeros, the loss and gradient of `fun` (`_softmax_fn` under
        the fit's shard plan), minimised by `_lbfgs` on the device with the
        reference's stop rule and step cap. `fitplan` receives the steps,
        the function evaluations, the last loss and the gradient's norm at
        the returned B."""
        B = torch.zeros(shape, dtype=torch.float32, device=dev)
        B, plan = _lbfgs(fun, B, max(LBFGS_MIN_STEPS, 4 * int(max_iter)))
        fitplan.update(path="lbfgs", **plan)
        return B.cpu().numpy().astype(np.float64)

    def _valid_data(self, dinfo, valid, y, domain, dev, n_shards: int = 0):
        """(Xv, yv, wv) device tensors of a validation frame for λ
        selection, its enum response remapped to the TRAINING domain. Under
        the blocks and mesh lanes the rows lie on the validation frame's
        own canonical grid (`pad_rows` of its global rows, zero-weight pad
        at the global tail; a pod rank's slice of it), so its deviances
        fold the one-rank blocks lane's partials."""
        p = self._parms
        Xv = dinfo.transform(valid)
        Xvi = np.concatenate([Xv, np.ones((Xv.shape[0], 1), np.float32)],
                             axis=1)
        yvv = valid.vec(y)
        if yvv.type == "enum":
            codes_v = np.asarray(yvv.data, np.int64)
            if yvv.domain != domain and yvv.domain:
                # remap to the TRAINING response domain
                lookup = {d: i for i, d in enumerate(domain or [])}
                remap = np.asarray(
                    [lookup.get(d, -1) for d in yvv.domain], np.int64)
                codes_v = np.where(codes_v >= 0,
                                   remap[np.maximum(codes_v, 0)], -1)
            yva = codes_v.astype(np.float32)
        else:
            yva = yvv.numeric_np().astype(np.float32)
        wv = (valid.vec(p["weights_column"]).numeric_np()
              if p.get("weights_column")
              and p["weights_column"] in valid.names
              else np.ones(Xv.shape[0])).astype(np.float32)
        arrays = (Xvi, yva, wv)
        if n_shards:
            counts, npad = _est.pod_rows(Xv.shape[0], n_shards)
            arrays = tuple(distdata.to_canonical(a, npad, counts=counts)
                           for a in arrays)
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    def _covariance(self, Xd, yd, wd, beta, family, tweedie_p, gram=None,
                    blocks=None, axis=None):
        """(cov, stderr) of β: the inverse Gram at β, scaled by the
        dispersion — Pearson X²/(n−p) for the families whose variance is
        estimated (gaussian/gamma/tweedie), fixed at 1 for binomial/poisson
        (GLM dispersion_estimated). (None, None) for a singular Gram.
        Under the blocks and mesh lanes the Gram is the fit's folded one
        (every rank inverts the same matrix) and the Pearson sums are f64
        block partials folded in block order over the ranks."""
        beta_d = self._f32_dev(beta, Xd)
        g, _ = (gram or (lambda b: _gram_step(Xd, yd, wd, b, family,
                                              tweedie_p)))(beta_d)
        try:
            cov = np.linalg.inv(g.cpu().numpy().astype(np.float64))
        except np.linalg.LinAlgError:
            return None, None
        if family in ("gaussian", "gamma", "tweedie"):
            def pearson(X, y, w):
                eta = (X @ beta_d).cpu().numpy().astype(np.float64)
                mu = _linkinv(family, torch.from_numpy(eta).float()).numpy().astype(np.float64)
                yv_ = y.cpu().numpy().astype(np.float64)
                wv_ = w.cpu().numpy().astype(np.float64)
                vfun = {"gaussian": np.ones_like(mu),
                        "gamma": np.maximum(mu, 1e-12) ** 2,
                        "tweedie": np.maximum(mu, 1e-12) ** tweedie_p}[family]
                return np.asarray([np.sum(wv_ * (yv_ - mu) ** 2 / vfun),
                                   wv_.sum()])
            if blocks is not None:
                x2, wsum = _est.fold_blocks(torch.from_numpy(np.stack(
                    [pearson(*blk) for blk in blocks])), axis).numpy()
            else:
                x2, wsum = pearson(Xd, yd, wd)
            dof = max(float(wsum) - Xd.shape[1], 1.0)
            dispersion = float(x2 / dof)
        else:
            dispersion = 1.0
        cov = cov * dispersion
        return cov, np.sqrt(np.maximum(np.diag(cov), 0.0))

    @staticmethod
    def _beta_from_sums(wy: float, n_obs: float, family: str,
                        pdim: int) -> np.ndarray:
        """β₀ with the family's intercept warm start from (Σw·y, Σw) — the
        ONE copy of the formula; host-loop and fused inits both call it so
        they can never desynchronize."""
        beta = np.zeros(pdim, np.float64)
        if family in _LOGIT:
            mu0 = wy / (n_obs + 1e-12)
            mu0 = min(max(mu0, 1e-6), 1 - 1e-6)
            beta[-1] = np.log(mu0 / (1 - mu0))
        elif family in ("poisson", "gamma", "tweedie"):
            beta[-1] = np.log(max(wy / (n_obs + 1e-12), 1e-6))
        return beta

    def _beta_init(self, yd, wd, family, pdim) -> Tuple[np.ndarray, float]:
        """(β₀, Σw) with the sums reduced on the device."""
        n_obs, wy = (float(v) for v in _wsums(yd, wd))
        return self._beta_from_sums(wy, n_obs, family, pdim), n_obs

    def _irls_fused(self, Xd, gram, family, lam, alpha, max_iter,
                    beta_eps, fitplan, y_host, w_host, pod=False):
        """The fused single-λ IRLS fit: Gram (`gram`, `_gram_fn` under the
        fit's shard plan), penalized solve and the convergence test
        max|Δβ| < β_eps all on the device; the host reads Δβ once per
        iteration to decide whether to go on (the reference's
        `lax.while_loop` reads nothing until the end). `one_step` marks
        gaussian with α·λ = 0, whose single solve mirrors the host loop's
        unconditional gaussian break — including under non_negative, where
        both paths do exactly one projected-ISTA pass; plain gaussian
        hoists the β-independent Gram out of the loop. Falls back to the
        f64 host loop if the f32 loop diverged (separation-shaped data).

        On a pod every rank solves the same folded Gram, so β, Δβ and the
        iteration count are the same on every rank; the fallback is voted
        all the same (`global_all`), as a collective must never be left
        by one rank alone."""
        pdim = int(Xd.shape[1])
        dev = Xd.device
        # host init sums, as the reference takes them on this path (a pod's
        # y and w are the gathered global columns)
        wts = np.asarray(w_host, np.float64)
        n_obs = float(wts.sum())
        wy = float((wts * np.asarray(y_host, np.float64)).sum())
        beta0 = self._beta_from_sums(wy, n_obs, family, pdim)
        non_negative = bool(self._parms.get("non_negative"))
        one_step = (family == "gaussian" and lam >= 0 and alpha * lam == 0)
        pen_mask = _penalty_mask(pdim, dev)
        ista_each = ISTA_STEPS if _uses_ista(lam, alpha, n_obs,
                                             non_negative) else 0

        def solve(g, xy, bprev):
            return _solve_pen_device(g, xy, lam, alpha, n_obs, pen_mask,
                                     bprev, non_negative)

        b = torch.as_tensor(np.asarray(beta0, np.float32), device=dev)
        if one_step or family == "gaussian":
            gram_g, xy_g = gram(b)
        if one_step:
            nb = solve(gram_g, xy_g, b)
            it, deltas = 1, [float(torch.max(torch.abs(nb - b)))]
            b = nb
        else:
            # the host reads each iteration's Δβ (one sync per iteration)
            eps = _f32(beta_eps)
            it, deltas = 0, [float("inf")]
            while it < max_iter and deltas[-1] >= eps:
                g, xy = (gram_g, xy_g) if family == "gaussian" else gram(b)
                nb = solve(g, xy, b)
                deltas.append(float(torch.max(torch.abs(nb - b))))
                b = nb
                it += 1
            deltas = deltas[1:]
        beta = b.cpu().numpy().astype(np.float64)
        finite = bool(np.isfinite(beta).all())
        if not (distdata.global_all(finite) if pod else finite):
            # f32 divergence — the robust host loop is the answer, and the
            # plan records that the fused loop did not stick
            fitplan.update(path="host_fallback")
            return self._irls_host(gram, pdim, dev, beta0, n_obs, family,
                                   lam, alpha, max_iter, beta_eps)
        fitplan.update(
            path="fused", iterations=it, ista_steps=it * ista_each,
            deltas=deltas,
            converged=bool(one_step or deltas[-1] < _f32(beta_eps)
                           or it < max_iter))
        return beta

    def _irls(self, Xd, yd, wd, family, lam, alpha, max_iter, beta_eps, tweedie_p):
        """The host IRLS loop: Gram on the device, f64 solve on the host."""
        pdim = Xd.shape[1]
        beta, n_obs = self._beta_init(yd, wd, family, pdim)
        return self._irls_host(
            lambda b: _gram_step(Xd, yd, wd, b, family, tweedie_p), pdim,
            Xd.device, beta, n_obs, family, lam, alpha, max_iter, beta_eps)

    def _irls_host(self, gram, pdim, dev, beta, n_obs, family, lam, alpha,
                   max_iter, beta_eps):
        """The host loop over a Gram function: each iteration's Gram on the
        device, its f64 penalized solve on the host."""
        for it in range(max_iter):
            g, xy = gram(torch.as_tensor(np.asarray(beta, np.float32),
                                         device=dev))
            new_beta = _solve_penalized(
                g.cpu().numpy().astype(np.float64),
                xy.cpu().numpy().astype(np.float64),
                lam, alpha, n_obs, pdim - 1, beta,
                non_negative=bool(self._parms.get("non_negative")),
            )
            delta = np.max(np.abs(new_beta - beta))
            beta = new_beta
            if delta < beta_eps:
                break
            if family == "gaussian" and lam >= 0 and alpha * lam == 0:
                break  # gaussian ridge/OLS is exact in one step
        return beta

    @staticmethod
    def _f32_dev(beta, Xd) -> torch.Tensor:
        return torch.as_tensor(np.asarray(beta, np.float32), device=Xd.device)

    def _lambda_path(self, lane: "_PathLane", pdim: int, dev, family,
                     alpha, n, nfeat, max_iter, beta_eps, p, fitplan):
        """lambda_search: geometric path from lambda_max down, warm starts
        (hex/glm/GLM.java regularization path), every reduction from
        `lane`, `n` the global row count. `lambda_best` is chosen by
        VALIDATION deviance when a validation_frame was given (the reference
        selects on held-out deviance; training deviance otherwise, which
        favours the smallest lambda)."""
        _, xy0 = lane.gram(torch.zeros(pdim, dtype=torch.float32,
                                       device=dev))
        xy0 = xy0.cpu().numpy()
        lam_max = float(np.max(np.abs(xy0[:-1])) / max(n * max(alpha, 1e-3), 1e-12))
        nlam = int(p.get("nlambdas", -1))
        if nlam <= 0:
            nlam = 30
        ratio = float(p.get("lambda_min_ratio", -1))
        if ratio <= 0:
            ratio = 1e-4 if n > nfeat else 1e-2
        lams = lam_max * np.power(ratio, np.linspace(0, 1, nlam))
        non_negative = bool(self._parms.get("non_negative"))

        if not _est.legacy():
            # the whole path runs on the device (f32); the chosen λ is then
            # re-solved on the host in f64 for the reported coefficients.
            # H2O3_EST_LEGACY=1 takes the host IRLS loop below instead (the
            # per-λ gram-D2H + host-solve shape, the engine comparator)
            betas, devs = _glm_path_device(
                lane.gram, lane.deviance, pdim, dev,
                np.asarray(lams, np.float32), float(alpha), lane.n_obs,
                torch.zeros(pdim, dtype=torch.float32, device=dev),
                float(beta_eps), family=family, max_iter=int(max_iter),
                non_negative=non_negative, fitplan=fitplan, pod=lane.pod)
            betas = betas.cpu().numpy().astype(np.float64)
            devs = devs.cpu().numpy().astype(np.float64)
            finite = np.isfinite(devs)
            if finite.any():
                path = [(float(lv), betas[i]) for i, lv in enumerate(lams)]
                best_i = int(np.argmin(np.where(finite, devs, np.inf)))
                lam_best = float(lams[best_i])
                beta = self._irls_warm(lane, pdim, dev, lam_best, alpha,
                                       max_iter, beta_eps,
                                       betas[best_i].copy())
                fitplan.update(path="fused_path", converged=True,
                               iterations=len(lams),
                               path_deviances=devs.tolist(), best_index=best_i)
                return beta, lam_best, path
            # every λ diverged in f32 — fall through to the robust host loop

        # host path: the H2O3_EST_LEGACY comparator, or f32 divergence
        beta = np.zeros(pdim, np.float64)
        path = []
        best = (None, np.inf, 0.0)
        for lv in lams:
            beta = self._irls_warm(lane, pdim, dev, float(lv), alpha,
                                   max_iter, beta_eps, beta)
            d = lane.host_deviance(beta)
            path.append((float(lv), beta.copy()))
            if d < best[1]:
                best = (beta.copy(), d, float(lv))
        return best[0], best[2], path

    def _irls_warm(self, lane: "_PathLane", pdim: int, dev, lam, alpha,
                   max_iter, beta_eps, beta0):
        """The f64 host IRLS loop at one λ from `beta0`, its Grams from
        `lane.gram` (folded on the blocked lanes)."""
        beta = beta0.copy()
        for it in range(max_iter):
            gram, xy = lane.gram(torch.as_tensor(
                np.asarray(beta, np.float32), device=dev))
            new_beta = _solve_penalized(
                gram.cpu().numpy().astype(np.float64),
                xy.cpu().numpy().astype(np.float64),
                lam, alpha, lane.warm_n_obs, pdim - 1, beta,
                non_negative=bool(self._parms.get("non_negative")),
            )
            delta = np.max(np.abs(new_beta - beta))
            beta = new_beta
            if delta < beta_eps:
                break
        return beta

    def _deviance(self, Xd, yd, wd, family, beta, tweedie_p=1.5):
        eta = (Xd @ self._f32_dev(beta, Xd)).cpu().numpy().astype(np.float64)
        y = yd.cpu().numpy().astype(np.float64)
        w = wd.cpu().numpy().astype(np.float64)
        mu = _linkinv(family, torch.from_numpy(eta).float()).numpy().astype(np.float64)
        return float(_family_deviance_sum(family, y, mu, w, tweedie_p, xp=np))

    def _host_deviance_fn(self, X, y, w, family, tweedie_p, blocks=None,
                          axis=None):
        """β (f64 host) → the f64 host deviance of (X, y, w): one sum
        (off), or each row block's a partial folded in block order over the
        ranks."""
        if blocks is None:
            return lambda b: self._deviance(X, y, w, family, b, tweedie_p)

        def deviance(b):
            parts = np.asarray([self._deviance(Xb, yb, wb, family, b,
                                               tweedie_p)
                                for Xb, yb, wb in blocks])
            return float(_est.fold_blocks(torch.from_numpy(parts), axis))

        return deviance

    def _cv_predict(self, model: GLMModel, frame: Frame) -> np.ndarray:
        """Holdout prediction of a CV fold (GLM folds re-fit on their own
        rows: `_cv_can_reuse` stays False), η by columns
        (`_eta_by_columns`): a row's value is the same whichever rows
        share its frame."""
        return model._score(frame, by_columns=True)

    def _pod_off_lane(self, y, train: Frame):
        """What keeps a GLM off its pod lane: the engine's switches (every
        family, λ search included, has the lane)."""
        return _est.pod_switch_off()

    # h2o-py convenience
    @staticmethod
    def getGLMRegularizationPath(model):
        m = model.model if isinstance(model, H2OGeneralizedLinearEstimator) else model
        if m.full_path is None:
            return {"lambdas": [m.lambda_best], "coefficients": [m.coef()]}
        return {
            "lambdas": [l for l, _ in m.full_path],
            "coefficients": [dict(zip(m._names(), b)) for _, b in m.full_path],
        }

    def coef(self):
        return self.model.coef()

    def coef_norm(self):
        return self.model.coef_norm()

