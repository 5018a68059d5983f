"""H2OGeneralizedLowRankEstimator — GLRM, single device.

Port of `h2o3_tpu/models/glrm.py` (reference parity:
`hex/glrm/GLRM.java`): A ≈ X·Y (n×k · k×p) under quadratic loss and
quadratic regularization γₓ‖X‖² + γᵧ‖Y‖², missing cells excluded from the
loss, by alternating least squares.

The expansion keeps NaNs (`_expand_masked`): the observation mask M and
the zero-filled A come from the host, as does the starting point (Random:
`rng.normal`; otherwise the host SVD of A), so both equal the
reference's bit for bit. The alternating loop runs on the card:

- `update_X` solves every row's k×k normal equations
  G_i = Y diag(M_i) Yᵀ + γₓI, b_i = Y (M_i ∘ A_i) as one batched solve.
  G is formed as ONE matrix product M @ P with P[p, (k, l)] = Y[k,p]·Y[l,p]
  — an (n, p) × (p, k²) GEMM — instead of the reference's einsum
  "kp,np,lp->nkl", which would build an (n, k, p) intermediate (1.25 GB
  at Covertype's 581,012 × 54 and k = 10);
- `update_Y` the same for the columns: G = Mᵀ @ Q with
  Q[n, (k, l)] = X[n,k]·X[n,l];
- the objective ‖M ∘ (A − XY)‖² + γₓ‖X‖² + γᵧ‖Y‖² is evaluated in f32 at
  iterations `it % 5 == 4` and at the last one, and read on the host
  there; the fit stops when |prev − obj| < 1e-8·max(|prev|, 1) in f32,
  the reference's rule (with f32 objectives of this size it is in effect
  an equality test, so iteration counts can differ between packages).

γ is `gamma` + 1e-6. `max_iterations` is capped at 300, silently, as in
the reference (ROADMAP §C).

`transform` (`_project`) solves each row's masked k×k system for new data;
the reference loops over rows on the host, the port solves them all as
one batched f64 solve on the model's device. The parameters the
reference accepts and never reads raise at any value but their default
(ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from . import estimator_engine as _est
from .metrics import ModelMetricsBase
from .model_base import (DataInfo, H2OEstimator, H2OModel, _sync,
                         check_unread, warn_host_solver)

_ITEM8 = "ROADMAP queue A, item 8"
_UNREAD = dict(loss="Quadratic", multi_loss="Categorical", loss_by_col=None,
               max_updates=2000, init_step_size=1.0, min_step_size=1e-4,
               svd_method="Randomized", impute_original=False,
               recover_svd=False, period=1)
# the regularizers whose model is the reference's quadratic γ‖·‖² penalty
_QUADRATIC = ("None", "Quadratic")


def _pair_products(Z: torch.Tensor) -> torch.Tensor:
    """(r, k) → (r, k²): Z[r, a]·Z[r, b] in row-major (a, b) order."""
    r, k = Z.shape
    return (Z[:, :, None] * Z[:, None, :]).reshape(r, k * k)


def _solve_batched(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve every (k, k) system of G against its row of b."""
    return torch.linalg.solve(G, b.unsqueeze(-1)).squeeze(-1)


def update_X(A_M, M, Y, gx):
    """Rows' masked normal equations: G_i = Y diag(M_i) Yᵀ + γₓI."""
    k = Y.shape[0]
    G = (M @ _pair_products(Y.T)).reshape(-1, k, k)
    G = G + gx * torch.eye(k, dtype=Y.dtype, device=Y.device)[None]
    return _solve_batched(G, A_M @ Y.T)


def update_Y(A_M, M, X, gy):
    """Columns' masked normal equations: G_j = Xᵀ diag(M_j) X + γᵧI."""
    k = X.shape[1]
    G = (M.T @ _pair_products(X)).reshape(-1, k, k)
    G = G + gy * torch.eye(k, dtype=X.dtype, device=X.device)[None]
    return _solve_batched(G, A_M.T @ X).T


def objective(A, M, X, Y, gx, gy) -> torch.Tensor:
    R = (A - X @ Y) * M
    return (torch.sum(R * R) + gx * torch.sum(X * X)
            + gy * torch.sum(Y * Y))


def project(A: np.ndarray, Y: np.ndarray, device) -> np.ndarray:
    """Each row's archetype weights for the NaN-holding (standardized) rows
    A against archetypes Y (k, p): the masked k×k system
    (Y_m Y_mᵀ + 1e-6 I) x = Y_m A_m of every row, solved as one batched
    f64 solve on `device` (the reference's per-row host loop)."""
    k = Y.shape[0]
    A = torch.from_numpy(np.ascontiguousarray(A, np.float64)).to(device)
    M = (~torch.isnan(A)).to(torch.float64)
    A0 = torch.nan_to_num(A, nan=0.0)
    Yd = torch.from_numpy(np.asarray(Y, np.float64)).to(device)
    G = (M @ _pair_products(Yd.T)).reshape(-1, k, k)
    G = G + 1e-6 * torch.eye(k, dtype=torch.float64, device=device)[None]
    return _solve_batched(G, (A0 * M) @ Yd.T).cpu().numpy()


class GLRMModel(H2OModel):
    algo = "glrm"

    def __init__(self, params, x, dinfo, X, Y, k, objective, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = None
        self.dinfo = dinfo
        self.X = X  # (n, k) archetypes weights
        self.Y = Y  # (k, p) archetypes
        self.k = k
        self.objective = objective
        self.device = devlib.resolve(device)

    def archetypes(self) -> np.ndarray:
        return self.Y

    def reconstruct(self, frame: Frame) -> Frame:
        Xn = self._project(frame)
        R = Xn @ self.Y
        names = self.dinfo.coef_names
        return Frame.from_dict({f"reconstr_{names[j]}": R[:, j] for j in range(R.shape[1])})

    def _project(self, frame: Frame) -> np.ndarray:
        # _expand keeps NaNs (transform() would zero-fill and destroy the
        # observation mask, silently treating holes as observed zeros)
        A = self.dinfo._expand(frame, fit=False)
        if self.dinfo.means is not None:  # STANDARDIZE or DEMEAN was fit
            A = (A - self.dinfo.means) / self.dinfo.stds
        return project(A, self.Y, self.device)

    def transform(self, frame: Frame) -> Frame:
        Xn = self._project(frame)
        return Frame.from_dict({f"Arch{j+1}": Xn[:, j] for j in range(self.k)})

    predict = reconstruct

    def _make_metrics(self, frame):
        return self.training_metrics


class H2OGeneralizedLowRankEstimator(H2OEstimator):
    algo = "glrm"
    supervised = False
    _param_defaults = dict(
        k=1,
        loss="Quadratic",
        multi_loss="Categorical",
        loss_by_col=None,
        regularization_x="None",
        regularization_y="None",
        gamma_x=0.0,
        gamma_y=0.0,
        max_iterations=1000,
        max_updates=2000,
        init_step_size=1.0,
        min_step_size=1e-4,
        init="PlusPlus",
        svd_method="Randomized",
        impute_original=False,
        recover_svd=False,
        transform="NONE",
        period=1,
    )

    @staticmethod
    def _check_params(p: dict) -> None:
        check_unread("GLRM", _ITEM8, p, _UNREAD)
        for ax in ("x", "y"):
            reg = p.get(f"regularization_{ax}", "None")
            gamma = float(p.get(f"gamma_{ax}", 0.0))
            if reg not in _QUADRATIC or (reg == "None" and gamma != 0.0):
                raise NotImplementedError(
                    f"regularization_{ax}={reg!r} with gamma_{ax}={gamma!r}: "
                    f"the reference fits the quadratic penalty gamma_{ax}·‖·‖² "
                    "whatever the regularizer, so only 'Quadratic' (or "
                    f"'None' with gamma_{ax}=0) is ported ({_ITEM8}; "
                    "ROADMAP §C)")

    @staticmethod
    def _expand_masked(train: Frame, x, transform: str):
        """(dinfo, zero-filled A float32, observation mask float32) — the
        NaN-masked expansion, standardized (STANDARDIZE/NORMALIZE) or
        demeaned (DEMEAN) with stats over the observed cells; cached in the
        dataset cache's std layer per (frame, x, transform)."""
        def build():
            dinfo = DataInfo(train, x,
                             standardize=transform in ("STANDARDIZE",
                                                       "NORMALIZE"),
                             use_all_factor_levels=True,
                             impute_missing=False)
            A_raw = dinfo._expand(train, fit=True)
            if dinfo.standardize:
                dinfo.means = np.nanmean(A_raw, axis=0)
                sd = np.nanstd(A_raw, axis=0)
                dinfo.stds = np.where(sd < 1e-10, 1.0, sd)
                A_raw = (A_raw - dinfo.means) / dinfo.stds
            elif transform == "DEMEAN":
                dinfo.means = np.nanmean(A_raw, axis=0)
                dinfo.stds = np.ones(A_raw.shape[1])
                A_raw = A_raw - dinfo.means
            mask = (~np.isnan(A_raw)).astype(np.float32)
            A = np.nan_to_num(A_raw, nan=0.0).astype(np.float32)
            return (dinfo, A, mask), int(A.nbytes + mask.nbytes), "host"

        return _est._std_artifact(train, x, ("glrm", str(transform)), build)

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> GLRMModel:
        p = self._parms
        self._check_params(p)
        dev = devlib.resolve(p.get("device"))
        warn_host_solver('glrm', train.nrow, 200000)
        t0 = time.perf_counter()
        seed = p["_actual_seed"]
        k = int(p.get("k", 1))
        transform = p.get("transform", "NONE")
        dinfo, A, mask = self._expand_masked(train, x, transform)
        n, pd = A.shape
        k = min(k, min(n, pd))

        gx = float(p.get("gamma_x", 0.0)) + 1e-6
        gy = float(p.get("gamma_y", 0.0)) + 1e-6
        t_pack = time.perf_counter()

        rng = np.random.default_rng(seed)
        if p.get("init", "PlusPlus") == "Random":
            X = rng.normal(scale=0.1, size=(n, k)).astype(np.float32)
            Y = rng.normal(scale=0.1, size=(k, pd)).astype(np.float32)
        else:
            # SVD warm start on the zero-imputed matrix (GLRM init=SVD;
            # markedly better basin than random for the ALS iterations)
            Uz, s, Vt = np.linalg.svd(A, full_matrices=False)
            X = (Uz[:, :k] * s[:k]).astype(np.float32)
            Y = Vt[:k].astype(np.float32)
        t_init = time.perf_counter()

        Ad = torch.from_numpy(A).to(dev)
        Md = torch.from_numpy(mask).to(dev)
        Xj = torch.from_numpy(X).to(dev)
        Yj = torch.from_numpy(Y).to(dev)
        _sync(dev)
        t_up = time.perf_counter()
        AM = Ad * Md
        iters = min(int(p.get("max_iterations", 1000)), 300)
        # the reference's f32 stop rule, read on the host at each check
        gx32, gy32 = np.float32(gx), np.float32(gy)
        tol, one = np.float32(1e-8), np.float32(1.0)
        prev = np.float32(np.inf)
        it_done, converged, history = 0, False, []
        for it in range(iters):
            Xj = update_X(AM, Md, Yj, gx32.item())
            Yj = update_Y(AM, Md, Xj, gy32.item())
            it_done = it + 1
            if it % 5 == 4 or it == iters - 1:
                obj = np.float32(objective(Ad, Md, Xj, Yj, gx32.item(),
                                           gy32.item()).item())
                history.append((it_done, float(obj)))
                if np.abs(prev - obj) < tol * np.maximum(np.abs(prev), one):
                    converged = True
                    break
                prev = obj
        if it_done == 0:  # no check ran: the objective at the start
            obj = np.float32(objective(Ad, Md, Xj, Yj, gx32.item(),
                                       gy32.item()).item())
        t_loop = time.perf_counter()
        _est.record_fit("glrm", "fused", iterations=it_done,
                        converged=converged, wall_s=t_loop - t_up)
        model = GLRMModel(self, x, dinfo, Xj.cpu().numpy(), Yj.cpu().numpy(),
                          k, float(obj), device=dev)
        model.iterations = it_done
        # (iteration, objective) at each of the loop's checks
        model.objective_history = history
        mm = ModelMetricsBase(nobs=n)
        mm.description = f"objective={model.objective:.6g}"
        model.training_metrics = mm
        t_end = time.perf_counter()
        model.fit_timings = dict(pack_s=t_pack - t0, init_s=t_init - t_pack,
                                 h2d_s=t_up - t_init, steps_s=t_loop - t_up,
                                 total_s=t_end - t0)
        return model


GLRM = H2OGeneralizedLowRankEstimator
