"""H2OPrincipalComponentAnalysisEstimator — PCA, single device.

Port of `h2o3_tpu/models/pca.py` (reference parity:
`hex/pca/PCA.java`, `pca_method` ∈ {GramSVD, Power, GLRM, Randomized}).

GramSVD (and Power and GLRM, which the reference takes down the same
path): the centred Gram (X − μ)ᵀ(X − μ) is one true-f32 matrix product
on the card (TF32 stays off), read back once; the p×p eigendecomposition
runs on the host in f64 (`np.linalg.eigh`), ordered, clamped at 0 and
truncated to k, as in the reference. Randomized (Halko): Ω comes from
`np.random.default_rng(seed)`; the sketch, the q = 2 subspace iterations
(the reference's default) with `torch.linalg.qr` and the SVD of the small
B run on the card.

Eigenvectors and singular vectors come back with arbitrary signs from
LAPACK, cuSOLVER and XLA alike; the reference's sign rule (the largest
|loading| of each component positive) fixes the reported ones.
`compute_metrics`, `impute_missing` and `max_iterations` are accepted by
the reference and never read: only their defaults are ported (ROADMAP §C).
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
from .model_base import H2OEstimator, H2OModel, _sync, check_unread

_ITEM8 = "ROADMAP queue A, item 8"
_UNREAD = dict(compute_metrics=True, impute_missing=True, max_iterations=1000)
_POWER_ITERS = 2  # Randomized's subspace iterations


def gram_eigen(gram: np.ndarray, k: int):
    """(eigenvalues, eigenvectors) of a p×p f64 matrix: descending,
    clamped at 0, the first k."""
    evals, evecs = np.linalg.eigh(gram)
    order = np.argsort(-evals)
    return np.maximum(evals[order][:k], 0), evecs[:, order][:, :k]


def sign_rule(evecs: np.ndarray) -> np.ndarray:
    """Deterministic sign: the largest |loading| of each column positive
    (in place)."""
    for j in range(evecs.shape[1]):
        i = np.abs(evecs[:, j]).argmax()
        if evecs[i, j] < 0:
            evecs[:, j] = -evecs[:, j]
    return evecs


def randomized_sketch(Xc: torch.Tensor, om: np.ndarray, q: int):
    """Halko's randomized subspace iteration on the device (the
    reference's `_randomized_fn`): Y = Xc Ω, q power iterations
    Y ← Xc (Xcᵀ Q) re-orthonormalized by QR, then the SVD of the small
    B = Qᵀ Xc. Returns (s, Vt) as f64 host arrays."""
    Y = Xc @ torch.from_numpy(om).to(Xc.device)
    for _ in range(q):
        Q, _ = torch.linalg.qr(Y)
        Y = Xc @ (Xc.T @ Q)
    Q, _ = torch.linalg.qr(Y)
    B = Q.T @ Xc
    _, s, Vt = torch.linalg.svd(B, full_matrices=False)
    return (s.cpu().numpy().astype(np.float64),
            Vt.cpu().numpy().astype(np.float64))


class PCAModel(H2OModel):
    algo = "pca"

    def __init__(self, params, x, dinfo, eigenvectors, eigenvalues, k,
                 device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = None
        self.dinfo = dinfo
        self.eigenvectors = eigenvectors  # (p, k)
        self.eigenvalues = eigenvalues    # (k,) variances
        self.k = k
        self.device = devlib.resolve(device)

    @property
    def importance(self):
        ev = np.asarray(self.eigenvalues, np.float64)
        sd = np.sqrt(np.maximum(ev, 0))
        prop = ev / max(ev.sum(), 1e-300)
        return {
            "Standard deviation": sd,
            "Proportion of Variance": prop,
            "Cumulative Proportion": np.cumsum(prop),
        }

    def predict(self, test_data: Frame) -> Frame:
        """Scores X·V on the model's device in f64 (the reference's numpy
        product of the f32 design and the f64 eigenvectors); under
        `transform="DEMEAN"` the training means are subtracted first."""
        X = torch.from_numpy(self.dinfo.transform(test_data)).to(
            self.device, torch.float64)
        if getattr(self, "_demean_mu", None) is not None:
            X = X - torch.from_numpy(np.asarray(self._demean_mu,
                                                np.float64)).to(self.device)
        V = torch.from_numpy(np.asarray(self.eigenvectors, np.float64))
        scores = (X @ V.to(self.device)).cpu().numpy()
        return Frame.from_dict({f"PC{i+1}": scores[:, i] for i in range(self.k)})

    transform = predict

    def _make_metrics(self, frame: Frame):
        return self.training_metrics


class H2OPrincipalComponentAnalysisEstimator(H2OEstimator):
    algo = "pca"
    supervised = False
    _param_defaults = dict(
        k=1,
        transform="NONE",
        pca_method="GramSVD",
        use_all_factor_levels=False,
        compute_metrics=True,
        impute_missing=True,
        max_iterations=1000,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> PCAModel:
        p = self._parms
        check_unread("PCA", _ITEM8, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        k = int(p.get("k", 1))
        transform = p.get("transform", "NONE")
        standardize = transform in ("STANDARDIZE", "NORMALIZE")
        use_all = bool(p.get("use_all_factor_levels", False))
        method = p.get("pca_method", "GramSVD")
        t0 = time.perf_counter()
        _est.shard_plan(1, False)
        dinfo, X = _est.host_matrix(train, x, standardize=standardize,
                                    use_all=use_all)
        n, pdim = X.shape
        mu = (X.mean(axis=0).astype(np.float32) if transform == "DEMEAN"
              else np.zeros(pdim, np.float32))
        k = min(k, pdim)
        t_pack = time.perf_counter()
        # the cached upload of the host matrix (one per frame and device)
        _, Xd = _est.device_matrix(train, x, standardize=standardize,
                                   use_all=use_all, device=dev)
        _sync(dev)
        t_up = time.perf_counter()
        iters = None
        Xc = Xd - torch.from_numpy(mu).to(dev)[None, :]
        del Xd
        if method in ("GramSVD", "GLRM", "Power"):
            gram = (Xc.T @ Xc).cpu().numpy().astype(np.float64) / max(n - 1, 1)
            # the p×p eigendecomposition on the host in f64, one read
            evals, evecs = gram_eigen(gram, k)
        else:  # Randomized — the sketch and its iterations on the card
            rng = np.random.default_rng(p["_actual_seed"])
            om = rng.normal(size=(pdim, min(k + 10, pdim))).astype(np.float32)
            s, Vt = randomized_sketch(Xc, om, _POWER_ITERS)
            evecs = Vt[:k].T
            evals = (s[:k] ** 2) / max(n - 1, 1)
            iters = _POWER_ITERS
        del Xc
        t_dec = time.perf_counter()
        _est.record_fit("pca", "fused", iterations=iters, method=method,
                        wall_s=t_dec - t_up)
        evecs = sign_rule(np.array(evecs))
        model = PCAModel(self, x, dinfo, evecs, evals, k, device=dev)
        if transform == "DEMEAN":
            model._demean_mu = mu.astype(np.float64)
        model.training_metrics = ModelMetricsBase(nobs=n)
        model.fit_timings = dict(pack_s=t_pack - t0, h2d_s=t_up - t_pack,
                                 steps_s=t_dec - t_up,
                                 total_s=time.perf_counter() - t0)
        return model


PCA = H2OPrincipalComponentAnalysisEstimator
