"""H2OSingularValueDecompositionEstimator — truncated SVD, single device.

Port of `h2o3_tpu/models/svd.py` (reference parity: `hex/svd/SVD.java`,
`svd_method` ∈ {GramSVD, Power, Randomized}; outputs `d`, `v` and, with
`keep_u`, the `u` frame).

The design is `DataInfo.fit_transform` on the host; `transform="DEMEAN"`
and ``"DESCALE"`` are applied to it there at fit, as in the reference,
and the result is uploaded once. GramSVD: XᵀX is one true-f32 matrix
product on the card, decomposed on the host in f64. Power: the
reference's host deflation loop, each step's Gram-vector product
Xᵀ(Xv) on the card and read back. Randomized: the sketch Y = XΩ and
B = QᵀX on the card, the QR and the SVD of B on the host, as in the
reference. `keep_u` computes u = X·V / d on the card. The sign rule is
PCA's.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .metrics import ModelMetricsBase
from .model_base import DataInfo, H2OEstimator, H2OModel, _sync
from .pca import gram_eigen, sign_rule


def host_sketch(Xd: torch.Tensor, om: np.ndarray):
    """The reference's randomized projection: Y = XΩ and B = QᵀX on the
    device in f32, the QR of Y in f64 and the SVD of B (f32) on the host.
    Returns (s, Vt)."""
    Y = (Xd @ torch.from_numpy(om).to(Xd.device)).cpu().numpy()
    Q, _ = np.linalg.qr(Y.astype(np.float64))
    B = (torch.from_numpy(Q.astype(np.float32)).to(Xd.device).T
         @ Xd).cpu().numpy()
    _, s, Vt = np.linalg.svd(B, full_matrices=False)
    return s, Vt


class SVDModel(H2OModel):
    algo = "svd"

    def __init__(self, params, x, dinfo, d, v, u, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = None
        self.dinfo = dinfo
        self.d = d        # (k,) singular values
        self.v = v        # (p, k) right singular vectors
        self.u = u        # (n, k) left singular vectors or None
        self.device = devlib.resolve(device)

    @property
    def u_frame(self) -> Optional[Frame]:
        if self.u is None:
            return None
        return Frame.from_dict({f"u{i+1}": self.u[:, i] for i in range(self.u.shape[1])})

    def predict(self, test_data: Frame) -> Frame:
        """Project new rows onto the right singular vectors: X v / d (= u),
        on the model's device in f64. DEMEAN and DESCALE are not applied
        here, as in the reference (ROADMAP §C)."""
        dev = self.device
        X = torch.from_numpy(self.dinfo.transform(test_data)).to(
            dev, torch.float64)
        v = torch.from_numpy(np.asarray(self.v, np.float64)).to(dev)
        d = torch.from_numpy(np.asarray(self.d, np.float64)).to(dev)
        scores = ((X @ v) / torch.clamp(d[None, :], min=1e-300)).cpu().numpy()
        return Frame.from_dict({f"u{i+1}": scores[:, i] for i in range(scores.shape[1])})

    def _make_metrics(self, frame: Frame):
        return self.training_metrics


class H2OSingularValueDecompositionEstimator(H2OEstimator):
    algo = "svd"
    supervised = False
    _param_defaults = dict(
        nv=1,
        transform="NONE",
        svd_method="GramSVD",
        max_iterations=1000,
        use_all_factor_levels=True,
        keep_u=True,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> SVDModel:
        p = self._parms
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        transform = p.get("transform", "NONE")
        standardize = transform in ("STANDARDIZE", "NORMALIZE")
        dinfo = DataInfo(
            train, x, standardize=standardize,
            use_all_factor_levels=bool(p.get("use_all_factor_levels", True)),
        )
        X = dinfo.fit_transform(train)
        if transform == "DEMEAN":
            X = X - X.mean(axis=0)
        elif transform == "DESCALE":
            sd = X.std(axis=0)
            X = X / np.where(sd < 1e-10, 1.0, sd)
        n, pdim = X.shape
        k = min(int(p.get("nv", 1)), pdim)
        method = p.get("svd_method", "GramSVD")
        t_pack = time.perf_counter()
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
        _sync(dev)
        t_up = time.perf_counter()

        def gram_mv(v):
            vd = torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            return (Xd.T @ (Xd @ vd)).cpu().numpy().astype(np.float64)

        if method == "Power":
            # power iteration with deflation: v ← X'(Xv), normalized each step
            V = np.zeros((pdim, k))
            d2 = np.zeros(k)
            rng = np.random.default_rng(p["_actual_seed"])
            for j in range(k):
                v = rng.normal(size=pdim)
                v /= np.linalg.norm(v)
                for _ in range(int(p.get("max_iterations", 1000))):
                    w = gram_mv(v)
                    w -= V[:, :j] @ (V[:, :j].T @ w)  # deflate previous vectors
                    nw = np.linalg.norm(w)
                    if nw < 1e-300:
                        break
                    wn = w / nw
                    if np.abs(wn @ v) > 1 - 1e-9:
                        v = wn
                        break
                    v = wn
                V[:, j] = v
                d2[j] = v @ gram_mv(v)
            evecs, evals = V, np.maximum(d2, 0)
        elif method == "Randomized":
            rng = np.random.default_rng(p["_actual_seed"])
            om = rng.normal(size=(pdim, min(k + 10, pdim))).astype(np.float32)
            s, Vt = host_sketch(Xd, om)
            evecs = Vt[:k].T
            evals = s[:k] ** 2
        else:  # GramSVD
            gram = (Xd.T @ Xd).cpu().numpy().astype(np.float64)
            evals, evecs = gram_eigen(gram, k)

        evecs = sign_rule(np.array(evecs))
        d = np.sqrt(evals)
        u = None
        if bool(p.get("keep_u", True)):
            Vd = torch.from_numpy(evecs.astype(np.float32)).to(dev)
            u = ((Xd @ Vd).cpu().numpy().astype(np.float64)
                 / np.maximum(d[None, :], 1e-300))
        t_end = time.perf_counter()
        model = SVDModel(self, x, dinfo, d, evecs, u, device=dev)
        model.training_metrics = ModelMetricsBase(nobs=n)
        model.fit_timings = dict(pack_s=t_pack - t0, h2d_s=t_up - t_pack,
                                 steps_s=t_end - t_up, total_s=t_end - t0)
        return model


SVD = H2OSingularValueDecompositionEstimator
