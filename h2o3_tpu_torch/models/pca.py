"""H2OPrincipalComponentAnalysisEstimator — PCA, on one device or across
ranks.

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

Under the estimator engine's blocks and mesh lanes the Gram is S block
partials of the masked (X − μ)ᵀ(X − μ) (pad rows weigh 0), folded in
block order, on a pod over every rank's blocks in rank order; DEMEAN's μ
comes from the matrix gathered in rank order. The eigen-solve is the
same on every rank. Randomized runs its sketch as a tall-skinny QR over
the same blocks (`blocked_sketch`): each block's Y_b its own QR, the
(k+10)×(k+10) R factors gathered in rank order and QR'd again on every
rank, each block's Q its local Q times its slice of that second Q; XcᵀQ
and B = QᵀXc are folded block partials, so no rank's rows, sketch or Q
cross the ranks. Its Q differs from one QR of the whole Y in its bits but
not in its subspace. (The reference keeps PCA, Randomized too, off its
lanes on a pod and fits each rank's rows, ROADMAP §C.)

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
from ..parallel import distdata
from ..parallel import mesh as cloudlib
from . import estimator_engine as _est
from .metrics import ModelMetricsBase
from .model_base import (H2OEstimator, H2OModel, _sync, check_unread,
                         pod_check_frame)

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


def tsqr(Ys, axis):
    """Q of the tall matrix stacked from this rank's row blocks `Ys`, as
    each block's rows of it (a tall-skinny QR): each block's own QR (a
    block of fewer rows than columns padded to an l×l R with zero rows and
    its Q with zero columns), the R factors of every block gathered in rank
    order and QR'd again, the same on every rank, and each block's Q its
    local Q times its own l-row slice of that second Q."""
    from ..parallel import mesh

    l = Ys[0].shape[1]
    qs, rs = [], []
    for Yb in Ys:
        Qb, Rb = torch.linalg.qr(Yb)
        short = l - Rb.shape[0]
        if short:
            Qb = torch.cat([Qb, Qb.new_zeros((Qb.shape[0], short))], 1)
            Rb = torch.cat([Rb, Rb.new_zeros((short, l))], 0)
        qs.append(Qb)
        rs.append(Rb)
    R = torch.stack(rs)
    first = 0
    if axis is not None:
        R = mesh.gather_blocks(R)
        first = mesh.cloud().self_idx * len(Ys)
    Q2, _ = torch.linalg.qr(R.reshape(-1, l))
    return [Qb @ Q2[(first + i) * l:(first + i + 1) * l].clone()
            for i, Qb in enumerate(qs)]


def blocked_sketch(Xcs, om: np.ndarray, q: int, axis):
    """`randomized_sketch` over this rank's row blocks `Xcs` (each a
    tensor of its own, pad rows zero): Y_b = Xc_b Ω, its Q by `tsqr`; q
    power iterations Y_b ← Xc_b (XcᵀQ), XcᵀQ = Σ_b Xc_bᵀQ_b folded in block
    order; then B = Σ_b Q_bᵀXc_b folded the same way and its SVD, the same
    on every rank. What crosses the ranks is R factors and p×l and l×p
    partials. Returns (s, Vt) as f64 host arrays."""
    omd = torch.from_numpy(om).to(Xcs[0].device)
    Qs = tsqr([Xb @ omd for Xb in Xcs], axis)
    for _ in range(q):
        Z = _est.fold_blocks(torch.stack([Xb.T @ Qb for Xb, Qb in
                                          zip(Xcs, Qs)]), axis)
        Qs = tsqr([Xb @ Z for Xb in Xcs], axis)
    B = _est.fold_blocks(torch.stack([Qb.T @ Xb for Xb, Qb in
                                      zip(Xcs, Qs)]), axis)
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
    _pod_lane = True

    def _pod_off_lane(self, y, train: Frame):
        """What keeps a PCA fit off its pod lane: the engine's switches."""
        return _est.pod_switch_off()
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
        cloud = cloudlib.cloud()
        shard_mode, n_shards = _est.shard_plan(cloud.size,
                                               distdata.multiprocess())
        pod = shard_mode == "mesh"
        local_blocks, axis = _est.local_plan(cloud, shard_mode, n_shards)
        if pod:
            pod_check_frame(train, x, None)
        t0 = time.perf_counter()
        # the host matrix and its cached upload, padded to the block grid
        # (a pod: this rank's canonical slice)
        dinfo, X, Xd = _est.device_matrix(train, x, standardize=standardize,
                                          use_all=use_all, n_shards=n_shards,
                                          device=dev)
        w_loc, n = _est.row_mask(X.shape[0], n_shards)
        pdim = X.shape[1]
        gathered = 0
        if transform == "DEMEAN":
            # the mean of the whole matrix: a pod gathers it in rank order
            # (the global ingest order), so it is the one-rank mean
            Xall = distdata.allgather_rows(X) if pod else X
            mu = Xall.mean(axis=0).astype(np.float32)
            gathered = int(Xall.nbytes) if pod else 0
            del Xall
        else:
            mu = np.zeros(pdim, np.float32)
        k = min(k, pdim)
        t_pack = time.perf_counter()
        _sync(dev)
        t_up = time.perf_counter()
        iters = None
        mud = torch.from_numpy(mu).to(dev)
        Xcs = None
        if local_blocks:
            # the centred masked blocks, each a tensor of its own (pad rows
            # weigh 0)
            Xcs = [(Xb - mud[None, :]) * wb[:, None] for Xb, wb in zip(
                _est.row_blocks(Xd, local_blocks),
                _est.row_blocks(torch.from_numpy(w_loc).to(dev),
                                local_blocks))]
        if method in ("GramSVD", "GLRM", "Power"):
            if Xcs is not None:
                # the centred Gram, one partial a block, folded in block
                # order over the ranks
                gram_d = _est.fold_blocks(
                    torch.stack([Xc.T @ Xc for Xc in Xcs]), axis)
            else:
                Xc = Xd - mud[None, :]
                gram_d = Xc.T @ Xc
                del Xc
            gram = gram_d.cpu().numpy().astype(np.float64) / max(n - 1, 1)
            # the p×p eigendecomposition on the host in f64, one read, the
            # same on every rank
            evals, evecs = gram_eigen(gram, k)
        else:  # Randomized — the sketch and its iterations on the card
            # Ω from the seed, the same on every rank
            rng = np.random.default_rng(p["_actual_seed"])
            om = rng.normal(size=(pdim, min(k + 10, pdim))).astype(np.float32)
            if Xcs is not None:
                s, Vt = blocked_sketch(Xcs, om, _POWER_ITERS, axis)
            else:
                Xc = Xd[:X.shape[0]] - mud[None, :]
                s, Vt = randomized_sketch(Xc, om, _POWER_ITERS)
                del Xc
            evecs = Vt[:k].T
            evals = (s[:k] ** 2) / max(n - 1, 1)
            iters = _POWER_ITERS
        del Xcs
        t_dec = time.perf_counter()
        _est.record_fit("pca", _est.fused_path(shard_mode), iterations=iters,
                        method=method, n_shards=n_shards,
                        n_devices=cloud.size if pod else 1,
                        wall_s=t_dec - t_up)
        evecs = sign_rule(np.array(evecs))
        model = PCAModel(self, x, dinfo, evecs, evals, k, device=dev)
        if transform == "DEMEAN":
            model._demean_mu = mu.astype(np.float64)
        if pod:
            # the pod the model was fit on, and the bytes this rank held
            # for DEMEAN's gather
            model._pod = dict(ranks=cloud.size, rank=cloud.self_idx,
                              n_shards=n_shards, local_blocks=local_blocks,
                              demean_gather_bytes=gathered)
        model.training_metrics = ModelMetricsBase(nobs=n)
        model.fit_timings = dict(pack_s=t_pack - t0, h2d_s=t_up - t_pack,
                                 steps_s=t_dec - t_up,
                                 total_s=time.perf_counter() - t0)
        return model


PCA = H2OPrincipalComponentAnalysisEstimator
