"""H2OSingularValueDecompositionEstimator — truncated SVD, on one device
or across ranks.

Port of `h2o3_tpu/models/svd.py` (reference parity: `hex/svd/SVD.java`,
`svd_method` ∈ {GramSVD, Power, Randomized}; outputs `d`, `v` and, with
`keep_u`, the `u` frame).

The design is the estimator engine's cached `DataInfo.fit_transform`
matrix (`estimator_engine.device_matrix`), uploaded once;
`transform="DEMEAN"` and ``"DESCALE"`` are applied to it on the card at
fit, elementwise, so its values are the reference's host numpy ones.
GramSVD: XᵀX is one true-f32 matrix product on the card, decomposed on the
host in f64. Power: the reference's host deflation loop, each step's
Gram-vector product Xᵀ(Xv) on the card and read back. Randomized: the
sketch Y = XΩ and B = QᵀX on the card, the QR and the SVD of B on the
host, as in the reference. `keep_u` computes u = X·V / d on the card. The
sign rule is PCA's.

Under the estimator engine's blocks and mesh lanes (`shard_plan`) the
matrix is S canonical row blocks (a pod rank's S/N), each a tensor of its
own with its pad rows masked to 0, and DEMEAN's mean and DESCALE's sd come
from the matrix gathered in rank order (the one-rank values). GramSVD
folds the blocks' Gram partials in block order over the ranks; Power runs
the host loop on every rank, each Xᵀ(Xv) a folded p-vector partial;
Randomized is PCA's tall-skinny QR sketch with no power iteration
(`pca.blocked_sketch`). u is each rank's own rows, X·V summed column by
column (`_project_by_columns`) so that a row's value does not depend on
the rows beside it: a pod's u is, rank by rank, the one-rank blocks lane's
u in rank order. (The reference's SVD has no multi-process code: each rank
fits its own rows, ROADMAP §C.)
"""

from __future__ import annotations

import copy
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
from .model_base import H2OEstimator, H2OModel, _sync, pod_check_frame
from .pca import blocked_sketch, gram_eigen, sign_rule


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


def _project_by_columns(X: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """X·V with each row's sums taken column by column in a fixed order, as
    exactly rounded elementwise products and sums: a row's value does not
    depend on how many rows X holds (`glm._eta_by_columns` for a matrix of
    vectors)."""
    Xt = X.t().contiguous()
    out = Xt[0][:, None] * V[0]
    for j in range(1, Xt.shape[0]):
        out = out + Xt[j][:, None] * V[j]
    return out


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
    _pod_lane = True
    _param_defaults = dict(
        nv=1,
        transform="NONE",
        svd_method="GramSVD",
        max_iterations=1000,
        use_all_factor_levels=True,
        keep_u=True,
    )

    def _pod_off_lane(self, y, train: Frame):
        """What keeps an SVD fit off its pod lane: the engine's switches."""
        return _est.pod_switch_off()

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> SVDModel:
        p = self._parms
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        transform = p.get("transform", "NONE")
        standardize = transform in ("STANDARDIZE", "NORMALIZE")
        use_all = bool(p.get("use_all_factor_levels", True))
        cloud = cloudlib.cloud()
        shard_mode, n_shards = _est.shard_plan(cloud.size,
                                               distdata.multiprocess())
        pod = shard_mode == "mesh"
        local_blocks, axis = _est.local_plan(cloud, shard_mode, n_shards)
        if pod:
            pod_check_frame(train, x, None)
        # the host matrix and its cached upload, padded to the block grid
        # (a pod: this rank's canonical slice)
        dinfo, X, Xd = _est.device_matrix(train, x, standardize=standardize,
                                          use_all=use_all, n_shards=n_shards,
                                          device=dev)
        if dinfo.use_all != use_all:
            # the cache keys an all-numeric frame without the flag, which
            # changes no column; the model keeps the one asked for
            dinfo = copy.copy(dinfo)
            dinfo.use_all = use_all
        w_loc, n = _est.row_mask(X.shape[0], n_shards)
        pdim = X.shape[1]
        k = min(int(p.get("nv", 1)), pdim)
        method = p.get("svd_method", "GramSVD")
        # DEMEAN's mean and DESCALE's sd of the whole matrix (a pod gathers
        # it in rank order, the global ingest order, so they are the
        # one-rank values), applied on the device elementwise: the host
        # numpy bits
        shift = scale = None
        if transform in ("DEMEAN", "DESCALE"):
            Xall = distdata.allgather_rows(X) if pod else X
            if transform == "DEMEAN":
                shift = torch.from_numpy(Xall.mean(axis=0)).to(dev)
            else:
                sd = Xall.std(axis=0)
                scale = torch.from_numpy(np.where(sd < 1e-10, 1.0, sd)
                                         .astype(np.float32)).to(dev)
            del Xall

        def prep(t):
            if shift is not None:
                t = t - shift
            if scale is not None:
                t = t / scale
            return t

        Xc = Xcs = None
        if local_blocks:
            # each block a tensor of its own, its pad rows masked to 0
            Xcs = [prep(Xb) * wb[:, None] for Xb, wb in zip(
                _est.row_blocks(Xd, local_blocks),
                _est.row_blocks(torch.from_numpy(w_loc).to(dev),
                                local_blocks))]
        else:
            Xc = prep(Xd)
        t_pack = time.perf_counter()
        _sync(dev)
        t_up = time.perf_counter()

        def gram_mv(v):
            vd = torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            if Xcs is None:
                g = Xc.T @ (Xc @ vd)
            else:
                g = _est.fold_blocks(torch.stack(
                    [Xb.T @ (Xb @ vd) for Xb in Xcs]), axis)
            return g.cpu().numpy().astype(np.float64)

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
            s, Vt = (host_sketch(Xc, om) if Xcs is None
                     else blocked_sketch(Xcs, om, 0, axis))
            evecs = Vt[:k].T
            evals = s[:k] ** 2
        else:  # GramSVD
            gram = (Xc.T @ Xc if Xcs is None else _est.fold_blocks(
                torch.stack([Xb.T @ Xb for Xb in Xcs]), axis))
            evals, evecs = gram_eigen(gram.cpu().numpy().astype(np.float64),
                                      k)
        del Xcs
        evecs = sign_rule(np.array(evecs))
        d = np.sqrt(evals)
        u = None
        if bool(p.get("keep_u", True)):
            Vd = torch.from_numpy(evecs.astype(np.float32)).to(dev)
            if Xc is not None:
                XV = Xc @ Vd
            else:
                # this rank's own rows, row by row as the one-rank lane's
                XV = _project_by_columns(prep(torch.from_numpy(X).to(dev)),
                                         Vd)
            u = (XV.cpu().numpy().astype(np.float64)
                 / np.maximum(d[None, :], 1e-300))
        t_end = time.perf_counter()
        _est.record_fit("svd", _est.fused_path(shard_mode), method=method,
                        n_shards=n_shards,
                        n_devices=cloud.size if pod else 1,
                        wall_s=t_end - t_up)
        model = SVDModel(self, x, dinfo, d, evecs, u, device=dev)
        if pod:
            model._pod = dict(ranks=cloud.size, rank=cloud.self_idx,
                              n_shards=n_shards, local_blocks=local_blocks)
        model.training_metrics = ModelMetricsBase(nobs=n)
        model.fit_timings = dict(pack_s=t_pack - t0, h2d_s=t_up - t_pack,
                                 steps_s=t_end - t_up, total_s=t_end - t0)
        return model


SVD = H2OSingularValueDecompositionEstimator
