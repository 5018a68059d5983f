"""H2OKMeansEstimator — K-Means clustering, on one device or across ranks.

Port of `h2o3_tpu/models/kmeans.py` (reference parity:
`hex/kmeans/KMeans.java`: Lloyd iterations, `init` ∈ {Random, PlusPlus,
Furthest, User}, standardization, categorical one-hot).

Shape on the card. The standardized matrix is `DataInfo.fit_transform`
on the host (`estimator_engine.host_matrix`), byte for byte the
reference's; the initial centres are drawn from it by the reference's
numpy seeding (`_seed_centers`, copied verbatim, so PlusPlus, Furthest and
Random draw the same rows for a seed). The matrix is uploaded once. Each
Lloyd iteration computes the distances ‖x‖² − 2x·cᵀ + ‖c‖² as one f32
matrix product, assigns by `argmin` (the first minimum, as `jnp.argmin`)
and forms the cluster sums and counts as a one-hot matrix product
(`oh.T @ X`, the reference's `:95-112`); a centre with no rows keeps its
value. The reference runs the loop as one `lax.while_loop` with its WSS
test on the device; the port runs it as a Python loop that reads the f32
WSS once per iteration and applies the same test in f32:
|prev − wss| < 1e-7·max(|prev|, 1).

``H2O3_EST_LEGACY=1``, and `user_points` on one rank without
``H2O3_EST_SHARD``, take the reference's host loop (`_lloyd_step`:
cluster sums by `index_add_`, the segment sum), which stops on the same
test in f64. The one-hot and segment sums add in different orders, so the
two paths agree within f32 rounding, as in the reference.

Under the estimator engine's blocks and mesh lanes (`_lloyd_fn`) each of
S row blocks gives its (weighted) sums, counts and WSS as one partial,
folded in block order; on a pod the partials of every rank's S/N blocks
are gathered in rank order, and the initial draws read the matrix
gathered in rank order, so a pod fit equals the one-rank blocks lane bit
for bit on an unstandardized matrix. `user_points` on these lanes seed
`_lloyd_fn` with the given centres and keep the host loop's f64 stop test,
so the fit stops at the reference's iteration. (The reference keeps
K-Means, `user_points` too, off its lanes on a pod and fits each rank's
rows, ROADMAP §C.) The legacy loop has no pod lane.

`predict` computes the same distances on the model's device; the
training and validation metrics are the reference's numpy code (a pod's
are its rank's own rows).
`estimate_k` is accepted by the reference and never read: only its
default is ported (ROADMAP §C).
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
from .metrics import ModelMetricsClustering
from .model_base import (DataInfo, H2OEstimator, H2OModel, _sync,
                         check_unread, pod_check_frame)

_ITEM8 = "ROADMAP queue A, item 8"
_UNREAD = dict(estimate_k=False)


def _distances(X: torch.Tensor, cents: torch.Tensor,
               xsq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """‖x − c‖² expanded as ‖x‖² − 2x·cᵀ + ‖c‖², (n, k) in f32."""
    if xsq is None:
        xsq = torch.sum(X * X, dim=1)
    return (xsq[:, None] - 2.0 * X @ cents.T
            + torch.sum(cents * cents, dim=1)[None, :])


def _lloyd_step(X, cents, w, k: int):
    """One host-loop Lloyd step (the reference's `_lloyd_step`): cluster
    sums and counts as segment sums (`index_add_`)."""
    d2 = _distances(X, cents)
    assign = torch.argmin(d2, dim=1)
    mind2 = torch.min(d2, dim=1).values
    sums = torch.zeros_like(cents).index_add_(0, assign, X * w[:, None])
    cnts = torch.zeros(k, dtype=X.dtype, device=X.device).index_add_(
        0, assign, w)
    new_cents = torch.where(cnts[:, None] > 0,
                            sums / torch.clamp(cnts[:, None], min=1e-12),
                            cents)
    wss = torch.sum(torch.clamp(mind2, min=0.0) * w)
    return new_cents, assign, wss, cnts


def _fused_step(X, xsq, karange, cents, w=None):
    """One engine-path Lloyd step's reductions (the body of the reference's
    `_lloyd_fit_fn`): (cluster sums, counts, WSS), the sums and counts as
    a one-hot matrix product. `w` weighs the rows (0 a pad row of the
    blocked lanes); without it every row weighs 1."""
    d2 = _distances(X, cents, xsq)
    assign = torch.argmin(d2, dim=1)
    mind2 = torch.clamp(torch.min(d2, dim=1).values, min=0.0)
    oh = (assign[:, None] == karange).to(X.dtype)
    if w is not None:
        oh = oh * w[:, None]
        mind2 = mind2 * w
    return oh.T @ X, torch.sum(oh, dim=0), torch.sum(mind2)


def _update(cents, sums, cnts):
    """New centres from the cluster sums; a centre with no rows keeps its
    value."""
    return torch.where(cnts[:, None] > 0,
                       sums / torch.clamp(cnts[:, None], min=1e-12), cents)


def _lloyd_fn(Xd, wd, k: int, local_blocks: int, axis):
    """centres → (new centres, WSS) of one fused Lloyd step under the fit's
    shard plan. Off: full-row reductions. The blocks and mesh lanes: each
    of this rank's row blocks a tensor of its own
    (`estimator_engine.row_blocks`), its (sums | counts, WSS) partial one
    (k + 1, p + 1) tensor, the partials folded in block order over the
    ranks in one gather a step."""
    karange = torch.arange(k, device=Xd.device)[None, :]
    if not local_blocks:
        xsq = torch.sum(Xd * Xd, dim=1)

        def step(cents):
            sums, cnts, wss = _fused_step(Xd, xsq, karange, cents)
            return _update(cents, sums, cnts), wss
        return step
    blocks = [(Xb, torch.sum(Xb * Xb, dim=1), wb) for Xb, wb in zip(
        _est.row_blocks(Xd, local_blocks), _est.row_blocks(wd, local_blocks))]
    p = Xd.shape[1]

    def step(cents):
        parts = []
        for Xb, xsq, wb in blocks:
            sums, cnts, wss = _fused_step(Xb, xsq, karange, cents, wb)
            part = torch.zeros((k + 1, p + 1), dtype=Xd.dtype,
                               device=Xd.device)
            part[:k, :p] = sums
            part[:k, p] = cnts
            part[k, 0] = wss
            parts.append(part)
        tot = _est.fold_blocks(torch.stack(parts), axis)
        return _update(cents, tot[:k, :p], tot[:k, p]), tot[k, 0]
    return step


def _seed_centers(X, k: int, init: str, rng) -> np.ndarray:
    """PlusPlus / Furthest seeding (k-means|| degenerate single pass) with
    a RUNNING min-distance vector: each draw folds only the NEW center's
    distances into d², O(k·n·p) total — the recompute-every-center form
    was O(k²·n·p). np.minimum folds the identical per-center distance
    arrays the old np.min-over-list computed, so draws (and therefore
    centers) are bitwise unchanged for a given seed."""
    n = X.shape[0]
    cents = [X[rng.integers(n)]]
    d2 = np.sum((X - cents[0]) ** 2, axis=1)
    for _ in range(k - 1):
        if init == "Furthest":
            c = X[int(d2.argmax())]
        else:
            probs = d2 / max(d2.sum(), 1e-12)
            c = X[rng.choice(n, p=probs)]
        cents.append(c)
        d2 = np.minimum(d2, np.sum((X - c) ** 2, axis=1))
    return np.asarray(cents, np.float32)


class KMeansModel(H2OModel):
    algo = "kmeans"

    def __init__(self, params, x, dinfo, centers_std, k, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = None
        self.dinfo = dinfo
        self.centers_std = np.array(centers_std, np.float32)  # standardized
        self.k = k
        self.device = devlib.resolve(device)

    def centers(self) -> np.ndarray:
        """De-standardized centroids (KMeansModel._output._centers_raw)."""
        c = np.asarray(self.centers_std, np.float64)
        if self.dinfo.standardize and self.dinfo.means is not None:
            c = c * self.dinfo.stds + self.dinfo.means
        return c

    def predict(self, test_data: Frame) -> Frame:
        X = torch.from_numpy(self.dinfo.transform(test_data)).to(self.device)
        c = torch.from_numpy(self.centers_std).to(self.device)
        assign = torch.argmin(_distances(X, c), dim=1)
        return Frame.from_dict(
            {"predict": assign.cpu().numpy().astype(np.float64)})

    def _make_metrics(self, frame: Frame):
        X = self.dinfo.transform(frame)
        c = np.asarray(self.centers_std)
        d2 = (
            np.sum(X * X, axis=1, keepdims=True) - 2.0 * X @ c.T
            + np.sum(c * c, axis=1)[None, :]
        )
        wss = float(np.maximum(d2.min(axis=1), 0).sum())
        mu = X.mean(axis=0)
        totss = float(((X - mu) ** 2).sum())
        m = ModelMetricsClustering(
            tot_withinss=wss, totss=totss, betweenss=totss - wss, nobs=X.shape[0]
        )
        m.mse = wss / max(X.shape[0], 1)
        m.rmse = float(np.sqrt(m.mse))
        return m

    def tot_withinss(self):
        return self.training_metrics.tot_withinss

    def betweenss(self):
        return self.training_metrics.betweenss

    def totss(self):
        return self.training_metrics.totss


class H2OKMeansEstimator(H2OEstimator):
    algo = "kmeans"
    supervised = False
    _pod_lane = True
    _param_defaults = dict(
        k=1,
        estimate_k=False,
        max_iterations=10,
        init="Furthest",
        user_points=None,
        standardize=True,
    )

    def _pod_off_lane(self, y, train: Frame):
        """What keeps a K-Means fit off its pod lane: the engine's
        switches."""
        return _est.pod_switch_off()

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> KMeansModel:
        if int(self._parms.get("k", 1) or 0) < 1:
            raise ValueError(f"k must be >= 1, got {self._parms.get('k')}")
        if int(self._parms.get("max_iterations", 10) or 0) < 1:
            raise ValueError("max_iterations must be >= 1")
        p = self._parms
        check_unread("K-Means", _ITEM8, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        seed = p["_actual_seed"]
        k = int(p.get("k", 1))
        std = bool(p.get("standardize", True))
        max_iter = int(p.get("max_iterations", 10))
        init = p.get("init", "Furthest")
        rng = np.random.default_rng(seed)
        user = p.get("user_points") is not None
        cloud = cloudlib.cloud()
        shard_mode, n_shards = _est.shard_plan(cloud.size,
                                               distdata.multiprocess())
        # the host loop: the legacy comparator, and user points on one rank
        # without the blocks lane (the reference's loop)
        engine_on = not (_est.legacy() or (user and shard_mode == "off"))
        pod = shard_mode == "mesh"
        local_blocks, axis = _est.local_plan(cloud, shard_mode, n_shards)
        if pod:
            pod_check_frame(train, x, None)
        t0 = time.perf_counter()
        if engine_on:
            # the host matrix and its cached upload, padded to the block
            # grid (a pod: this rank's canonical slice)
            dinfo, X, Xd = _est.device_matrix(
                train, x, standardize=std, use_all=True, n_shards=n_shards,
                device=dev)
        else:
            dinfo = DataInfo(train, x, standardize=std,
                             use_all_factor_levels=True)
            X = dinfo.fit_transform(train)
        t_pack = time.perf_counter()
        gathered = 0
        if user:
            up = p["user_points"]
            cents = np.asarray(up.to_numpy() if isinstance(up, Frame)
                               else up, np.float32)
        else:
            # the initial draws read the whole matrix: a pod gathers it in
            # rank order (the global ingest order), so they are the one-rank
            # draws
            Xall = distdata.allgather_rows(X) if pod else X
            if init == "Random":
                cents = Xall[rng.choice(Xall.shape[0], k, replace=False)]
            else:
                cents = _seed_centers(Xall, k, init, rng)
            gathered = int(Xall.nbytes) if pod else 0
            del Xall
        t_init = time.perf_counter()
        if engine_on:
            w_loc, _ = _est.row_mask(X.shape[0], n_shards)
            wd = torch.from_numpy(w_loc).to(dev)
        else:
            Xd = torch.from_numpy(X).to(dev)
        cd = torch.from_numpy(np.ascontiguousarray(cents, np.float32)).to(dev)
        _sync(dev)
        t_up = time.perf_counter()
        if not engine_on:
            wd = torch.ones(X.shape[0], dtype=torch.float32, device=dev)
            prev = np.inf
            iters = 0
            for it in range(max_iter):
                cd, _assign, wss, _cnts = _lloyd_step(Xd, cd, wd, k)
                wss = float(wss)
                iters = it + 1
                if abs(prev - wss) < 1e-7 * max(abs(prev), 1):
                    break
                prev = wss
            converged = None
            path = "legacy"
        else:
            step = _lloyd_fn(Xd, wd, k, local_blocks, axis)
            # one host read of the WSS a step (a pod's WSS is folded: the
            # same on every rank). User points keep the host loop's test in
            # f64, so they stop at the reference's iteration; the drawn
            # centres take the reference's device-side test, in f32
            if user:
                prev, tol, one = np.inf, 1e-7, 1.0
            else:
                prev = np.float32(np.inf)
                tol, one = np.float32(1e-7), np.float32(1.0)
            iters, converged = 0, False
            while iters < max_iter:
                cd, wss_d = step(cd)
                wss = float(wss_d) if user else np.float32(wss_d.item())
                iters += 1
                if np.abs(prev - wss) < tol * np.maximum(np.abs(prev), one):
                    converged = True
                    break
                prev = wss
            path = _est.fused_path(shard_mode)
        cents_out = cd.cpu().numpy()
        fit_wss = float(wss)      # the loop's last WSS (a pod's: folded)
        t_loop = time.perf_counter()
        _est.record_fit("kmeans", path, iterations=iters, converged=converged,
                        n_shards=n_shards,
                        n_devices=cloud.size if pod else 1,
                        wall_s=t_loop - t_up)
        model = KMeansModel(self, x, dinfo, cents_out, k, device=dev)
        model.iterations = iters
        model.fit_wss = fit_wss
        if pod:
            # the pod the model was fit on, and the bytes this rank held
            # for the initial draws' gather
            model._pod = dict(ranks=cloud.size, rank=cloud.self_idx,
                              n_shards=n_shards, local_blocks=local_blocks,
                              init_gather_bytes=gathered)
        # a pod's training metrics are this rank's own rows
        model.training_metrics = model._make_metrics(train)
        if valid is not None:
            model.validation_metrics = model._make_metrics(valid)
        t_end = time.perf_counter()
        # host-clock split: the host matrix, the seeding draws, the upload,
        # the Lloyd loop (synchronised by its last read) and the metrics
        model.fit_timings = dict(pack_s=t_pack - t0, init_s=t_init - t_pack,
                                 h2d_s=t_up - t_init, steps_s=t_loop - t_up,
                                 metrics_s=t_end - t_loop,
                                 total_s=t_end - t0)
        return model


KMeans = H2OKMeansEstimator
