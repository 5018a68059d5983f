"""Model framework — the estimator lifecycle and the trained-model surface.

Port of the parts of `h2o3_tpu/models/model_base.py` the tree estimators
and GLM use: `H2OModel` (metric accessors, `predict`, `model_performance`,
the scoring history), `H2OEstimator` (parameter checking, `train` with a
validation frame), `ScoringHistory`, `ScoreKeeper` (`hex.ScoreKeeper`'s
moving-average early stopping) and `DataInfo` (`hex.DataInfo`: the
standardized one-hot design, its stats fit on the host and its expansion
on the device). `offset_column` reaches the tree fit (GBM); GLM raises
for it. `train` runs the reference's n-fold cross-validation (`_run_cv`,
`hex.ModelBuilder.computeCrossValidation`): the fold assignment, one fold
model per fold fit through `_fit`, the holdout predictions and the
cross-validation metrics. Tree builders slice the parent fit's binned
codes per fold unless `H2O3_CV_REBIN=1` asks for the per-fold re-bin path.
`train` takes up a `Job` (`water.Job`): its own, or the one a caller
hands it as `_external_job` (the train pool's child job), started there
and finished when the model is built. The fit loops check it for
cancellation and report progress at the reference's safe points (the
tree loop's chunk boundaries, DeepLearning's chunk and step
boundaries), and `max_runtime_secs` stops a fit at the same boundaries by
the reference's rule. Checkpoints and the REST/DKV surface are not ported
yet (ROADMAP queue A, items 5 and 11): `train` registers no model in the
DKV.

On a pod (a cloud of several ranks, `parallel/mesh.py`) `train` lets only
the estimators with a pod lane fit (`_pod_lane`: the tree estimators,
GLM, K-Means, PCA, SVD) and raises for the rest, and for the fits their
lanes do not take (`_pod_off_lane`), on every rank before any collective
(`_pod_guard`); `ignore_const_cols` decides over every rank's rows.
`DataInfo` takes the global moments, imputation means and transfer
groups there, and `_run_cv` draws the one-process folds over the global
rows.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from ..frame.vec import Vec
from ..runtime import phases as _phases
from ..runtime import trainpool as _trainpool
from .metrics import (ModelMetricsBase, ModelMetricsBinomial,
                      ModelMetricsMultinomial, ModelMetricsRegression)

_model_counter = itertools.count()
_job_counter = itertools.count()

# scorer row bucket: tree scoring and the GLM scoring design pad their row
# dimension to this multiple, as the reference does, so scoring inputs
# keep a fixed grid of shapes
SCORE_ROW_BUCKET = 512


class JobCancelled(Exception):
    """Raised at a fit loop's safe point once its job's cancel was requested."""


@dataclass
class Job:
    """`water.Job` — progress/cancel tracking for a training run."""

    dest: str
    description: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    progress: float = 0.0
    status: str = "CREATED"  # CREATED/RUNNING/DONE/FAILED/CANCELLED
    warnings: List[str] = field(default_factory=list)
    cancel_requested: bool = False
    # the trace the job's spans join (the train pool's candidates carry
    # their sweep's)
    trace_id: Optional[str] = None

    def start(self):
        self.start_time = time.time()
        self.status = "RUNNING"
        return self

    def update(self, progress: float):
        self.progress = float(progress)

    def cancel(self):
        """Request cancellation: takes effect at the fit loop's next safe
        point."""
        if self.status in ("CREATED", "RUNNING"):
            self.cancel_requested = True

    def check_cancelled(self):
        """Fit-side safe point: finalize + raise if a cancel is pending."""
        if self.cancel_requested and self.status == "RUNNING":
            self.status = "CANCELLED"
            self.end_time = time.time()
            raise JobCancelled(self.dest)

    def done(self):
        self.end_time = time.time()
        self.progress = 1.0
        self.status = "DONE"

    @property
    def run_time(self) -> float:
        return (self.end_time or time.time()) - self.start_time


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def expand_design(spec, use_all: bool, standardized: bool,
                  add_intercept: bool, nums8, nums16, nums32, cats, means,
                  stds) -> torch.Tensor:
    """The design matrix from its compact packs, on the packs' device — the
    plain torch form of the reference's jitted `_device_expand_fn`.

    `spec` holds per input column ("num", transfer group) or ("cat", K).
    Numeric columns arrive in three transfer groups (uint8, int16, f32) and
    widen to f32 here; a categorical column's int32 codes become K one-hot
    columns (K − 1 without `use_all`; a code of −1 — NA or an unseen level —
    is all zeros). Then (X − means) / stds, NaN → 0 and the intercept
    column, as the reference does. The output is allocated once and filled
    and standardized in place (the reference's arrays are immutable, so it
    materializes each step; in place keeps the peak at one design matrix)."""
    groups = (nums8, nums16, nums32)
    n = cats.shape[0]
    widths = [1 if kind == "num" else (K if use_all or K == 0 else K - 1)
              for kind, K in spec]
    p = sum(widths)
    dev = cats.device
    X = torch.empty((n, p + int(add_intercept)), dtype=torch.float32,
                    device=dev)
    idx = [0, 0, 0]
    ci = 0
    pos = 0
    for (kind, K), width in zip(spec, widths):
        if kind == "num":
            g = K  # for num entries, K carries the transfer group id
            X[:, pos] = groups[g][:, idx[g]]
            idx[g] += 1
        else:
            codes = cats[:, ci]
            ci += 1
            first = 0 if use_all else 1
            lv = torch.arange(first, K, dtype=torch.int32, device=dev)
            X[:, pos:pos + width] = codes[:, None] == lv[None, :]
        pos += width
    body = X[:, :p]
    if standardized:
        body.sub_(means[None, :]).div_(stds[None, :])
    # trailing NaN cleanup, mirroring fit_transform/transform
    body.nan_to_num_(nan=0.0)
    if add_intercept:
        X[:, p] = 1.0
    return X


class ScoringHistory(list):
    """Scoring-history rows, list-compatible and callable: h2o-py's
    `model.scoring_history()` returns a table (a `Frame` here; the
    reference's `use_pandas` is not ported), while the drivers index the
    rows directly."""

    def __call__(self) -> Frame:
        cols = {}
        for k in (list(self[0]) if self else []):
            vals = [r.get(k) for r in self]
            if isinstance(vals[0], str):
                cols[k] = np.asarray(vals, dtype=object)
            else:
                cols[k] = np.asarray(
                    [np.nan if v is None else float(v) for v in vals])
        return Frame.from_dict(cols) if cols else Frame({})


class ScoreKeeper:
    """`hex.ScoreKeeper.stopEarly` — moving-average early stopping."""

    def __init__(self, stopping_rounds: int, stopping_metric: str, tolerance: float,
                 larger_is_better: Optional[bool] = None):
        self.k = stopping_rounds
        self.metric = stopping_metric
        self.tol = tolerance
        if larger_is_better is None:
            larger_is_better = stopping_metric.lower() in ("auc", "pr_auc", "accuracy", "r2")
        self.more = larger_is_better
        self.history: List[float] = []

    def record(self, value: float) -> bool:
        """Record a scoring event; True ⇒ stop now (moving average of the
        last k events is not better than the best before them by > tol)."""
        self.history.append(float(value))
        k = self.k
        if k <= 0 or len(self.history) < 2 * k:
            return False
        hist = np.asarray(self.history)
        recent = hist[-k:].mean()
        prior = hist[:-k]
        best_prior = prior.max() if self.more else prior.min()
        margin = self.tol * max(abs(best_prior), 1e-12)
        if self.more:
            return recent <= best_prior + margin
        return recent >= best_prior - margin


class DataInfo:
    """`hex.DataInfo` — Frame → dense numeric design matrix.

    use_all_factor_levels / standardize / imputeMissing mirror the reference
    flags; categorical expansion is one-hot (the reference's default enum
    encoding for GLM/DL). A copy of the reference's class: the host half
    (spec, coefficient names, stats, `fit_transform`, `transform`) is its
    numpy code, byte for byte; `device_design` uploads the compact packs and
    expands them with `expand_design` on the device."""

    def __init__(
        self,
        frame: Frame,
        x: Sequence[str],
        standardize: bool = True,
        use_all_factor_levels: bool = False,
        impute_missing: bool = True,
        max_categorical_levels: int = 1000,
    ):
        self.x = list(x)
        self.standardize = standardize
        self.use_all = use_all_factor_levels
        self.coef_names: List[str] = []
        self._spec = []  # per input col: ("num", name) | ("cat", name, domain)
        for n in self.x:
            v = frame.vec(n)
            if v.type == "enum":
                dom = (v.domain or [])[:max_categorical_levels]
                self._spec.append(("cat", n, dom))
                levels = dom if use_all_factor_levels else dom[1:]
                self.coef_names += [f"{n}.{d}" for d in levels]
            else:
                self._spec.append(("num", n, None))
                self.coef_names.append(n)
        self.means: Optional[np.ndarray] = None
        self.stds: Optional[np.ndarray] = None
        self.impute_missing = impute_missing
        self.col_means: Dict[str, float] = {}

    @classmethod
    def from_state(cls, *, spec, coef_names, standardize: bool,
                   use_all: bool, means=None, stds=None, col_means=None,
                   transfer_groups=None,
                   impute_missing: bool = True) -> "DataInfo":
        """A fitted DataInfo from its stored state (a model carried across
        from the reference, see `convert.glm_from_numpy`)."""
        self = cls.__new__(cls)
        self._spec = [(k, n, list(d) if d is not None else None)
                      for k, n, d in spec]
        self.x = [n for _, n, _ in self._spec]
        self.coef_names = list(coef_names)
        self.standardize = bool(standardize)
        self.use_all = bool(use_all)
        self.means = (np.asarray(means, np.float64)
                      if means is not None else None)
        self.stds = np.asarray(stds, np.float64) if stds is not None else None
        self.impute_missing = impute_missing
        self.col_means = {k: float(v) for k, v in (col_means or {}).items()}
        if transfer_groups is not None:
            self._transfer_groups = [int(g) for g in transfer_groups]
        return self

    def fit_transform(self, frame: Frame) -> np.ndarray:
        X = self._expand(frame, fit=True)
        if self.standardize:
            from ..parallel import distdata

            if distdata.multiprocess():
                # global moments across the pod (the MRTask mean/σ reduce):
                # two passes of f64 global sums, the mean first, then
                # Σ(x − μ)², as the reference takes them
                finite = ~np.isnan(X)
                s = distdata.global_sum(np.nansum(X, axis=0))
                c = np.maximum(distdata.global_sum(finite.sum(axis=0)), 1.0)
                self.means = s / c
                dev2 = distdata.global_sum(
                    np.nansum((X - self.means) ** 2, axis=0))
                self.stds = np.sqrt(dev2 / c)
            else:
                self.means = np.nanmean(X, axis=0)
                self.stds = np.nanstd(X, axis=0)
            self.stds = np.where(self.stds < 1e-10, 1.0, self.stds)
            X = (X - self.means) / self.stds
        return np.nan_to_num(X, nan=0.0).astype(np.float32)

    def transform(self, frame: Frame) -> np.ndarray:
        X = self._expand(frame, fit=False)
        if self.standardize and self.means is not None:
            X = (X - self.means) / self.stds
        return np.nan_to_num(X, nan=0.0).astype(np.float32)

    def device_design(self, frame: Frame, fit: bool,
                      add_intercept: bool = False, cloud=None,
                      quota: Optional[int] = None,
                      row_bucket: int = 0, device=None,
                      timings: Optional[Dict[str, float]] = None):
        """Expanded design matrix built ON DEVICE from compact columns.

        Semantically identical to fit_transform/transform (same one-hot
        layout, imputation, standardization — the stats are derived
        analytically from the codes), but the host→device transfer is the
        compact representation (numeric columns at 1, 2 or 4 bytes and
        categorical int32 codes, ~P_cat× smaller than the dense one-hot),
        and `expand_design` expands it on the device. With `row_bucket` the
        rows pad to its multiple; the pad rows expand to values the CALLER
        slices off on the host or weighs 0.

        With a `cloud` of several ranks (a pod fit) the statistics are the
        global ones and every rank takes the same transfer group for each
        column (`design_packs`); the design is this rank's canonical slice
        of the global rows padded to `quota`. `timings`, when given,
        receives the host-clock split pack_s / h2d_s / expand_s (the device
        is synchronised at each mark)."""
        dev = devlib.resolve(device)
        t0 = time.perf_counter()
        packs = self.design_packs(frame, fit, cloud=cloud, quota=quota,
                                  row_bucket=row_bucket)
        if timings is not None:
            timings["pack_s"] = time.perf_counter() - t0
        return self.expand_packs(packs, add_intercept, dev, timings)

    def expand_packs(self, packs, add_intercept: bool, dev,
                     timings: Optional[Dict[str, float]] = None):
        """Upload `design_packs`' compact packs to `dev` and expand them
        there (`expand_design`)."""
        spec, arrays, m_h, s_h = packs
        t0 = time.perf_counter()
        up = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (*arrays, m_h, s_h)]
        if timings is not None:
            _sync(dev)
        t_h2d = time.perf_counter()
        X = expand_design(spec, self.use_all, m_h.size > 0, add_intercept,
                          *up)
        if timings is not None:
            _sync(dev)
            timings.update(h2d_s=t_h2d - t0,
                           expand_s=time.perf_counter() - t_h2d)
        return X

    def _pod_num_stats(self, mats: np.ndarray):
        """(means, stds, valid counts) of the numeric columns over every
        rank's rows: f64 global sums in two passes (the mean, then
        Σ(x − μ)² over the valid values), all columns in one gather each."""
        from ..parallel import distdata

        ok = ~np.isnan(mats)
        sums = distdata.global_sum(np.concatenate(
            [np.nansum(mats, axis=0), ok.sum(axis=0).astype(np.float64)]))
        k = mats.shape[1]
        cnt = sums[k:]
        with np.errstate(all="ignore"):
            mean = np.where(cnt > 0, sums[:k] / np.maximum(cnt, 1.0), 0.0)
        dev2 = distdata.global_sum(np.nansum((mats - mean) ** 2, axis=0))
        std = np.where(cnt > 0, np.sqrt(dev2 / np.maximum(cnt, 1.0)), 0.0)
        return mean, std, cnt.astype(np.int64)

    def design_packs(self, frame: Frame, fit: bool, cloud=None,
                     quota: Optional[int] = None, counts=None,
                     row_bucket: int = 0):
        """The host half of `device_design`: (spec, [uint8, int16, f32
        numeric packs, int32 categorical codes], means, stds), fitting the
        statistics when `fit`. On a pod (`cloud` of several ranks) the
        statistics, imputation means and transfer groups are global
        collectives and the packs are this rank's canonical slice of
        `quota` padded global rows (`counts`: the ranks' row counts)."""
        from ..parallel import distdata

        pod = cloud is not None and cloud.size > 1 and distdata.multiprocess()
        n = frame.nrow
        n_stats = n
        nums, cats = [], []
        means, stds = [], []
        # wide-numeric fast pre-pass: per-column nanmean/nanstd/isnan calls
        # cost ~2 s of host time at MNIST width (784 × 60k); batching them
        # as axis-0 reductions over one stacked matrix is ~10× cheaper and
        # numerically identical. A pod takes every numeric column this way,
        # its statistics global.
        _num_cols = [nm for k, nm, _ in self._spec if k == "num"]
        _pre = {}
        if pod or len(_num_cols) > 8:
            mat = (np.stack([frame.vec(nm).numeric_np() for nm in _num_cols],
                            axis=1) if _num_cols else np.zeros((n, 0)))
            nan_mask = np.isnan(mat)
            has_nan_vec = nan_mask.any(axis=0)
            if fit and pod:
                if counts is None:
                    counts = distdata.row_counts(n)
                n_stats = int(np.sum(counts))
                mvec, svec, nvalid = self._pod_num_stats(
                    mat.astype(np.float64))
                has_nan_vec = nvalid < n_stats
            elif fit:
                has_valid = ~nan_mask.all(axis=0)
                with np.errstate(all="ignore"):
                    mvec = np.where(has_valid, np.nanmean(mat, axis=0), 0.0)
                    svec = np.where(has_valid, np.nanstd(mat, axis=0), 0.0)
                nvalid = (~nan_mask).sum(axis=0)
            if fit:
                # isfinite-else-0.0, matching the narrow per-column path:
                # nan_to_num would map an infinite column mean to ±1.8e308
                # and diverge the standardization stats by frame width
                _pre = {nm: (mat[:, j], bool(has_nan_vec[j]),
                             float(mvec[j]) if np.isfinite(mvec[j]) else 0.0,
                             float(svec[j]) if np.isfinite(svec[j]) else 0.0,
                             int(nvalid[j]))
                        for j, nm in enumerate(_num_cols)}
            else:
                # scoring path: stats come from the stored fit-time values;
                # only the column data + NaN flags are needed
                _pre = {nm: (mat[:, j], bool(has_nan_vec[j]), 0.0, 0.0, 0)
                        for j, nm in enumerate(_num_cols)}
        cat_counts = None
        if fit and pod and self.standardize:
            # every categorical column's global level counts, one gather
            local = [np.bincount(c[c >= 0], minlength=len(d))[:len(d)]
                     for c, d in ((self._codes(frame, name, dom), dom)
                                  for kind, name, dom in self._spec
                                  if kind == "cat")]
            flat = distdata.global_sum(np.concatenate(
                [np.zeros(0, np.int64)] + [v.astype(np.int64)
                                           for v in local]))
            cat_counts = iter(np.split(flat, np.cumsum(
                [len(v) for v in local])[:-1]) if local else [])
        pos = 0  # expanded-column position (for stored-stat lookups)
        for kind, name, dom in self._spec:
            v = frame.vec(name)
            if kind == "num":
                if name in _pre:
                    c, has_nan, pre_m, pre_s, n_ok = _pre[name]
                else:
                    c = v.numeric_np()
                    has_nan = bool(np.isnan(c).any())
                    n_ok = int((~np.isnan(c)).sum()) if fit else 0
                    pre_m = pre_s = 0.0
                    if fit:
                        with np.errstate(all="ignore"):
                            pre_m = (float(np.nanmean(c)) if n_ok else 0.0)
                            pre_s = (float(np.nanstd(c)) if n_ok else 0.0)
                        pre_m = pre_m if np.isfinite(pre_m) else 0.0
                        pre_s = pre_s if np.isfinite(pre_s) else 0.0
                if self.impute_missing:
                    if fit:
                        self.col_means[name] = pre_m
                    if has_nan:
                        c = np.where(np.isnan(c),
                                     self.col_means.get(name, 0.0), c)
                        # post-impute plain std: mean-filling leaves the
                        # mean unchanged and shrinks the variance by the
                        # valid-row fraction (exactly, analytically)
                        pre_s = pre_s * float(np.sqrt(n_ok / max(n_stats,
                                                                 1)))
                if fit and self.standardize:
                    # stats over valid rows only (nanmean/nanstd), exactly
                    # like fit_transform. All-NaN columns get (0, 1) so
                    # they standardize to the zeros fit_transform's
                    # trailing nan_to_num produces.
                    means.append([pre_m])
                    stds.append([pre_s if pre_s >= 1e-10 else 1.0])
                if not self.impute_missing and has_nan:
                    if self.standardize:
                        # fit_transform zeroes missing AFTER scaling, so the
                        # raw fill that standardizes to 0 is the column mean
                        mm = (means[-1][0] if fit
                              else float(self.means[pos])
                              if self.means is not None else 0.0)
                        c = np.where(np.isnan(c), mm, c)
                    else:
                        c = np.nan_to_num(c, nan=0.0)
                nums.append(c.astype(np.float32))
                pos += 1
            else:
                codes = self._codes(frame, name, dom)
                cats.append(codes.astype(np.int32))
                if fit and self.standardize:
                    K = len(dom)
                    cnt = (next(cat_counts) if cat_counts is not None else
                           np.bincount(codes[codes >= 0], minlength=K)[:K])
                    p_lvl = cnt / max(n_stats, 1)
                    lv = p_lvl if self.use_all else p_lvl[1:]
                    means.append(lv.tolist())
                    stds.append([float(s) if (s := np.sqrt(pl * (1 - pl))) >= 1e-10
                                 else 1.0 for pl in lv])
                pos += len(dom) if self.use_all else max(len(dom) - 1, 0)
        if fit and self.standardize:
            self.means = np.asarray(
                [m for grp in means for m in grp], np.float64)
            self.stds = np.asarray(
                [s for grp in stds for s in grp], np.float64)

        cats_a = (np.stack(cats, axis=1) if cats
                  else np.zeros((n, 0), np.int32))

        # per-column transfer dtype: integer-valued small-range columns
        # ship as 1–2 bytes/value (LOSSLESS — C1Chunk/C2Chunk parity);
        # everything else as f32. The layout is FROZEN at fit: a scoring
        # frame keeps the stored groups when its values still fit them,
        # and falls back to all-f32 otherwise, as the reference does.
        def _fits_group(c, g):
            if g == 2:
                return True
            if not c.size:
                # a pod rank with no rows votes for the narrowest group
                return pod
            with np.errstate(invalid="ignore"):
                if not bool(np.all(np.mod(c, 1.0) == 0.0)):
                    return False
            lo, hi = (0.0, 255.0) if g == 0 else (-32768.0, 32767.0)
            return bool(lo <= c.min() and c.max() <= hi)

        if fit:
            num_group = [0 if _fits_group(c, 0) else 1 if _fits_group(c, 1)
                         else 2 for c in nums]
            if pod and nums:
                # the reference's multi-process decision: each column takes
                # the widest group any rank needs, the same on every rank
                num_group = [int(g) for g in distdata.allgather_host(
                    np.asarray(num_group, np.int32)).max(axis=0)]
            self._transfer_groups = list(num_group)
        else:
            stored = getattr(self, "_transfer_groups", None)
            ok = bool(stored is not None and len(stored) == len(nums) and all(
                _fits_group(c, g) for c, g in zip(nums, stored)))
            num_group = stored if ok else [2] * len(nums)
        groups = ([], [], [])                 # uint8, int16, f32
        for c, g in zip(nums, num_group):
            groups[g].append(c)
        dts = (np.uint8, np.int16, np.float32)
        arrays = [
            (np.stack(g, axis=1).astype(dt) if g
             else np.zeros((n, 0), dt))
            for g, dt in zip(groups, dts)
        ] + [cats_a]
        if pod:
            # this rank's canonical slice of the padded global rows: the
            # pad (zero packs, code 0) sits at the global tail
            if counts is None:
                counts = distdata.row_counts(n)
            npad = int(quota) if quota is not None else \
                -(-int(np.sum(counts)) // cloud.size) * cloud.size
            arrays = [distdata.to_canonical(a, npad, counts=counts)
                      for a in arrays]
        elif row_bucket:
            # quantize the row dimension: nearby scoring frame sizes share
            # one shape; the zero-filled pad rows expand to garbage the
            # CALLER slices off (or weighs 0)
            npad_b = -(-n // row_bucket) * row_bucket
            if npad_b != n:
                arrays = [np.concatenate(
                    [a, np.zeros((npad_b - n,) + a.shape[1:], a.dtype)])
                    for a in arrays]
        gi = iter(num_group)
        spec = tuple((k, next(gi) if k == "num" else (len(d) if d else 0))
                     for k, _, d in self._spec)
        standardized = self.standardize and self.means is not None
        m_h = (np.asarray(self.means, np.float32) if standardized
               else np.zeros(0, np.float32))
        s_h = (np.asarray(self.stds, np.float32) if standardized
               else np.ones(0, np.float32))
        return spec, arrays, m_h, s_h

    @staticmethod
    def _codes(frame: Frame, name: str, dom) -> np.ndarray:
        """A categorical column's codes in the fitted domain `dom` (−1 for
        NA or an unseen level)."""
        v = frame.vec(name)
        codes = np.asarray(v.data)
        if v.domain != dom and v.domain:
            remap = np.asarray(
                [dom.index(d) if d in dom else -1 for d in v.domain],
                np.int64)
            codes = np.where(codes >= 0, remap[np.maximum(codes, 0)], -1)
        return codes

    def _expand(self, frame: Frame, fit: bool) -> np.ndarray:
        from ..parallel import distdata

        pod = distdata.multiprocess()
        num = [n for kind, n, _ in self._spec if kind == "num"]
        if fit and self.impute_missing and pod and num:
            # the global imputation means, every numeric column's in one
            # gather: a rank's own mean would bake different values into
            # each rank's design (and into the model's col_means)
            sc = distdata.global_sum(np.asarray(
                [[np.nansum(c), float((~np.isnan(c)).sum())]
                 for c in (frame.vec(n).numeric_np() for n in num)],
                np.float64))
            for n, (total, count) in zip(num, sc):
                self.col_means[n] = float(total / max(count, 1.0))
        cols = []
        for kind, n, dom in self._spec:
            v = frame.vec(n)
            if kind == "num":
                c = v.numeric_np()
                if self.impute_missing:
                    if fit and not pod:
                        self.col_means[n] = float(np.nanmean(c))
                    c = np.where(np.isnan(c), self.col_means.get(n, 0.0), c)
                cols.append(c[:, None])
            else:
                codes = self._codes(frame, n, dom)
                K = len(dom)
                oh = np.zeros((len(codes), K))
                valid = codes >= 0
                oh[np.nonzero(valid)[0], codes[valid]] = 1.0
                if not self.use_all and K > 0:
                    oh = oh[:, 1:]
                cols.append(oh)
        return np.concatenate(cols, axis=1) if cols else np.zeros((frame.nrow, 0))


class H2OModel:
    """Trained-model half of `hex.Model` + the `h2o-py` ModelBase surface."""

    algo = "base"

    def __init__(self, params: "H2OEstimator"):
        self.parms = params
        user_id = params._parms.get("model_id") if params is not None else None
        self.model_id = user_id or f"{self.algo}_{next(_model_counter)}"
        self.training_metrics: Optional[ModelMetricsBase] = None
        self.validation_metrics: Optional[ModelMetricsBase] = None
        self.cross_validation_metrics: Optional[ModelMetricsBase] = None
        self.scoring_history: ScoringHistory = ScoringHistory()
        self.varimp_table = None
        self.run_time: float = 0.0
        self._cv_holdout_pred: Optional[np.ndarray] = None
        self.cross_validation_models: Optional[List] = None

    def _m(self, valid=False, xval=False):
        if xval and self.cross_validation_metrics:
            return self.cross_validation_metrics
        if valid and self.validation_metrics:
            return self.validation_metrics
        return self.training_metrics

    def auc(self, valid=False, xval=False):
        return getattr(self._m(valid, xval), "auc", float("nan"))

    def logloss(self, valid=False, xval=False):
        return getattr(self._m(valid, xval), "logloss", float("nan"))

    def rmse(self, valid=False, xval=False):
        return self._m(valid, xval).rmse

    def mse(self, valid=False, xval=False):
        return self._m(valid, xval).mse

    def mean_per_class_error(self, valid=False, xval=False):
        return getattr(self._m(valid, xval), "mean_per_class_error", float("nan"))

    def varimp(self, use_pandas=False):
        return self.varimp_table

    def summary(self):
        """Model summary table (h2o-py ModelBase.summary) — generic form;
        concrete models override with their specifics."""
        return dict(model_id=self.model_id, algo=self.algo,
                    run_time_s=round(self.run_time, 3))

    def predict(self, test_data: Frame) -> Frame:
        raise NotImplementedError

    def model_performance(self, test_data: Optional[Frame] = None, **kw):
        if test_data is None:
            return self.training_metrics
        return self._make_metrics(test_data)

    def _make_metrics(self, frame: Frame):
        raise NotImplementedError


class H2OEstimator:
    """Parameter holder + builder (`hex.ModelBuilder` merged with the
    `h2o-py` estimator classes). Subclasses define `_param_defaults` and
    `_fit`; unknown kwargs raise like the reference's schema validation."""

    algo = "base"
    supervised = True  # class-level default; see _is_supervised()
    _param_defaults: Dict[str, Any] = {}
    _common_defaults: Dict[str, Any] = dict(
        model_id=None,
        seed=-1,
        max_runtime_secs=0.0,
        ignored_columns=None,
        ignore_const_cols=True,
        weights_column=None,
        offset_column=None,
        fold_column=None,
        nfolds=0,
        fold_assignment="AUTO",
        keep_cross_validation_predictions=False,
        keep_cross_validation_models=True,
        stopping_rounds=0,
        stopping_metric="AUTO",
        stopping_tolerance=0.001,
        score_each_iteration=False,
        checkpoint=None,
        device=None,      # the port's own: "cuda" (default) or "cpu"
    )

    # True where the estimator fits a pod (a cloud of several ranks) as one
    # global fit: the tree estimators, GLM, K-Means and PCA. Any other
    # raises on a pod before its first collective (`_pod_guard`).
    _pod_lane = False

    def __init__(self, **kwargs):
        self._parms: Dict[str, Any] = dict(self._common_defaults)
        self._parms.update(self._param_defaults)
        for k, v in kwargs.items():
            if k not in self._parms:
                raise TypeError(f"{type(self).__name__}: unknown parameter {k!r}")
            self._parms[k] = v
        self._model: Optional[H2OModel] = None
        self.job: Optional[Job] = None

    def __getattr__(self, name):
        parms = object.__getattribute__(self, "_parms")
        if name in parms:
            return parms[name]
        raise AttributeError(name)

    def _is_supervised(self) -> bool:
        """Instance-level supervision check — overridable where a parameter
        flips it (DeepLearning's autoencoder=True)."""
        return type(self).supervised

    def train(
        self,
        x: Optional[Sequence[str]] = None,
        y: Optional[str] = None,
        training_frame: Optional[Frame] = None,
        validation_frame: Optional[Frame] = None,
    ) -> "H2OEstimator":
        if training_frame is None:
            raise ValueError("training_frame is required")
        if self._is_supervised() and y is None:
            raise ValueError(f"{self.algo}: response column y is required")
        if self._parms.get("checkpoint") is not None:
            raise NotImplementedError(
                "checkpoint is not ported (ROADMAP queue A, item 5: "
                "checkpoints)")
        from ..parallel import mesh

        pod = mesh.cloud().size > 1
        if pod:
            self._pod_guard(y, training_frame)
        wc = self._parms.get("weights_column")
        if wc is not None and wc not in training_frame.names:
            raise ValueError(f"weights_column {wc!r} not in the training frame")
        fold_col = self._parms.get("fold_column")
        ignored = set(self._parms.get("ignored_columns") or [])
        if x is None:
            x = [n for n in training_frame.names
                 if n != y and n not in ignored
                 and n not in (wc, self._parms.get("offset_column"), fold_col)]
        else:
            x = [training_frame.names[i] if isinstance(i, int) else i for i in x]
            x = [n for n in x if n != y and n not in ignored]
        if self._parms.get("ignore_const_cols", True):
            # on a pod a column is constant over every rank's rows (a
            # rank's own rows may hold one value where the frame does not)
            x = (_pod_nonconst(training_frame, x) if pod else
                 [n for n in x if not _is_const(training_frame.vec(n))])
        if self._is_supervised() and y is not None:
            # rows with a missing response are dropped before training
            na = training_frame.vec(y).isna_np()
            if na.any():
                training_frame = training_frame.take(np.nonzero(~na)[0])
            if validation_frame is not None:
                nav = validation_frame.vec(y).isna_np()
                if nav.any():
                    validation_frame = validation_frame.take(
                        np.nonzero(~nav)[0])
        # a caller's job (the train pool's child job) rides through, so its
        # cancellation and watchdog reach the fit loop's safe points
        ext = getattr(self, "_external_job", None)
        self.job = ext if ext is not None else Job(
            dest=f"{self.algo}_{next(_job_counter)}",
            description=f"{self.algo} train")
        if self.job.status == "CREATED":
            self.job.start()
        t0 = time.time()
        seed = int(self._parms.get("seed", -1))
        self._parms["_actual_seed"] = 1234 if seed in (-1, None) else seed
        nfolds = int(self._parms.get("nfolds") or 0)
        if nfolds < 0 or nfolds == 1:
            raise ValueError(
                f"nfolds must be 0 (no CV) or >= 2, got {nfolds}")
        if fold_col and nfolds:
            raise ValueError(
                "specify EITHER nfolds OR fold_column, not both "
                "(hex/ModelBuilder cv_init)")
        if fold_col and fold_col not in training_frame.names:
            raise ValueError(f"fold_column {fold_col!r} not in frame")
        model = self._fit(x, y, training_frame, validation_frame)
        _phases.book_fit(getattr(model, "fit_timings", None))
        # a fold_column triggers CV by itself (its folds are the column's
        # distinct values), for estimators that can cross-validate
        supports_cv = type(self)._cv_predict is not H2OEstimator._cv_predict
        if ((nfolds >= 2 or (fold_col and supports_cv))
                and self._is_supervised()):
            self._run_cv(model, x, y, training_frame, nfolds)
        model.run_time = time.time() - t0
        self._model = model
        self.job.result = model.model_id
        self.job.done()
        return self

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> H2OModel:
        raise NotImplementedError

    def _pod_off_lane(self, y, train: Frame) -> Optional[str]:
        """What keeps this fit off its estimator's pod lane (the fits the
        reference runs off its lanes on a pod), or None."""
        return None

    def _pod_guard(self, y, train: Frame) -> None:
        """On a cloud of several ranks: raise, on every rank and before any
        collective, for an estimator without a pod lane and for a fit its
        lane does not take; then (one gather) for a frame with fewer rows
        than ranks. Without this each rank would fit its own rows alone."""
        from ..parallel import distdata, mesh

        name = type(self).__name__
        why = (self._pod_off_lane(y, train) if type(self)._pod_lane
               else "it has no multi-process lane")
        if why is None:
            size = mesh.cloud().size
            n = int(distdata.row_counts(train.nrow).sum())
            if n < size:
                why = f"a frame of {n} rows on {size} ranks"
        if why is not None:
            raise NotImplementedError(
                f"{name} on a multi-process cloud: {why} (ROADMAP queue A, "
                "item 9); each rank would fit its own rows alone")

    # -- n-fold CV (ModelBuilder.computeCrossValidation) --------------------
    def _run_cv(self, model: H2OModel, x, y, train: Frame, nfolds: int):
        """The reference's `_run_cv`: assign every row a fold, fit one model
        per fold on the other folds' rows and predict its own, then score
        the (n, …) f64 holdout. Every fold is counted in the train pool's
        CV fold counters (`trainpool.record_cv_fold`).

        On a pod (a cloud of several ranks) the folds are the one-process
        fit's: drawn once over the global row count in global ingest order,
        each rank taking its rows at its `distdata.row_offset`. Each fold
        fit is a pod fit of the fold's rows on the re-bin path (the folds
        of a pod never slice a parent's codes), each rank predicts its own
        holdout rows, and the fold and cross-validation metrics score the
        holdouts and responses gathered in rank order, so every rank
        reports the one-process metrics. (The reference draws its folds
        over each rank's own rows and scores its ranks' rows apart, ROADMAP
        §C.)"""
        from ..parallel import distdata

        pod = distdata.multiprocess()
        n = train.nrow
        n_all, off = n, 0
        if pod:
            counts = distdata.row_counts(n)
            n_all = int(counts.sum())
            off = int(counts[:distdata._rank()].sum())
        rng = np.random.default_rng(self._parms["_actual_seed"])
        fold_col = self._parms.get("fold_column")
        if fold_col:
            assign = train.vec(fold_col).numeric_np().astype(np.int64)
            folds = np.unique(distdata.allgather_rows(assign) if pod
                              else assign)
        else:
            mode = self._parms.get("fold_assignment", "AUTO")
            if mode in ("AUTO", "Random"):
                assign = rng.integers(0, nfolds, n_all)
            elif mode == "Modulo":
                assign = np.arange(n_all) % nfolds
            else:  # Stratified — approximate by per-class modulo
                yv = train.vec(y).numeric_np()
                if pod:
                    yv = distdata.allgather_rows(yv)
                order = np.argsort(yv, kind="mergesort")
                assign = np.empty(n_all, np.int64)
                assign[order] = np.arange(n_all) % nfolds
            assign = assign[off:off + n]
            folds = np.arange(nfolds)
        # Tree builders expose the parent fit's BinnedMatrix; the folds then
        # slice its codes by row instead of re-binning a copy of the frame.
        # The fold frame shrinks to the response and the *_column
        # parameters. H2O3_CV_REBIN=1 (and every pod) takes the per-fold
        # re-bin path, which is bit-exact with the reference's fold fits.
        reuse_bm = None
        if (os.environ.get("H2O3_CV_REBIN", "") in ("", "0") and not pod
                and self._cv_can_reuse()):
            reuse_bm = self._cv_reuse_source(model, train)
        keep_cols = [y] + sorted(
            v for k, v in self._parms.items()
            if k.endswith("_column") and isinstance(v, str)
            and v in train.names and v != y)
        yvec = train.vec(y)
        # a pod rank may hold no holdout rows of a fold
        trail = ((yvec.nlevels,) if yvec.type == "enum" and yvec.nlevels > 2
                 else ())

        holdout = None
        cv_models = []
        for f in folds:
            idx_tr = np.nonzero(assign != f)[0]
            idx_ho = np.nonzero(assign == f)[0]
            sub = type(self)()
            sub._parms.update(
                {k: v for k, v in self._parms.items() if not k.startswith("_")})
            sub._parms["nfolds"] = 0
            sub._parms["model_id"] = None  # fold models get their own ids
            sub._parms["_actual_seed"] = self._parms["_actual_seed"]
            _trainpool.record_cv_fold(reused=reuse_bm is not None)
            if reuse_bm is not None:
                # reuse folds take their natural row count, not the
                # parent's padded one
                tr = Frame({nm: train.vec(nm).take(idx_tr)
                            for nm in keep_cols})
                sub._parms["_cv_reuse"] = dict(bm=reuse_bm, rows=idx_tr)
                cvm = sub._fit(x, y, tr, None)
                _phases.book_fit(getattr(cvm, "fit_timings", None))
                pred = sub._cv_predict_codes(cvm, reuse_bm.codes[idx_ho])
            else:
                # re-bin folds pad to the parent's padded row count, as the
                # reference does, so their row draws are the reference's
                sub._parms["_npad_floor"] = getattr(model, "_npad", 0)
                tr = train.take(idx_tr)
                ho = train.take(idx_ho)
                cvm = sub._fit(x, y, tr, None)
                _phases.book_fit(getattr(cvm, "fit_timings", None))
                pred = (sub._cv_predict(cvm, ho) if ho.nrow
                        else np.zeros((0,) + trail))
            if holdout is None:
                holdout = np.zeros((n,) + pred.shape[1:], dtype=np.float64)
            holdout[assign == f] = pred
            if self._parms.get("keep_cross_validation_models", True):
                if pod:
                    # the fold's holdout over every rank, in rank order
                    cvm.validation_metrics = self._metrics_from_cv(
                        _gathered_vec(yvec.take(idx_ho)), None,
                        distdata.allgather_rows(
                            np.asarray(pred, np.float64)))
                elif reuse_bm is not None:
                    # fold validation metrics straight from the holdout
                    # prediction: the codes walk is the scoring path here
                    cvm.validation_metrics = self._metrics_from_cv(
                        yvec.take(idx_ho), None, pred)
                else:
                    cvm.validation_metrics = cvm._make_metrics(ho)
                cv_models.append(cvm)
        model._cv_holdout_pred = holdout
        model.cross_validation_models = cv_models or None
        model.cross_validation_metrics = (
            self._metrics_from_cv(_gathered_vec(yvec), None,
                                  distdata.allgather_rows(holdout))
            if pod else self._metrics_from_cv(yvec, assign, holdout))

    def _metrics_from_cv(self, yvec: Vec, assign, holdout):
        if yvec.type == "enum" and yvec.nlevels == 2:
            return ModelMetricsBinomial.make(
                np.asarray(yvec.data),
                holdout[:, -1] if holdout.ndim > 1 else holdout)
        if yvec.type == "enum":
            return ModelMetricsMultinomial.make(np.asarray(yvec.data), holdout)
        return ModelMetricsRegression.make(
            yvec.numeric_np(), holdout if holdout.ndim == 1 else holdout[:, 0])

    def _cv_predict(self, model: H2OModel, frame: Frame) -> np.ndarray:
        """Holdout prediction as probabilities (classif) or values (regr)."""
        raise NotImplementedError

    # -- CV fold-reuse hooks (overridden by builders that can slice a
    # parent-fit artifact per fold — see shared_tree.py) --------------------
    def _cv_can_reuse(self) -> bool:
        return False

    def _cv_reuse_source(self, model: H2OModel, train: Frame):
        return None

    def _cv_predict_codes(self, model: H2OModel, codes) -> np.ndarray:
        raise NotImplementedError

    @property
    def model_id(self):
        return self.model.model_id

    @property
    def model(self) -> H2OModel:
        if self._model is None:
            raise ValueError("model not trained; call train() first")
        return self._model

    def predict(self, test_data: Frame) -> Frame:
        return self.model.predict(test_data)

    def model_performance(self, test_data=None, valid=False, xval=False):
        if test_data is not None:
            return self.model.model_performance(test_data)
        return self.model._m(valid=valid, xval=xval)

    def auc(self, **kw):
        return self.model.auc(**kw)

    def logloss(self, **kw):
        return self.model.logloss(**kw)

    def rmse(self, **kw):
        return self.model.rmse(**kw)

    def varimp(self, **kw):
        return self.model.varimp(**kw)

    # model-understanding pass-throughs (h2o-py keeps these on the estimator)
    def predict_contributions(self, *a, **kw):
        return self.model.predict_contributions(*a, **kw)

    def predict_leaf_node_assignment(self, *a, **kw):
        return self.model.predict_leaf_node_assignment(*a, **kw)

    def staged_predict_proba(self, *a, **kw):
        return self.model.staged_predict_proba(*a, **kw)

    def feature_frequencies(self, *a, **kw):
        return self.model.feature_frequencies(*a, **kw)

    @property
    def scoring_history(self):
        return self.model.scoring_history


def check_unread(algo: str, item: Optional[str], p: dict,
                 unread: dict) -> None:
    """Raise for a parameter the reference's `algo` accepts and never
    reads, at any value other than its default (`unread`: name → default),
    naming the ROADMAP `item` that would port it, where one would."""
    for k, default in unread.items():
        if p.get(k, default) != default:
            where = f"{item}; ROADMAP §C" if item else "ROADMAP §C"
            raise NotImplementedError(
                f"{k}={p.get(k)!r}: the reference's {algo} accepts it and "
                f"never reads it, so only {default!r} is ported ({where})")


def warn_host_solver(algo: str, n_rows: int, bound: int = 500_000) -> None:
    """The reference's warning for its host-side numpy solvers (GLRM's SVD
    initialisation among them): correct at their usual scale, but a big
    frame gets a WARN line in the port's log rather than a silent slow
    fit."""
    if n_rows > bound:
        from ..runtime.log import Log

        Log.warn(
            f"{algo}: {n_rows} rows exceed the ~{bound} row envelope of "
            "this host-side (numpy) solver; expect host memory/time to "
            "scale accordingly (docs/architecture.md)")


def pod_check_frame(train: Frame, x, y) -> None:
    """Every rank must train on the same columns with the same types and
    domains (a parser's global domains; the port has no parser yet, ROADMAP
    queue A, item 11): a difference would give ranks different designs or
    bins and a hung collective, so it raises on every rank instead."""
    from ..parallel import distdata

    cols = list(x) + ([y] if y is not None else [])
    sig = repr([(c, train.vec(c).type, train.vec(c).domain)
                for c in cols]).encode()
    if len(set(distdata.allgather_bytes(sig))) != 1:
        raise ValueError(
            "the ranks of this cloud hold different training columns, "
            "types or categorical domains; every rank must see the same "
            "x, y and levels")


def _pod_nonconst(train: Frame, x) -> List[str]:
    """`x` less the columns constant over every rank's rows: `_is_const`
    of the global column, from one gather of each column's finite
    (min, max)."""
    from ..parallel import distdata

    lo, hi = [], []
    for n in x:
        v = train.vec(n)
        a = (v.numeric_np() if v.type != "string"
             else np.zeros(0))
        fin = a[~np.isnan(a)]
        lo.append(float(fin.min()) if fin.size and v.type != "string"
                  else np.inf)
        hi.append(float(fin.max()) if fin.size and v.type != "string"
                  else -np.inf)
    if not x:
        return []
    gmin, gmax = distdata.global_minmax(np.asarray(lo), np.asarray(hi))
    return [n for n, a, b in zip(x, gmin, gmax)
            if not (np.isfinite(a) and a == b)]


def _gathered_vec(v: Vec) -> Vec:
    """Every rank's rows of `v` in rank order (the global ingest order)."""
    from ..parallel import distdata

    return Vec(distdata.allgather_rows(np.asarray(v.data)), type=v.type,
               domain=v.domain)


def _is_const(v: Vec) -> bool:
    if v.type == "string":
        return False
    a = v.numeric_np()
    fin = a[~np.isnan(a)]
    return fin.size > 0 and float(fin.min()) == float(fin.max())


def response_info(yvec: Vec):
    """(problem_kind, nclass, domain) from the response Vec."""
    if yvec.type == "enum":
        k = yvec.nlevels
        if k < 2:
            raise ValueError(
                "categorical response has fewer than two classes "
                "(ModelBuilder rejects constant responses)")
        return ("binomial" if k == 2 else "multinomial"), k, yvec.domain
    return "regression", 1, None
