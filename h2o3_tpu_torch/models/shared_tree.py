"""SharedTree fit loop — GBM and DRF over `tree.build_tree`.

Port of the single-device, in-core fit of `h2o3_tpu/models/shared_tree.py`
(`_fit`, the per-iteration step `_one_tree` with `_grads`, row and column
sampling, the margin update, DRF out-of-bag sums, the compaction-overflow
rebuild, validation margins, scoring events and early stopping, training
and validation metrics, and `SharedTreeModel._margins` through the
forest-scoring kernel, and the memory-feasibility depth clamp with its
warning). Reference parity: `hex/tree/SharedTree.java`,
`hex/tree/gbm/GBM.java` and `hex/tree/drf/DRF.java`.

Each iteration m: the keys from `fold_in(seed key, m)` (`ops.prng`, the
reference's threefry draws) → the row and column samples → one tree per
class (K = the class count for multinomial, else 1), class k's key folded
from class k−1's: its gradients (GBM: from the margins, the softmax over
margins that classes < k already moved for multinomial; DRF: g = −y_k,
h = 1, so a leaf is its rows' mean response) → `tree.build_tree` →
margins[:, k] += leaf value per row. A DRF forest predicts the average of
its trees. Scoring events fall where the reference's chunked driver puts
them (`score_events`); with a validation frame its margins advance by one
`predict_codes` walk per new tree, and `ScoreKeeper` reads its metric.
PyTorch runs this eagerly; there is no per-iteration program to compile.

A GBM's `offset_column` adds the frame's offset to the margins it starts
from, scores and stops on (DRF rejects one, as the reference does). The
model's explanation outputs are `predict_contributions` (TreeSHAP,
`tree_shap.py`, the CUDA kernel `csrc/tree_shap.cu` on the card),
`predict_leaf_node_assignment`, `feature_frequencies` and
`staged_predict_proba`.

Cross-validation (`model_base._run_cv`) takes one of the reference's two
fold paths. By default a fold slices the parent fit's `BinnedMatrix` by
row (`_cv_reuse`: no `frame_to_matrix`, no `build_bins`) and scores its
holdout rows on those codes (`SharedTreeModel._margins_codes`, one
`tree.predict_codes` walk per tree, as the reference's jnp walk). Under
`H2O3_CV_REBIN=1` a fold re-bins its own rows, pads them to the parent's
padded row count (`_npad_floor`) and scores its holdout through the
forest kernel (`_cv_predict`).

Two hooks serve XGBoost (`models/xgboost.py`). A custom objective
(`self._objective_fn`, lambdarank's) starts the margins at 0 and gives
each round's (g, h) from the margins instead of the distribution. DART
(`tp["dart"]`, the reference's `:249-303` and its loop branches) drops
whole rounds: the dropped rounds' scaled leaf sums (one
`tree.predict_codes_packed` walk per class tree over the resident codes)
leave the margins before the gradients, the "tree" or "forest"
normalization rescales the new and the dropped rounds, and the per-round
scales are baked into the stored leaf values after the loop, so scoring,
MOJO and TreeSHAP see ordinary trees. Both run one round a scoring chunk,
as the reference does. XGBoost's `grow_policy="lossguide"` grows each tree
leaf-wise (`tree.build_tree_lossguide`, `max_leaves` slots, one B1 pass a
split on the card) into the same heap, on one device.

Every fit reads its training frame through the dataset cache
(`dataset_cache.py`): the f64 matrix, the `BinnedMatrix`, and the packed
code matrix on the device (or its `BlockStore`) are built once per
(frame, x) and reused by the next candidate, CV parent or grid point on
the same frame (``H2O3_DATASET_CACHE=0`` turns it off).

Two lanes change how a tree's rows reduce, both on one device:

- the blocks lane (``H2O3_TREE_SHARD=1``, S = ``H2O3_TREE_SHARD_BLOCKS``,
  default 8; `_shard_plan`) pads the rows to a multiple of 8·S and runs
  every histogram pass and the leaf totals as S ordered block partials
  (`build_tree(..., n_shard_blocks=S)`), and the scoring-event loss as S
  ordered block sums (`_event_loss`);
- the out-of-core lane (`_ooc_plan`: ``H2O3_TREE_OOC`` ``auto``, ``1`` or
  ``0``; ``H2O3_STREAM_BUDGET_MB``, ``H2O3_STREAM_BLOCKS``,
  ``H2O3_STREAM_HOST_BUDGET_MB``, ``H2O3_TREE_OOC_DISK``,
  ``H2O3_SPILL_DIR``) keeps the packed matrix in a `BlockStore` and builds
  each tree with `tree_stream.StreamedTreeStep`, which is the blocks lane
  over blocks uploaded one at a time: a streamed fit equals the blocks-lane
  fit that shares S bit for bit. It also runs GOSS (``goss=True``). A
  streamed fit keeps its stream counters in ``model._stream_stats``.

The reference's class and constraint parameters fit as it fits them:

- ``monotone_constraints`` ({column: ±1}, GBM) constrains the depth-wise
  split search (`tree.LevelRule`) and keeps every level dense;
- ``sample_rate_per_class`` compares each row's draw with its class's
  rate instead of ``sample_rate`` (and turns on DRF's out-of-bag metrics);
- ``balance_classes`` (with ``class_sampling_factors`` and
  ``max_after_balance_size``) scales the row weights by class, and the
  model's `_finish_probs` rescales its probabilities back to the prior
  class distribution (``balance_dists``);
- ``calibrate_model`` fits Platt scaling or isotonic regression of the
  ``calibration_frame``'s labels on its p1 (`Calibrator`, kept as data),
  and a binomial model's `predict` appends the ``cal_`` columns.

Not ported yet (ROADMAP queue A, items 5, 9 and 11): checkpoints, the
mesh lane over several devices and QoS. Asking for any of them raises
`NotImplementedError`.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import device as devlib
from ..frame.binning import BinnedMatrix, bin_apply, build_bins
from ..frame.frame import Frame
from ..ops import hist_cuda, packing, prng, score_cuda
from ..ops.histogram import ordered_axis_fold
from ..parallel import distdata
from ..parallel import mesh as cloudlib
from ..runtime.log import Log
from . import dataset_cache as _dsc
from . import distributions as dist_mod
from . import tree as treelib
from .metrics import (ModelMetricsBinomial, ModelMetricsMultinomial,
                      ModelMetricsRegression)
from .model_base import (SCORE_ROW_BUCKET, H2OEstimator, H2OModel,
                         ScoreKeeper, ScoringHistory, check_unread,
                         pod_check_frame, response_info)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def _histogram_budget(dev: torch.device) -> int:
    """Bytes the deepest level's histograms may take: half the card's
    memory (the reference's half of the device's byte limit), 8 GiB on the
    CPU."""
    if dev.type == "cuda":
        return torch.cuda.mem_get_info(dev)[1] // 2
    return 8 << 30


def _binom_binned_stats(margins: torch.Tensor, y: torch.Tensor, n: int,
                        nbins: int = 400):
    """AUC2-style 400-bin score histogram on the device (hex/AUC2.java):
    quantile edges, per-bin (pos, neg) counts and the logloss / squared
    error sums over the first `n` rows."""
    valid = torch.arange(margins.shape[0], device=margins.device) < n
    p = torch.sigmoid(margins)
    # the linear-interpolation quantiles of the n real rows, written out:
    # torch.nanquantile refuses inputs of more than 2^24 elements
    v = torch.sort(p[:n]).values
    pos = torch.linspace(0.0, 1.0, nbins, device=p.device, dtype=p.dtype) * (n - 1)
    lo = pos.to(torch.int64)
    qs = torch.lerp(v[lo], v[pos.ceil().to(torch.int64)], pos - lo)
    bins = torch.searchsorted(qs, p, side="left")
    vf = valid.to(torch.float32)
    npos = torch.zeros(nbins + 1, device=p.device).index_add_(0, bins, y * vf)
    nneg = torch.zeros(nbins + 1, device=p.device).index_add_(
        0, bins, (1.0 - y) * vf)
    pc = torch.clamp(p, 1e-15, 1 - 1e-15)
    zero = torch.zeros_like(pc)
    nll = -torch.sum(torch.where(valid & (y > 0.5), torch.log(pc), zero)
                     + torch.where(valid & (y <= 0.5), torch.log(1.0 - pc), zero))
    sq = torch.sum(torch.where(valid, (p - y) ** 2, zero))
    return qs, npos, nneg, nll, sq


_log = logging.getLogger(__name__)


def probs_from_margins(mode: str, problem: str, dist: str, m: np.ndarray,
                       ntrees: int) -> np.ndarray:
    """Host-side margins (N, K) → predictions. GBM: the link of the summed
    margins (softmax for multinomial, exp for the log-link families); DRF:
    the forest average of the per-leaf response means (vote averaging,
    `hex/tree/drf/DRFModel.score0`), clipped and normalised for
    multinomial, uniform where every class's votes are 0."""
    m = np.asarray(m)
    if mode == "drf":
        m = m * (1.0 / max(ntrees, 1))
        if problem == "binomial":
            p1 = np.clip(m[:, 0], 0.0, 1.0)
            return np.stack([1 - p1, p1], axis=1)
        if problem == "multinomial":
            p = np.clip(m, 0.0, None)
            s = p.sum(axis=1, keepdims=True)
            return np.where(s > 0, p / np.maximum(s, 1e-12), 1.0 / m.shape[1])
        return m[:, :1]
    if problem == "binomial":
        p1 = 1 / (1 + np.exp(-m[:, 0]))
        return np.stack([1 - p1, p1], axis=1)
    if problem == "multinomial":
        e = np.exp(m - m.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)
    if dist in ("poisson", "gamma", "tweedie"):
        return np.exp(m[:, :1])
    return m[:, :1]


def balance_weights(w: np.ndarray, codes_y: np.ndarray, nclass: int,
                    factors=None, max_after: float = 5.0, counts=None):
    """`balance_classes` as per-class row weights (the reference's
    `shared_tree.py:1716-1739`): the factors in f64 (`class_sampling_factors`,
    or n / (K · count) each class), capped so no class grows past
    `max_after` times n, then (w · factor[y]) rounded to f32. `counts` are
    the global class counts on a pod (the rows' own otherwise). Returns
    (weights, (prior distribution, model distribution))."""
    if counts is None:
        counts = np.bincount(codes_y, minlength=nclass).astype(np.float64)
    n_bal = float(counts.sum())
    if factors is not None:
        factors = np.asarray(factors, np.float64)
    else:
        factors = n_bal / (len(counts) * np.maximum(counts, 1.0))
    factors = np.minimum(factors, max_after * n_bal / np.maximum(counts, 1.0))
    model_w = counts * factors
    return ((w * factors[codes_y]).astype(np.float32),
            (counts / counts.sum(), model_w / model_w.sum()))


def class_row_rates(rates, codes_y: np.ndarray, nclass: int,
                    problem: str) -> np.ndarray:
    """`sample_rate_per_class` as each row's f32 sampling rate, its class's
    (rates[y]); a regression response or a vector that is not one rate a
    class raises, as in the reference."""
    if problem not in ("binomial", "multinomial"):
        raise ValueError("sample_rate_per_class requires a categorical "
                         "response (classification only)")
    rates_np = np.asarray(list(rates), np.float32)
    if len(rates_np) != nclass:
        raise ValueError(f"sample_rate_per_class needs {nclass} entries, "
                         f"got {len(rates_np)}")
    return rates_np[np.asarray(codes_y, np.int64)]


def _logit(p: np.ndarray) -> np.ndarray:
    return np.log(np.clip(p, 1e-12, 1 - 1e-12) / np.clip(1 - p, 1e-12, 1 - 1e-12))


class Calibrator:
    """`calibrate_model`'s map of a binomial model's p1, kept as data so the
    model pickles and carries across: Platt scaling's (a, b), p ↦ σ(a ·
    logit(p) + b), or isotonic regression's knots, p ↦ the knots' linear
    interpolation (`np.interp`)."""

    def __init__(self, method: str, a: float = 0.0, b: float = 0.0,
                 knots_x=None, knots_y=None):
        self.method = method
        self.a, self.b = float(a), float(b)
        self.knots_x = None if knots_x is None else np.asarray(knots_x, np.float64)
        self.knots_y = None if knots_y is None else np.asarray(knots_y, np.float64)

    def __call__(self, p: np.ndarray) -> np.ndarray:
        if self.method == "IsotonicRegression":
            return np.interp(p, self.knots_x, self.knots_y)
        return 1 / (1 + np.exp(-(self.a * _logit(p) + self.b)))

    @classmethod
    def fit(cls, method: str, p1: np.ndarray, y: np.ndarray) -> "Calibrator":
        """Platt scaling (``AUTO``, ``PlattScaling``): the 1-D logistic
        regression y ~ a · logit(p1) + b by at most 25 Newton steps from
        (0, 0), stopping at a step below 1e-10; or isotonic regression
        (``IsotonicRegression``): `isotonic.pav` of y on p1 with unit
        weights. The reference's `_fit_calibrator` arithmetic, in f64."""
        if method in ("AUTO", "PlattScaling"):
            X = np.column_stack([_logit(p1), np.ones_like(p1)])
            ab = np.zeros(2)
            for _ in range(25):
                mu = 1 / (1 + np.exp(-(X @ ab)))
                wd = np.clip(mu * (1 - mu), 1e-10, None)
                step = np.linalg.solve((X * wd[:, None]).T @ X + 1e-9 * np.eye(2),
                                       X.T @ (y - mu))
                ab = ab + step
                if np.max(np.abs(step)) < 1e-10:
                    break
            return cls("PlattScaling", a=ab[0], b=ab[1])
        if method == "IsotonicRegression":
            from .isotonic import pav

            tx, ty = pav(p1, y, np.ones_like(y))
            return cls(method, knots_x=tx, knots_y=ty)
        raise ValueError(f"unknown calibration_method {method!r}")


def _metrics_for(problem, yvec, probs):
    if problem == "binomial":
        return ModelMetricsBinomial.make(np.asarray(yvec.data), probs[:, 1])
    if problem == "multinomial":
        return ModelMetricsMultinomial.make(np.asarray(yvec.data), probs)
    return ModelMetricsRegression.make(yvec.numeric_np(), probs[:, 0])


def _response_matrix(yvec, problem: str, K: int) -> np.ndarray:
    """The response as (n, K) f32: one-hot over the K classes for
    multinomial, the class code (binomial) or the value (regression)
    otherwise."""
    if problem == "multinomial":
        yk = np.zeros((len(yvec.data), K), np.float32)
        yk[np.arange(len(yvec.data)), np.asarray(yvec.data)] = 1.0
        return yk
    return (yvec.numeric_np() if problem == "regression"
            else np.asarray(yvec.data)).astype(np.float32)[:, None]


_MESH_PSUM = ("the psum tree lane (\"mesh_psum\": lossguide growth, "
              "H2O3_TREE_LEGACY=1 or H2O3_TREE_SHARD=0 over several ranks) "
              "is not ported (ROADMAP queue A, item 9)")


def _shard_plan(tp, ndev: int = 1, multiproc: bool = False):
    """(shard_mode, n_shards) of one fit — the reference's `_shard_plan`,
    with one device a rank (`ndev` is the cloud's rank count).

    One rank: "off" by default and for lossguide growth,
    ``H2O3_TREE_LEGACY=1`` or ``H2O3_TREE_SHARD=0``; ``H2O3_TREE_SHARD=1``
    gives the blocks lane ("blocks", S = ``H2O3_TREE_SHARD_BLOCKS``,
    default 8), whose every row reduction is S ordered block partials, so
    two fits that share S agree bit for bit.

    Several ranks (a pod): the deterministic "mesh" lane with S =
    lcm(``H2O3_TREE_SHARD_BLOCKS``, ranks), each rank holding S/N whole
    blocks of the canonical row layout, so an N-rank fit is bit-identical
    to the one-rank blocks-lane fit that shares S. Where the reference
    falls back to its psum lane ("mesh_psum": lossguide growth,
    ``H2O3_TREE_LEGACY=1``, or ``H2O3_TREE_SHARD=0`` on a pod) the port
    raises. `multiproc` is the reference's argument; with one device a
    rank, several devices are always several processes."""
    import math

    env = os.environ.get("H2O3_TREE_SHARD", "").strip()
    legacy_lane = (os.environ.get("H2O3_TREE_LEGACY", "") == "1"
                   or tp.get("grow_policy", "depthwise") == "lossguide")
    if env == "0" or legacy_lane:
        if ndev > 1:
            raise NotImplementedError(_MESH_PSUM)
        return "off", 0
    base = max(int(os.environ.get("H2O3_TREE_SHARD_BLOCKS", "8") or 8), 1)
    if ndev > 1:
        return "mesh", base * ndev // math.gcd(base, ndev)
    if env == "1":
        return "blocks", base
    return "off", 0


def _pod_unported(est, tp) -> None:
    """The pod lane's raises: what the reference runs on a pod and the
    port does not yet, each naming its ROADMAP item."""
    item9 = "is not ported on a multi-process cloud (ROADMAP queue A, item 9)"
    if tp.get("dart"):
        raise NotImplementedError(f"DART {item9}")
    if getattr(est, "_objective_fn", None) is not None:
        raise NotImplementedError(f"a custom objective {item9}")


# every rank trains on the same columns, types and domains
_pod_check_frame = pod_check_frame


def _pod_bin_facts(X: np.ndarray, is_cat, nbins: int, histogram_type: str):
    """(col_ranges, col_quantile_edges) of a pod fit: the global min/max of
    every column (`global_minmax`) and, for QuantilesGlobal, each numeric
    column's global quantile edges (`global_quantiles`, `np.quantile` of
    the global column bit for bit), so every rank bins with the one-rank
    fit's edges."""
    with np.errstate(all="ignore"):
        lmin = np.nanmin(np.where(np.isnan(X), np.inf, X), axis=0) \
            if X.shape[0] else np.full(X.shape[1], np.inf)
        lmax = np.nanmax(np.where(np.isnan(X), -np.inf, X), axis=0) \
            if X.shape[0] else np.full(X.shape[1], -np.inf)
    gmin, gmax = distdata.global_minmax(lmin, lmax)
    col_ranges = np.stack([gmin, gmax], axis=1)
    col_qedges = None
    if histogram_type == "QuantilesGlobal":
        qs = np.linspace(0, 1, nbins)[1:-1]
        num = [j for j in range(X.shape[1]) if not is_cat[j]]
        edges = dict(zip(num, distdata.global_quantiles_columns(
            [X[:, j] for j in num], qs)))
        col_qedges = [np.unique(edges[j]) if j in edges else None
                      for j in range(X.shape[1])]
    return col_ranges, col_qedges


# torch's CPU elementwise loops run a tensor's last elements past a multiple
# of their SIMD step through scalar libm calls, whose exp and log can differ
# from the vector ones in the last bit. A pod rank's slice is a tensor of
# its own, so on the CPU its per-row exp/log run on rows padded to a
# multiple of _CPU_ALIGN: every real row then takes the vector path, as in
# the one-rank fit (whose npad, a multiple of 8·S, has no such tail). On the
# card every element is computed alike.
_CPU_ALIGN = 64


def _aligned_rows(fn, align: int, *ts):
    """fn(*ts) on per-row tensors, their rows padded with zeros to a
    multiple of `align` first (0: as they are) and every output cut back
    to the rows given."""
    n = ts[0].shape[0]
    m = -(-n // align) * align if align else n
    if m == n:
        return fn(*ts)
    out = fn(*[torch.cat([t, t.new_zeros((m - n,) + tuple(t.shape[1:]))])
               for t in ts])
    return tuple(o[:n] for o in out) if isinstance(out, tuple) else out[:n]


def _event_loss(margins: torch.Tensor, y: torch.Tensor, n: int,
                inv_ntrees: float, mode: str, problem: str,
                dist: str, n_blocks: int = 0,
                axis_name: Optional[str] = None,
                align: int = 0) -> torch.Tensor:
    """Mean loss of a scoring event over the first `n` rows, on the device
    in f32 (the reference's `_event_loss_terms`): logloss for binomial and
    multinomial, squared error of the prediction for regression. Clips are
    1e-7, as f32 needs. With `n_blocks` (the blocks and streamed lanes)
    the sums are per contiguous row block, folded in block order (the
    reference's `_sharded_event_loss_fn`), so the early-stop decisions of
    two fits that share the block grid agree bit for bit; with `axis_name`
    (a pod) the blocks are this rank's and the fold runs over every
    rank's. `align` as `_aligned_rows`'. Returns a 0-d tensor."""
    valid = (torch.arange(margins.shape[0], device=margins.device) < n)
    vf = valid.to(torch.float32)
    eps = 1e-7

    def terms(m, y):
        if mode == "drf":
            m = m * float(np.float32(inv_ntrees))
        if problem == "binomial":
            p1 = (m[:, 0].clamp(0.0, 1.0) if mode == "drf"
                  else 1 / (1 + torch.exp(-m[:, 0])))
            pc = p1.clamp(eps, 1 - eps)
            return -torch.where(y[:, 0] > 0.5, torch.log(pc),
                                torch.log1p(-pc))
        if problem == "multinomial":
            if mode == "drf":
                p = m.clamp(min=0.0)
                s = p.sum(dim=1, keepdim=True)
                probs = torch.where(s > 0, p / s.clamp(min=1e-12),
                                    torch.full_like(p, 1.0 / m.shape[1]))
            else:
                probs = dist_mod.softmax(m)
            return -torch.sum(torch.log(probs.clamp(eps, 1.0)) * y, dim=1)
        pred = m[:, 0]
        if mode != "drf" and dist in ("poisson", "gamma", "tweedie"):
            pred = torch.exp(pred)
        return (pred - y[:, 0]) ** 2

    num = _aligned_rows(terms, align, margins, y) * vf
    if n_blocks:
        rows = num.shape[0] // n_blocks
        tot = ordered_axis_fold(torch.stack([
            torch.stack([torch.sum(num[b * rows:(b + 1) * rows]),
                         torch.sum(vf[b * rows:(b + 1) * rows])])
            for b in range(n_blocks)]), axis_name)
        return tot[0] / tot[1].clamp(min=1e-12)
    return torch.sum(num) / torch.sum(vf).clamp(min=1e-12)


def _f32(v: float, dev: torch.device) -> torch.Tensor:
    """A 0-d f32 tensor of v rounded to f32, as the reference's
    `jnp.float32` coefficients."""
    return torch.tensor(np.float32(v), device=dev)


def _dart_norm(normalize_type: str, k_drop: int, lr: float):
    """(new round's scale, dropped rounds' factor) of a DART round that
    dropped `k_drop` rounds (xgboost dart.cc): "tree" gives 1/(k + lr) and
    k/(k + lr), "forest" 1/(1 + lr) for both; (1, 1) when none dropped."""
    if not k_drop:
        return 1.0, 1.0
    if normalize_type == "forest":
        return 1.0 / (1.0 + lr), 1.0 / (1.0 + lr)
    return 1.0 / (k_drop + lr), k_drop / (k_drop + lr)


def _dart_drop_sum(trees, drop_idx: Sequence[int], scales: Sequence[float],
                   codes: torch.Tensor, pack_bits: int,
                   max_depth: int) -> torch.Tensor:
    """(N, K) Σ over the dropped rounds of scale · leaf value, one codes
    walk per class tree (the reference's `_dart_drop_sum_jit`), the rounds
    added in order."""
    cols = []
    for tk in trees:
        acc = None
        for i in drop_idx:
            c = (treelib.predict_codes_packed(tk[i], codes, pack_bits, max_depth)
                 * _f32(scales[i], codes.device))
            acc = c if acc is None else acc + c
        cols.append(acc)
    return torch.stack(cols, dim=1)


def _event_record(problem: str, ntrees: int, val: float) -> Dict:
    """One scoring-history row from an event's mean loss."""
    ev: Dict = {"number_of_trees": ntrees, "timestamp": time.time()}
    if problem in ("binomial", "multinomial"):
        ev["logloss"] = val
        if problem == "binomial":
            ev["auc"] = float("nan")      # full AUC at final scoring
        ev["training_deviance"] = val
    else:
        ev["deviance"] = val
        ev["rmse"] = float(np.sqrt(val))
        ev["training_deviance"] = val
    return ev


def _host_event_loss(problem: str, dist: str, mode: str, m: np.ndarray,
                     y: np.ndarray, ntrees: int) -> float:
    """The same mean loss on the host in f64 (the reference's
    `_score_event` host path, which DRF's out-of-bag events take), clips
    1e-15."""
    probs = probs_from_margins(mode, problem, dist, m, ntrees)
    if problem == "binomial":
        p = np.clip(probs[:, 1], 1e-15, 1 - 1e-15)
        nll = -np.log(np.where(y[:, 0] > 0.5, p, 1 - p))
        return float(nll.sum() / max(len(nll), 1e-12))
    if problem == "multinomial":
        p = np.clip(probs, 1e-15, 1)
        nll = -np.log(p[y.astype(bool)])
        return float(nll.sum() / max(len(nll), 1e-12))
    sq = (probs[:, 0] - y[:, 0]) ** 2
    return float(sq.sum() / max(len(sq), 1e-12))


def chunk_boundaries(ntrees: int, score_tree_interval: int = 0,
                     stopping: bool = False,
                     one_per_chunk: bool = False) -> list:
    """The iteration counts that end the reference's chunks (`shared_tree.py`
    chunking): chunks of 1 tree under `score_each_iteration`, a custom
    objective or DART (`one_per_chunk`), else of `score_tree_interval`,
    else of min(10, ntrees) when a stopper runs, else of min(25, ntrees);
    the last chunk ends at ntrees."""
    if one_per_chunk:
        chunk = 1
    elif score_tree_interval:
        chunk = score_tree_interval
    elif stopping:
        chunk = max(1, min(10, ntrees))
    else:
        chunk = min(25, max(ntrees, 1))
    return sorted(set(range(chunk, ntrees + 1, chunk)) | {ntrees})


def score_events(ntrees: int, score_tree_interval: int = 0,
                 stopping: bool = False,
                 score_each_iteration: bool = False) -> list:
    """The iteration counts after which the fit scores (and may stop), as
    the reference's chunked driver places them (`shared_tree.py` chunking):
    the trees run in chunks of `score_tree_interval`, of min(10, ntrees)
    when only a stopper is set, of 1 under `score_each_iteration` (25
    otherwise, with no event); an event falls on a chunk boundary where the
    interval divides the count, or on every boundary when a stopper runs
    without an interval."""
    out = []
    for built in chunk_boundaries(ntrees, score_tree_interval, stopping,
                                  score_each_iteration):
        if ((score_tree_interval and built % score_tree_interval == 0)
                or score_each_iteration
                or (stopping and not score_tree_interval)):
            out.append(built)
    return out


def frame_to_matrix(frame: Frame, x: Sequence[str], expected_domains=None):
    """Frame → (X float64 with NaN NAs, is_categorical, domains). Enums stay
    integer codes; with `expected_domains` (the training domains) test-frame
    codes are remapped label → training code and unseen levels become NA
    (`hex/Model.adaptTestForTrain`)."""
    cols, cats, doms = [], [], []
    for i, n in enumerate(x):
        v = frame.vec(n)
        col = v.numeric_np()
        exp = expected_domains[i] if expected_domains is not None else None
        if v.type == "enum" and exp is not None and v.domain != exp:
            lookup = {lbl: j for j, lbl in enumerate(exp)}
            remap = np.asarray(
                [lookup.get(lbl, -1) for lbl in (v.domain or [])], np.float64)
            codes = np.asarray(v.data)
            col = np.where(codes >= 0,
                           remap[np.maximum(codes, 0)] if len(remap) else -1.0,
                           -1.0)
            col = np.where(col < 0, np.nan, col)
        cols.append(col)
        cats.append(v.type == "enum")
        doms.append(v.domain)
    return np.column_stack(cols), np.asarray(cats), doms


def padded_rows(X: np.ndarray, device: torch.device) -> torch.Tensor:
    """X as an f32 matrix on `device`, zero rows appended up to a multiple
    of SCORE_ROW_BUCKET (the forest scorers' row bucket; the caller slices
    them off)."""
    n = X.shape[0]
    Xp = np.zeros((_pad_to_multiple(max(n, 1), SCORE_ROW_BUCKET), X.shape[1]),
                  np.float32)
    Xp[:n] = X
    return torch.from_numpy(Xp).to(device)


class SharedTreeModel(H2OModel):
    algo = "sharedtree"
    # a balanced fit's (prior, model) class distributions, and a
    # calibrated binomial fit's `Calibrator`
    balance_dists = None
    calibrator = None

    def __init__(self, params, x, y, bm: BinnedMatrix, problem, nclass,
                 domain, distribution, f0, forest: List[treelib.Tree],
                 covers: Optional[List[torch.Tensor]], max_depth: int,
                 device: torch.device, mode: str = "gbm"):
        self.algo = getattr(params, "algo", self.algo)
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self.bm = bm
        self.problem = problem
        self.nclass = nclass
        self.domain = domain
        self.distribution = distribution
        self.f0 = f0                 # initial margin: a float, or (K,) for K > 1
        self.forest = list(forest)   # K class forests, each a stacked Tree
        self.covers = covers         # K (ntrees, T) Σ row weights per node
        self.max_depth = max_depth
        self.device = device
        self.mode = mode             # 'gbm' (summed margins) | 'drf' (averaged)
        self.ntrees_built = int(self.forest[0].feat.shape[0]) if self.forest else 0
        self.fit_timings: Dict[str, float] = {}

    def _matrix(self, frame: Frame) -> np.ndarray:
        X, _, _ = frame_to_matrix(frame, self.x, expected_domains=self.bm.domains)
        return X

    def _margins(self, X: np.ndarray) -> np.ndarray:
        """(N, K) f64 margins on a raw feature matrix, scored on the device
        the model was fit on: one forest-kernel call per class forest over
        that forest's score table on the card, the plain walk on the CPU,
        which builds no table (`score_cuda.forest_score`). Rows are padded
        with zeros to a multiple of SCORE_ROW_BUCKET, which are sliced off;
        GBM's initial margin is added in f64 on the host."""
        n = X.shape[0]
        Xd = padded_rows(X, self.device)
        outs = []
        for k, forest in enumerate(self.forest):
            pack = self._score_table(k, X.shape[1]) if Xd.is_cuda else None
            s = score_cuda.forest_score(forest, Xd, self.max_depth, pack=pack)
            f0k = self.f0 if np.ndim(self.f0) == 0 else self.f0[k]
            outs.append(s.cpu().numpy().astype(np.float64)[:n] + f0k)
        return np.column_stack(outs)

    def _margins_codes(self, codes: np.ndarray) -> np.ndarray:
        """(N, K) f64 margins on pre-binned codes (the CV fold-reuse holdout
        path): rows of the parent's `BinnedMatrix` walk each tree through
        `tree.predict_codes` on the model's device, the trees' leaf values
        summed in f32 as the reference's jnp walk does (its row bucketing
        serves XLA's compiled shapes, which eager torch does not have).
        16-bit codes walk as int16 (`packing.device_codes`)."""
        cd = torch.from_numpy(packing.device_codes(
            np.ascontiguousarray(codes))).to(self.device)
        outs = []
        for k, forest in enumerate(self.forest):
            s = torch.zeros(codes.shape[0], dtype=torch.float32,
                            device=self.device)
            for t in range(forest.feat.shape[0]):
                tree = treelib.Tree(*[getattr(forest, f)[t]
                                      for f in treelib.Tree._fields])
                s += treelib.predict_codes(tree, cd, self.max_depth)
            f0k = self.f0 if np.ndim(self.f0) == 0 else self.f0[k]
            outs.append(s.cpu().numpy().astype(np.float64) + f0k)
        return np.column_stack(outs)

    def _probs_from_codes(self, codes: np.ndarray) -> np.ndarray:
        return self._finish_probs(self._margins_codes(codes))

    def _score_table(self, k: int, n_feat: int) -> score_cuda.ScorePack:
        """Class k's packed score table (8 bytes a node), built at the first
        score on the card and kept while that forest and the feature count
        stay the same. The tables live in the model's `__dict__`, keyed by
        class, so the memory ledger counts them with the model."""
        cache = self.__dict__.setdefault("_score_tables", {})
        pack = cache.get(k)
        if pack is None or pack.forest is not self.forest[k] \
                or pack.n_feat != n_feat:
            pack = cache[k] = score_cuda.build_score_pack(self.forest[k], n_feat)
        return pack

    def _shap_bias(self, scale: float) -> float:
        """Class 0's TreeSHAP bias term at `scale` (`tree_shap.forest_bias`,
        computed where the forest lies), kept while that forest, its covers
        and the scale stay the same."""
        from .tree_shap import forest_bias

        hit = self.__dict__.get("_shap_bias_of")
        if hit is None or hit[0] is not self.forest[0] \
                or hit[1] is not self.covers[0] or hit[2] != scale:
            hit = self._shap_bias_of = (
                self.forest[0], self.covers[0], scale,
                forest_bias(self.forest[0], self.covers[0], scale))
        return hit[3]

    def _shap_plan(self, n_feat: int):
        """Class 0's TreeSHAP path plan for rows of `n_feat` features
        (`tree_shap.build_shap_plan`, built where the forest lies), built
        at the first explanation on the card and kept while that forest,
        its covers and the feature count stay the same. It lives in the
        model's `__dict__`, so the memory ledger counts it with the
        model."""
        from .tree_shap import build_shap_plan

        hit = self.__dict__.get("_shap_plan_of")
        if hit is None or hit[0] is not self.forest[0] \
                or hit[1] is not self.covers[0] or hit[2].n_feat != n_feat:
            hit = self._shap_plan_of = (
                self.forest[0], self.covers[0],
                build_shap_plan(self.forest[0], self.covers[0], n_feat))
        return hit[2]

    def _parm(self, name: str):
        """A training parameter; None for a model built from arrays."""
        return (getattr(self.parms, "_parms", None) or {}).get(name)

    def _offset_of(self, frame: Frame) -> Optional[np.ndarray]:
        """The frame's offset column (f64) where the model was trained with
        one and the frame has it, else None."""
        oc = self._parm("offset_column")
        if oc and oc in frame.names:
            return frame.vec(oc).numeric_np()
        return None

    def _score_probs(self, X: np.ndarray,
                     offset: Optional[np.ndarray] = None) -> np.ndarray:
        return self._finish_probs(self._margins(X), offset)

    def _finish_probs(self, m: np.ndarray,
                      offset: Optional[np.ndarray] = None) -> np.ndarray:
        """Predictions from the f64 margins, the offset added to them first
        (not for DRF, which never applies one). A balanced model's
        probabilities are rescaled to the prior class distribution
        (`hex.Model.correctProbabilities`): each class's column times its
        prior over its model share, rows renormalised, in f64."""
        if offset is not None and self.mode != "drf":
            m = m + offset[:, None]
        out = probs_from_margins(self.mode, self.problem, self.distribution,
                                 m, self.ntrees_built)
        if self.balance_dists is None \
                or self.problem not in ("binomial", "multinomial"):
            return out
        prior, modeld = (np.asarray(d) for d in self.balance_dists)
        out = out * (prior / np.maximum(modeld, 1e-12))[None, :]
        return out / np.maximum(out.sum(axis=1, keepdims=True), 1e-12)

    def predict(self, test_data: Frame) -> Frame:
        return self._predict_frame(self._score_probs(
            self._matrix(test_data), self._offset_of(test_data)))

    def predict_from_margins(self, m: np.ndarray) -> Frame:
        """`predict`'s frame from (N, K) f64 margins scored elsewhere (the
        serving failover's, from the model's artifact on the host): the
        prior correction and the `cal_` columns applied here, in numpy."""
        return self._predict_frame(self._finish_probs(m))

    def _predict_frame(self, out: np.ndarray) -> Frame:
        if self.problem in ("binomial", "multinomial"):
            lab = out.argmax(axis=1)
            d = {"predict": np.asarray(self.domain, dtype=object)[lab]}
            for i, cls in enumerate(self.domain):
                d[str(cls)] = out[:, i]
            if self.calibrator is not None and self.problem == "binomial":
                c1 = self.calibrator(out[:, 1])
                d[f"cal_{self.domain[0]}"] = 1.0 - c1
                d[f"cal_{self.domain[1]}"] = c1
            return Frame.from_dict(d, column_types={"predict": "enum"})
        return Frame.from_dict({"predict": out[:, 0]})

    def _make_metrics(self, frame: Frame):
        out = self._score_probs(self._matrix(frame), self._offset_of(frame))
        return _metrics_for(self.problem, frame.vec(self.y), out)

    def _rows_f64(self, frame: Frame) -> torch.Tensor:
        """The frame's raw feature rows as f64 on the model's device: the
        rows TreeSHAP, leaf assignment and feature frequencies route."""
        return torch.from_numpy(self._matrix(frame)).to(self.device)

    def predict_contributions(self, test_data: Frame, output_format="Original",
                              top_n=0, bottom_n=0, compare_abs=False) -> Frame:
        """Per-row SHAP feature contributions and BiasTerm (path-dependent
        TreeSHAP, `tree_shap.compute_contributions`: the CUDA kernel over
        the model's kept path plan on the card). Contributions are in the
        margin space (log-odds for GBM binomial, the response for
        regression, the probability for DRF binomial) and sum with
        BiasTerm to the raw prediction. Binomial and regression only, as in
        the reference."""
        if self.problem == "multinomial":
            raise ValueError(
                "predict_contributions is not supported for multinomial "
                "models (reference parity: hex/Model.scoreContributions)")
        if output_format not in ("Original", "Compact", "original", "compact"):
            raise ValueError("output_format must be 'Original' or 'Compact' "
                             "(they coincide here: enums stay integer-coded, "
                             "one column per input feature)")
        if self._parm("offset_column"):
            raise ValueError(
                "predict_contributions is not supported for models trained "
                "with an offset_column (reference parity)")
        if not self.covers:
            raise ValueError(
                "this model has no recorded node covers "
                "(trained before TreeSHAP support); retrain to enable "
                "predict_contributions")
        from .tree_shap import compute_contributions

        scale = 1.0 / max(self.ntrees_built, 1) if self.mode == "drf" else 1.0
        f0k = self.f0 if np.ndim(self.f0) == 0 else self.f0[0]
        X = self._rows_f64(test_data)
        contrib = compute_contributions(
            self.forest[0], self.covers[0], X, scale, f0k,
            self._shap_bias(scale),
            plan=self._shap_plan(X.shape[1]) if X.is_cuda else None
        ).cpu().numpy()
        if top_n or bottom_n:
            # top/bottom-N pairs per row: (feature, value) columns, ranked by
            # signed value (or |value| with compare_abs), BiasTerm excluded
            vals = contrib[:, :-1]
            keys = np.abs(vals) if compare_abs else vals
            order = np.argsort(-keys, axis=1, kind="stable")
            d = {}
            fn_arr = np.asarray(self.x, dtype=object)
            nf = len(self.x)
            tn = nf if top_n < 0 else min(top_n, nf)
            bn = nf if bottom_n < 0 else min(bottom_n, nf)
            for i in range(tn):
                sel = order[:, i]
                d[f"top_feature_{i + 1}"] = fn_arr[sel]
                d[f"top_value_{i + 1}"] = np.take_along_axis(
                    vals, sel[:, None], axis=1)[:, 0]
            for i in range(bn):
                sel = order[:, nf - 1 - i]
                d[f"bottom_feature_{i + 1}"] = fn_arr[sel]
                d[f"bottom_value_{i + 1}"] = np.take_along_axis(
                    vals, sel[:, None], axis=1)[:, 0]
            d["BiasTerm"] = contrib[:, -1]
            return Frame.from_dict(d)
        names = list(self.x) + ["BiasTerm"]
        return Frame.from_dict({n2: contrib[:, j] for j, n2 in enumerate(names)})

    def staged_predict_proba(self, test_data: Frame) -> Frame:
        """Class-1 probability after each successive tree (binomial GBM):
        the per-tree leaf values of one walk over f32 rows (`predict_raw`),
        their running sum and the sigmoid in f32 on the host, as the
        reference's numpy does."""
        if self.problem != "binomial" or self.mode == "drf":
            raise ValueError("staged_predict_proba supports binomial "
                             "boosting models only (reference parity)")
        if self._parm("offset_column") or self.balance_dists is not None:
            raise ValueError(
                "staged_predict_proba is not supported for models trained "
                "with offset_column or balance_classes (staged margins "
                "would disagree with predict())")
        X = torch.from_numpy(self._matrix(test_data).astype(np.float32)).to(
            self.device)
        per_tree = treelib.predict_raw(self.forest[0], X,
                                       self.max_depth).cpu().numpy()
        f0k = self.f0 if np.ndim(self.f0) == 0 else self.f0[0]
        margins = f0k + np.cumsum(per_tree, axis=0)
        probs = 1.0 / (1.0 + np.exp(-margins))
        return Frame.from_dict(
            {f"T{t + 1}": probs[t] for t in range(probs.shape[0])})

    def feature_frequencies(self, test_data: Frame) -> Frame:
        """Per row, how many times each feature decides the row's path,
        summed over all trees of every class forest (`h2o-py
        ModelBase.feature_frequencies`); one walk per class forest over all
        its trees at once, the counts binned on the device."""
        X = self._rows_f64(test_data)
        N, F = X.shape
        counts = torch.zeros(N * F, dtype=torch.int64, device=X.device)
        rows = torch.arange(N, device=X.device)[None, :] * F

        def visit(s, f, right):
            nonlocal counts
            counts += torch.bincount((rows + f)[s], minlength=N * F)

        for forest in self.forest:
            treelib.forest_leaves(forest, X, self.max_depth, visit)
        c = counts.view(N, F).cpu().numpy().astype(np.float64)
        return Frame.from_dict({n2: c[:, j] for j, n2 in enumerate(self.x)})

    def predict_leaf_node_assignment(self, test_data: Frame,
                                     type: str = "Path") -> Frame:
        """Leaf assignment per (tree, class): decision-path strings ("LRL…")
        or heap node ids (`Model.scoreLeafNodeAssignment`). The node ids
        come from one walk per class forest over all its trees at once on
        f64 rows; a heap id fixes its root path, so the strings follow on
        the host."""
        if type not in ("Path", "Node_ID"):
            raise ValueError("type must be 'Path' or 'Node_ID'")
        X = self._rows_f64(test_data)
        d, ctypes_ = {}, {}
        for k, forest in enumerate(self.forest):
            nodes = treelib.forest_leaves(forest, X,
                                          self.max_depth).cpu().numpy()
            for t in range(self.ntrees_built):
                col = f"T{t + 1}.C{k + 1}"
                if type == "Path":
                    d[col] = heap_paths(nodes[t])
                    ctypes_[col] = "enum"
                else:
                    d[col] = nodes[t].astype(np.float64)
        return Frame.from_dict(d, column_types=ctypes_ or None)


def heap_paths(nodes: np.ndarray) -> np.ndarray:
    """Object array of the root paths ("L"/"R" per step) of heap node ids:
    node n's path is n + 1 in binary after its leading 1, 0 for left (child
    2i + 1) and 1 for right (2i + 2)."""
    u, inv = np.unique(nodes, return_inverse=True)
    names = np.asarray(
        [format(int(n) + 1, "b")[1:].replace("0", "L").replace("1", "R")
         for n in u], dtype=object)
    return names[inv.reshape(-1)]


class H2OSharedTreeEstimator(H2OEstimator):
    """Common GBM/DRF estimator. Subclasses set `_mode` ('gbm' | 'drf')."""

    _mode = "gbm"
    _pod_lane = True
    # parameters the reference's tree estimators accept and never read
    _UNREAD = dict(binomial_double_trees=False)

    def _check_unread(self) -> None:
        check_unread(self.algo.upper(), None, self._parms, self._UNREAD)

    def _tree_params(self) -> Dict:
        p = self._parms
        self._check_unread()
        drf = self._mode == "drf"
        return dict(
            ntrees=int(p.get("ntrees", 50)),
            max_depth=int(p.get("max_depth", 20 if drf else 5)),
            min_rows=float(p.get("min_rows", 1.0 if drf else 10.0)),
            nbins=int(p.get("nbins", 20)),
            learn_rate=float(p.get("learn_rate", 0.1)),
            learn_rate_annealing=float(p.get("learn_rate_annealing", 1.0)),
            sample_rate=float(p.get("sample_rate", 0.632 if drf else 1.0)),
            col_sample_rate=float(p.get("col_sample_rate", 1.0)),
            col_sample_rate_per_tree=float(p.get("col_sample_rate_per_tree", 1.0)),
            min_split_improvement=float(p.get("min_split_improvement", 1e-5)),
            histogram_type=p.get("histogram_type", "AUTO"),
            hist_method=p.get("hist_method", "auto"),
            mtries=int(p.get("mtries", -1)) if "mtries" in p else 0,
            reg_lambda=(float(p["reg_lambda"]) if p.get("reg_lambda") is not None
                        else (0.0 if drf else 1.0)),
            reg_alpha=float(p.get("reg_alpha") or 0.0) if "reg_alpha" in p else 0.0,
            max_abs_leaf=float(p.get("max_abs_leafnode_pred") or np.inf),
            # gradient-based sampling: opt-in, on the streamed lane only.
            # `is None` (not `or`): an explicit 0.0 must reach the
            # validator's 0 < rate < 1 check
            goss=bool(p.get("goss", False)),
            goss_top_rate=float(0.2 if p.get("goss_top_rate") is None
                                else p["goss_top_rate"]),
            goss_other_rate=float(0.1 if p.get("goss_other_rate") is None
                                  else p["goss_other_rate"]),
            goss_start_tree=p.get("goss_start_tree"),
        )

    def _resolved_mtries(self, tp, F: int, problem: str) -> int:
        """DRF's per-split column-sample count (`hex/tree/drf/DRF.java`
        _mtry defaults); 0 for GBM."""
        if self._mode != "drf":
            return 0
        mtries = tp["mtries"]
        if mtries in (-1, 0):
            return (max(1, int(np.sqrt(F))) if problem != "regression"
                    else max(1, F // 3))
        if mtries == -2:
            return F
        if mtries > F:
            raise ValueError(
                f"mtries={mtries} exceeds the {F} usable feature columns")
        return mtries

    @staticmethod
    def _validate_tree_params(tp) -> None:
        """Value-range validation (hex.ModelBuilder.init / SharedTree
        checkParams)."""
        if tp["ntrees"] < 1:
            raise ValueError(f"ntrees must be >= 1, got {tp['ntrees']}")
        if tp["max_depth"] < 1:
            raise ValueError(f"max_depth must be >= 1, got {tp['max_depth']}")
        for k in ("learn_rate", "learn_rate_annealing", "sample_rate",
                  "col_sample_rate", "col_sample_rate_per_tree"):
            if not (0.0 < tp[k] <= 1.0):
                raise ValueError(f"{k} must be in (0, 1], got {tp[k]}")
        if tp["nbins"] < 2:
            raise ValueError(f"nbins must be >= 2, got {tp['nbins']}")
        if tp["min_rows"] <= 0:
            raise ValueError(f"min_rows must be > 0, got {tp['min_rows']}")
        if tp["min_split_improvement"] < 0:
            raise ValueError("min_split_improvement must be >= 0, got "
                             f"{tp['min_split_improvement']}")
        if tp["mtries"] not in (-2, -1, 0) and tp["mtries"] < 1:
            raise ValueError(f"mtries must be -2, -1, or >= 1, got {tp['mtries']}")
        if tp.get("goss"):
            a, b = tp["goss_top_rate"], tp["goss_other_rate"]
            if not (0.0 < a < 1.0 and 0.0 < b < 1.0 and a + b <= 1.0):
                raise ValueError(
                    "goss rates must satisfy 0 < goss_top_rate < 1, "
                    f"0 < goss_other_rate < 1, sum <= 1 (got {a}, {b})")
            st = tp.get("goss_start_tree")
            if st is not None and int(st) < 1:
                raise ValueError(
                    f"goss_start_tree must be >= 1, got {st} (the first "
                    "trees must train unsampled to seed the gradients)")

    def _ooc_plan(self, tp, npad: int, F: int, nbins: int, pack_bits: int,
                  n_shards: int, K: int, dev: torch.device):
        """(n_blocks, goss_cfg): the one out-of-core decision of a fit.
        ``H2O3_TREE_OOC=0`` never streams (a plain in-core fit), ``1``
        always streams, ``auto`` (the default) streams when the packed
        code matrix passes the stream budget (``H2O3_STREAM_BUDGET_MB``,
        default half the card's memory) or the host budget of the disk
        tier. S is a multiple of ``H2O3_TREE_SHARD_BLOCKS`` (and of a
        blocks-lane fit's own S) sized so a block is about a quarter of the
        budget; ``H2O3_STREAM_BLOCKS`` forces it. It is capped at npad / 8,
        so each block holds whole pack groups. Checkpoints, DART, custom
        objectives, lossguide growth, monotone constraints and more than
        256 bins train in-core; a GOSS request on such a fit warns and
        trains unsampled."""
        env = os.environ.get("H2O3_TREE_OOC", "auto").strip() or "auto"
        goss_cfg = None
        if tp.get("goss"):
            if self._mode != "gbm" or K != 1:
                raise ValueError(
                    "goss requires a GBM fit with a single margin "
                    "(binomial or regression response)")
            if tp["sample_rate"] < 1.0 \
                    or self._parms.get("sample_rate_per_class"):
                raise ValueError(
                    "goss replaces row sampling; keep sample_rate=1.0")
            start = tp.get("goss_start_tree")
            if start is None:
                start = max(1, int(tp["ntrees"]) // 10)
            goss_cfg = dict(top_rate=float(tp["goss_top_rate"]),
                            other_rate=float(tp["goss_other_rate"]),
                            start_tree=int(start))
        eligible = (env != "0"
                    and self._parms.get("checkpoint") is None
                    and not tp.get("dart")
                    and getattr(self, "_objective_fn", None) is None
                    and tp.get("grow_policy", "depthwise") != "lossguide"
                    and not self._parms.get("monotone_constraints")
                    and nbins <= 256)
        if not eligible:
            if goss_cfg is not None:
                Log.warn("goss: this fit is not eligible for the "
                         "out-of-core streamed path; training unsampled "
                         "in-core")
            return 0, None
        from . import block_store as _bs

        codes_bytes = npad * F * pack_bits // 8 if pack_bits else npad * F
        budget = _bs.stream_budget_bytes(dev)
        host_budget = _bs.stream_host_budget_bytes()
        over_host = host_budget > 0 and codes_bytes > host_budget
        if env != "1" and goss_cfg is None and codes_bytes <= budget \
                and not over_host:
            return 0, None
        base = max(int(os.environ.get("H2O3_TREE_SHARD_BLOCKS", "8") or 8),
                   1)
        if n_shards:
            # a blocks-lane fit keeps its grid a multiple of its S
            base = max(base, n_shards)
        forced = int(os.environ.get("H2O3_STREAM_BLOCKS", "0") or 0)
        if forced > 0:
            S = forced
        else:
            target = max(budget // 4, 1)
            needed = max(-(-codes_bytes // target), base)
            S = -(-needed // base) * base
        return max(min(S, max(npad // 8, 1)), 1), goss_cfg

    def _monotone_vector(self, x, train: Frame) -> Optional[np.ndarray]:
        """`monotone_constraints` ({column: ±1}) as an (F,) f32 vector
        aligned with x, or None; an unknown or categorical column raises,
        as in the reference."""
        mc = self._parms.get("monotone_constraints")
        if not mc:
            return None
        vec = np.zeros(len(x), np.float32)
        for cname, d in dict(mc).items():
            if cname not in x:
                raise ValueError(
                    f"monotone_constraints: unknown column {cname!r}")
            if train.vec(cname).type == "enum":
                raise ValueError(
                    f"monotone_constraints: {cname!r} is categorical — "
                    "constraints apply to numeric columns only")
            vec[list(x).index(cname)] = float(d)
        return vec

    def _fit_calibrator(self, model: SharedTreeModel, pod: bool) -> Calibrator:
        """The calibration frame's p1, scored exactly as `predict` scores
        it (offsets included), against its labels; the reference's errors
        for a model that is not binomial, no `calibration_frame` and an
        unknown method. A pod gathers every rank's (p1, y) in rank order
        first, so every rank fits the one-process map bit for bit (the
        reference's Platt branch sums per rank instead, ROADMAP §C)."""
        if model.problem != "binomial":
            raise ValueError("calibrate_model is only supported for "
                             "binomial models")
        calib = self._parms.get("calibration_frame")
        if calib is None:
            raise ValueError("calibrate_model=True requires calibration_frame")
        p1 = model._score_probs(model._matrix(calib),
                                model._offset_of(calib))[:, 1]
        ycal = np.asarray(calib.vec(model.y).data, np.float64)
        if pod:
            both = distdata.allgather_rows(np.column_stack([p1, ycal]))
            p1 = np.ascontiguousarray(both[:, 0])
            ycal = np.ascontiguousarray(both[:, 1])
        return Calibrator.fit(str(self._parms.get("calibration_method", "AUTO")),
                              p1, ycal)

    def _default_stopping_metric(self, problem: str) -> str:
        sm = self._parms.get("stopping_metric", "AUTO")
        if sm and sm != "AUTO":
            return sm.lower()
        return "logloss" if problem in ("binomial", "multinomial") else "deviance"

    # -- CV fold reuse (model_base._run_cv's default path) -------------------
    def _cv_can_reuse(self) -> bool:
        """Tree fits slice the parent's binned codes per fold unless a
        feature needs the fold's raw x columns or frame-path scoring:
        checkpoint continuation, monotone constraints and offset_column
        (per-fold validation metrics apply the holdout's offset through the
        frame scoring path)."""
        return (self._parms.get("checkpoint") is None
                and not self._parms.get("monotone_constraints")
                and not self._parms.get("offset_column"))

    def _cv_reuse_source(self, model, train: Frame):
        bm = getattr(model, "bm", None)
        if isinstance(bm, BinnedMatrix) and bm.codes is not None \
                and bm.codes.shape[0] == train.nrow:
            return bm
        return None

    @staticmethod
    def _holdout_columns(model: SharedTreeModel, out: np.ndarray) -> np.ndarray:
        """A holdout prediction: p1 for binomial, every class's probability
        for multinomial, the value for regression."""
        if model.problem == "binomial":
            return out[:, 1]
        if model.problem == "multinomial":
            return out
        return out[:, 0]

    def _cv_predict_codes(self, model: SharedTreeModel,
                          codes: np.ndarray) -> np.ndarray:
        """`_cv_predict` on pre-binned holdout codes (fold-reuse path)."""
        return self._holdout_columns(model, model._probs_from_codes(codes))

    def _cv_predict(self, model: SharedTreeModel, frame: Frame) -> np.ndarray:
        """Holdout prediction of a re-bin fold, through the forest kernel
        on the card (the offset is not applied, as in the reference)."""
        return self._holdout_columns(
            model, model._score_probs(model._matrix(frame)))

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> SharedTreeModel:
        tp = self._tree_params()
        self._validate_tree_params(tp)
        dev = devlib.resolve(self._parms.get("device"))
        seed = self._parms["_actual_seed"]
        yvec = train.vec(y)
        problem, nclass, domain = response_info(yvec)
        drf = self._mode == "drf"
        dist = dist_mod.infer_distribution(
            problem, self._parms.get("distribution", "AUTO"))
        if drf and problem == "regression":
            dist = "gaussian"      # DRF trees fit raw response means
        if dist not in dist_mod.FAMILIES:
            raise ValueError(f"unknown distribution {dist!r}")
        # the parameters that reach grad_hess (the reference's step config)
        dist_kw = dict(tweedie_power=float(self._parms.get("tweedie_power", 1.5)),
                       alpha=float(self._parms.get("quantile_alpha", 0.5)))
        obj_fn = getattr(self, "_objective_fn", None)
        dart = tp.get("dart")

        t0 = time.perf_counter()
        # a CV fold on the reuse path (model_base._run_cv) slices the parent
        # fit's BinnedMatrix by row; its frame holds only the response and
        # the *_column parameters
        cvr = self._parms.get("_cv_reuse")
        # the one sharding decision (the blocks lane, a pod's mesh lane or
        # none); a streamed fit below turns into a blocks-lane fit of its
        # own S
        multiproc = distdata.multiprocess()
        cloud = cloudlib.cloud()
        shard_mode, n_shards = _shard_plan(tp, cloud.size, multiproc)
        # a pod: this rank holds S/N whole blocks of the canonical row
        # layout, and every row reduction gathers all S partials over the
        # rows axis and folds them in rank order
        pod = multiproc and shard_mode == "mesh"
        if pod:
            _pod_unported(self, tp)
            _pod_check_frame(train, x, y)
        axis = cloudlib.ROWS_AXIS if pod else None
        local_blocks = n_shards // cloud.size if pod else n_shards
        align = _CPU_ALIGN if pod and dev.type == "cpu" else 0
        # the dataset cache serves the fit's matrix, bins and device codes;
        # a fold on the reuse path slices its parent's codes instead
        use_cache = cvr is None and _dsc.enabled()
        if cvr is not None:
            pbm, cv_rows = cvr["bm"], np.asarray(cvr["rows"])
            n, F = int(len(cv_rows)), int(pbm.codes.shape[1])
            nbins = int(pbm.nbins)
        else:
            if use_cache:
                X, is_cat, doms = _dsc.matrix(
                    train, x, lambda: frame_to_matrix(train, x))
            else:
                X, is_cat, doms = frame_to_matrix(train, x)
            n, F = X.shape
            max_card = int(max([len(d) for d, c in zip(doms, is_cat)
                                if c and d], default=0))
            nbins = max(tp["nbins"] + 1, min(max_card + 1, 1 << 10))
        # past 256 bins `build_bins` makes uint16 codes, which go to the
        # device as int16 (`packing.device_codes`); both histogram kernels
        # take them up to 1024 bins, the categorical cap above. Only a
        # user's nbins of 1024 or more passes it (the reference fits that)
        if nbins > hist_cuda.MAX_BINS:
            raise ValueError(
                f"{nbins} bins: the histogram kernels take at most "
                f"{hist_cuda.MAX_BINS}; set nbins below {hist_cuda.MAX_BINS} "
                "(ROADMAP queue B, item 1: more than 1024 bins)")
        # memory-feasibility depth clamp: the deepest level's histograms
        # take ~2^D·F·nbins·96 bytes; keep them under the histogram budget
        budget = _histogram_budget(dev)
        feas = tp["max_depth"]
        while feas > 4 and (1 << feas) * F * nbins * 96 > budget:
            feas -= 1
        if tp["max_depth"] > feas:
            Log.warn(
                f"max_depth={tp['max_depth']} clamped to {feas}: the "
                f"level-complete heap's deepest histograms (F={F}, "
                f"nbins={nbins}) would exceed the HBM budget "
                f"({budget >> 30} GiB)")
            tp["max_depth"] = feas

        col_ranges = col_qedges = layout = None
        if cvr is not None:
            # edges and domains are the parent's: the fold model scores
            # through the same quantization grid
            bm = BinnedMatrix(
                codes=pbm.codes[cv_rows], edges=pbm.edges, nbins=pbm.nbins,
                names=list(pbm.names), is_categorical=pbm.is_categorical,
                domains=list(pbm.domains))
        else:
            if pod:
                # global facts from collectives, run eagerly on every rank
                # before any cache build (a hit on one rank and a miss on
                # another never strands a rank inside a collective)
                col_ranges, col_qedges = _pod_bin_facts(
                    X, is_cat, nbins, tp["histogram_type"])
                counts = distdata.row_counts(n)
                layout = ("pod", cloud.size, cloud.self_idx, _dsc.digest(
                    col_ranges, col_qedges, counts))

            def _bins():
                return build_bins(X, nbins=nbins,
                                  histogram_type=tp["histogram_type"],
                                  names=list(x), is_categorical=is_cat,
                                  domains=doms, seed=seed,
                                  col_ranges=col_ranges,
                                  col_quantile_edges=col_qedges)

            bm = (_dsc.bins(train, x, nbins, tp["histogram_type"], seed,
                            _bins, layout=layout) if use_cache else _bins())
        t_bins = time.perf_counter()
        wc = self._parms.get("weights_column")
        w = (train.vec(wc).numeric_np() if wc else np.ones(n)).astype(np.float32)
        oc = self._parms.get("offset_column")
        offset = train.vec(oc).numeric_np().astype(np.float32) if oc else None
        if offset is not None and drf:
            # reference parity: DRF.init rejects offsets
            raise ValueError("offset_column is not supported for DRF")
        mono_vec = self._monotone_vector(x, train)
        balance_dists = None
        if self._parms.get("balance_classes") \
                and problem in ("binomial", "multinomial"):
            # the class counts are global on a pod, so every rank scales
            # its rows by the one-process factors
            codes_y = np.asarray(yvec.data)
            class_counts = (distdata.global_sum(np.bincount(
                codes_y, minlength=nclass).astype(np.float64))
                if pod else None)
            w, balance_dists = balance_weights(
                w, codes_y, nclass, self._parms.get("class_sampling_factors"),
                float(self._parms.get("max_after_balance_size", 5.0)),
                counts=class_counts)
        K = nclass if problem == "multinomial" else 1
        yk = _response_matrix(yvec, problem, K)
        # a pod gathers the response and weights (rank order is the global
        # ingest order), so f0 and DRF's out-of-bag events are the one-rank
        # host computations on the same vectors
        yk_g, w_g = ((distdata.allgather_rows(yk), distdata.allgather_rows(w))
                     if pod else (yk, w))
        if drf:
            f0 = np.zeros(K, np.float32)
        elif problem == "multinomial":
            # log of the weighted class priors
            pri = np.average(yk_g, axis=0, weights=w_g)
            f0 = np.log(np.clip(pri, 1e-10, 1.0)).astype(np.float32)
        elif obj_fn is not None:
            f0 = np.zeros(1, np.float32)   # custom objectives start at 0
        else:
            f0 = np.asarray([np.float32(dist_mod.init_margin(
                dist, yk_g[:, 0], w_g, alpha=dist_kw["alpha"]))])

        # rows padded to a multiple of 8 (every pack group divides 8), and
        # of 8·S on the blocks lane (each block whole pack groups), with
        # zero-weight rows, which contribute nothing. A re-bin CV fold pads
        # to the parent's padded row count (`_npad_floor`), as the
        # reference does: the row draws are taken at that count
        floor = int(self._parms.get("_npad_floor") or 0)
        # a pod pads the GLOBAL row count with the one-rank formula: the
        # same npad and block grid as the blocks-lane fit that shares S
        n_layout = int(counts.sum()) if pod else n

        def padded_rows(row_mult: int) -> int:
            npad = _pad_to_multiple(n_layout, row_mult)
            return floor if floor > npad and floor % row_mult == 0 else npad

        npad = padded_rows(max(8 * n_shards, 8))
        pack_bits = packing.pack_bits_for(nbins, npad)
        # out of core: the packed matrix lives in a BlockStore and each
        # tree streams its blocks; the fit is a blocks-lane fit of S blocks
        # (a pod decides on its own slice, and raises: not ported there)
        ooc_blocks, goss_cfg = self._ooc_plan(
            tp, npad // cloud.size if pod else npad, F, nbins, pack_bits,
            n_shards, K, dev)
        if ooc_blocks and pod:
            raise NotImplementedError(
                "the streamed out-of-core lane is not ported on a "
                "multi-process cloud (ROADMAP queue A, item 9)")
        if ooc_blocks:
            shard_mode, n_shards = "blocks", ooc_blocks
            local_blocks = n_shards
            npad = padded_rows(8 * n_shards)
            pack_bits = packing.pack_bits_for(nbins, npad)
        pad = npad - n
        # this rank's rows: all npad on one rank; on a pod its canonical
        # slice of `quota` rows, the first `n_real` of them real (the pad
        # sits at the global tail), starting at global row `row0`
        quota, n_real, row0 = npad, n, 0
        if pod:
            quota = npad // cloud.size
            n_real = int(distdata.canonical_counts(counts, npad)[
                cloud.self_idx])
            row0 = cloud.self_idx * quota

        def padr(a: np.ndarray, fill=0) -> np.ndarray:
            """Rows → this rank's padded layout: the canonical slice on a
            pod (a collective: every call site runs it eagerly, never in a
            cache build), else zero rows appended up to npad."""
            if pod:
                return distdata.to_canonical(a, npad, counts=counts,
                                             fill=fill)
            return np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])

        def unpadr(a: torch.Tensor) -> np.ndarray:
            """This rank's REAL rows in INGEST order, on the host (a pod
            pairs its canonical slice back with the local frame's
            response)."""
            a = a.cpu().numpy()
            if pod:
                return distdata.from_canonical(a, npad, counts)
            return a[:n]

        codes_rows = padr(bm.codes) if pod else None

        def codes_padded():
            if pod:
                return codes_rows
            return np.concatenate([bm.codes,
                                   np.zeros((pad, F), bm.codes.dtype)])

        store = None
        codes_d = None
        if ooc_blocks:
            from .block_store import BlockStore

            def build_store():
                return BlockStore.from_codes(
                    codes_padded(), n_blocks=ooc_blocks, pack_bits=pack_bits,
                    register=not use_cache, device=dev)

            store = (_dsc.blocked_codes(
                train, x, nbins, tp["histogram_type"], seed, npad,
                build_store, pack_bits, ooc_blocks, dev) if use_cache
                else build_store())
        else:
            def build_codes():
                # the resident matrix stays packed; each tree widens it once
                codes_p = codes_padded()
                return torch.from_numpy(
                    packing.pack_host(codes_p, pack_bits) if pack_bits
                    else packing.device_codes(codes_p)).to(dev)

            codes_d = (_dsc.device_codes(
                train, x, nbins, tp["histogram_type"], seed, npad,
                build_codes, pack_bits, dev, layout=layout) if use_cache
                else build_codes())
        y_d = torch.from_numpy(padr(yk)).to(dev)
        w_d = torch.from_numpy(padr(w)).to(dev)
        edges = np.full((F, nbins - 2), np.float32(np.inf), np.float32)
        for j, e in enumerate(bm.edges):
            edges[j, : min(len(e), nbins - 2)] = e[: nbins - 2]
        edges_d = torch.from_numpy(edges).to(dev)
        ones = torch.ones(F, dtype=torch.float32, device=dev)
        margins = torch.from_numpy(f0).to(dev)[None, :].repeat(quota, 1)
        if offset is not None:
            # training margins start at f0 + offset; f0 ignores the offset
            margins = margins + torch.from_numpy(padr(offset)).to(
                dev)[:, None]
        cap = tp["max_abs_leaf"] if np.isfinite(tp["max_abs_leaf"]) else 3.4e38
        # sampling: per-row rate, per-tree column product, DRF's per-split
        # mtries rate, each compared in f32 as the reference does. With
        # sample_rate_per_class each row's draw is compared with its
        # class's rate (pad rows: 0)
        srpc = self._parms.get("sample_rate_per_class")
        if srpc:
            row_rate = torch.from_numpy(padr(class_row_rates(
                srpc, np.asarray(yvec.data), nclass, problem))).to(dev)
        else:
            row_rate = torch.tensor(np.float32(tp["sample_rate"]), device=dev)
        row_sampled = tp["sample_rate"] < 1.0 or bool(srpc)
        oob = drf and row_sampled        # DRF training metrics are out-of-bag
        colp = tp["col_sample_rate"] * tp["col_sample_rate_per_tree"]
        col_rate = torch.tensor(np.float32(colp), device=dev)
        mtries = self._resolved_mtries(tp, F, problem)
        mtries_rate = float(np.float32(mtries / max(F, 1))) if mtries > 0 else None
        # deep trees run their wide levels in active-node compaction; a tree
        # whose live nodes overflow the cap is rebuilt with dense levels.
        # Custom objectives keep dense levels, as in the reference
        # XGBoost's leaf-wise growth (grow_policy="lossguide") builds each
        # tree with `build_tree_lossguide`, which never compacts
        lossguide = tp.get("grow_policy", "depthwise") == "lossguide"
        # the streamed level loop is dense only, so a streamed fit never
        # compacts; it equals the blocks-lane fit of its S up to depth 12.
        # Monotone bounds live per dense level node: no compaction either
        compact_cap = (max(2, int(os.environ.get("H2O3_COMPACT_CAP", 4096)) // 2 * 2)
                       if tp["max_depth"] > 12 and obj_fn is None
                       and not lossguide and not ooc_blocks
                       and mono_vec is None else 0)
        mono_d = (torch.from_numpy(mono_vec).to(dev)
                  if mono_vec is not None else None)
        lr = tp["learn_rate"] if not drf else 1.0
        if oob:
            oob_sum = torch.zeros((quota, K), dtype=torch.float32, device=dev)
            oob_cnt = torch.zeros(quota, dtype=torch.float32, device=dev)
        # validation margins, tracked per tree on the validation frame's
        # codes in the training bins (SharedTree's Score pass)
        if valid is not None:
            Xv, _, _ = frame_to_matrix(valid, x, expected_domains=bm.domains)
            codes_v = torch.from_numpy(
                packing.device_codes(bin_apply(bm, Xv))).to(dev)
            n_v = valid.nrow
            y_v = torch.from_numpy(_response_matrix(valid.vec(y), problem,
                                                    K)).to(dev)
            margins_v = torch.from_numpy(f0).to(dev)[None, :].repeat(n_v, 1)
            if oc and oc in valid.names:
                off_v = valid.vec(oc).numeric_np().astype(np.float32)
                margins_v = margins_v + torch.from_numpy(off_v).to(dev)[:, None]
        stop_rounds = int(self._parms.get("stopping_rounds") or 0)
        stopper = (ScoreKeeper(stop_rounds, self._default_stopping_metric(problem),
                               float(self._parms.get("stopping_tolerance", 1e-3)))
                   if stop_rounds > 0 else None)
        interval = int(self._parms.get("score_tree_interval") or 0)
        # a custom objective or DART runs one round a chunk in the
        # reference, so a stopper without an interval scores every round
        events = set(score_events(
            tp["ntrees"], interval, stopper is not None,
            bool(self._parms.get("score_each_iteration"))
            or ((obj_fn is not None or dart is not None)
                and stopper is not None and not interval)))
        key = prng.PRNGKey(seed & 0x7FFFFFFF)
        # DART: one scale per committed round on its stored leaf values, and
        # the reference's own generator for the dropout draws
        dart_scales: List[float] = []
        if dart is not None:
            dart_rng = np.random.default_rng((int(seed) + 7919) & 0x7FFFFFFF)
        # the reference dispatches the trees in chunks and takes its safe
        # points (job cancellation, progress, the max_runtime_secs check)
        # at each chunk's end: the port builds tree by tree and stops at the
        # same ends
        chunk_ends = set(chunk_boundaries(
            tp["ntrees"], interval, stopper is not None,
            bool(self._parms.get("score_each_iteration"))
            or obj_fn is not None or dart is not None))
        max_runtime = float(self._parms.get("max_runtime_secs") or 0)
        stream = stream0 = None
        if ooc_blocks:
            from .tree_stream import StreamedTreeStep

            stream = StreamedTreeStep(
                store, npad=npad, max_depth=tp["max_depth"], nbins=nbins,
                hist_method=tp["hist_method"], min_rows=tp["min_rows"],
                min_split_improvement=tp["min_split_improvement"],
                reg_lambda=tp["reg_lambda"], reg_alpha=tp["reg_alpha"],
                max_abs_leaf=cap, mtries_rate=mtries_rate, seed=seed,
                goss=goss_cfg)
            stream0 = dict(store.counters)
            store.peak_window_start()      # this fit's resident watermark
        loss_blocks = local_blocks if shard_mode in ("blocks", "mesh") else 0
        _sync(dev)
        t_up = time.perf_counter()
        t_budget = time.time()

        def chunk_end(built: int) -> bool:
            """The budget check and progress report at a chunk's end; True
            once the fit has run past max_runtime_secs."""
            if built not in chunk_ends:
                return False
            if max_runtime:
                # clock consensus on a pod: every rank takes the same
                # branch, or the next tree's gathers would hang
                over = time.time() - t_budget > max_runtime
                if distdata.global_any(over) if pod else over:
                    return True
            if self.job is not None:
                self.job.update(built / max(tp["ntrees"], 1))
            return False

        trees = [[] for _ in range(K)]
        covers = [[] for _ in range(K)]
        gains = torch.zeros(F, dtype=torch.float32, device=dev)
        history = []
        dense_rebuilds = 0
        score_s = 0.0
        for m in range(tp["ntrees"]):
            krow, kcol, ktree = prng.split(prng.fold_in(prng.fold_in(key, m), 0), 3)
            if row_sampled:
                # this rank's rows of the global (npad,) draw
                row_mask = (prng.uniform(krow, (quota,), dev, offset=row0)
                            < row_rate).to(torch.float32)
                wt = w_d * row_mask
            else:
                wt = w_d
            if colp < 1.0:
                fm = (prng.uniform(kcol, (F,), dev) < col_rate).to(torch.float32)
                fm[0] = torch.maximum(fm[0], 1 - fm.sum().clamp(0, 1))
            else:
                fm = ones
            scale = np.float32(np.float32(lr)
                               * np.power(np.float32(tp["learn_rate_annealing"]),
                                          np.float32(m)))
            drop_idx: List[int] = []
            if dart is not None and m > 0 \
                    and dart_rng.random() >= dart["skip_drop"]:
                mask = dart_rng.random(m) < dart["rate_drop"]
                if dart["one_drop"] and not mask.any():
                    mask[int(dart_rng.integers(0, m))] = True
                drop_idx = [int(i) for i in np.nonzero(mask)[0]]
            if drop_idx:
                # the dropped rounds leave the margins the gradients read
                dsum = _dart_drop_sum(trees, drop_idx, dart_scales, codes_d,
                                      pack_bits, tp["max_depth"])
                margins = margins - dsum
                if valid is not None:
                    dsum_v = _dart_drop_sum(trees, drop_idx, dart_scales,
                                            codes_v, 0, tp["max_depth"])
            ext = (obj_fn(margins[:, 0], y_d[:, 0]) if obj_fn is not None
                   else None)
            new, new_vals = [], []
            for k in range(K):
                # each class's key folds the previous class's key
                ktree = prng.fold_in(ktree, k)
                if ext is not None:
                    g, h = ext
                elif drf:
                    g, h = -y_d[:, k], torch.ones_like(y_d[:, k])
                elif problem == "multinomial":
                    # class k sees the margins classes < k already moved
                    p = _aligned_rows(dist_mod.softmax, align,
                                      margins)[:, k]
                    g, h = p - y_d[:, k], p * (1 - p)
                else:
                    g, h = _aligned_rows(
                        lambda m_, y_: dist_mod.grad_hess(dist, m_, y_,
                                                          **dist_kw),
                        align, margins[:, 0], y_d[:, 0])
                g, h = g.contiguous(), h.contiguous()

                def grow(cap_slots):
                    if lossguide:
                        return treelib.build_tree_lossguide(
                            codes_d, g, h, wt, fm, edges_d,
                            max_depth=tp["max_depth"], nbins=nbins,
                            max_leaves=tp["max_leaves"],
                            min_rows=tp["min_rows"],
                            min_split_improvement=tp["min_split_improvement"],
                            reg_lambda=tp["reg_lambda"],
                            reg_alpha=tp["reg_alpha"], max_abs_leaf=cap,
                            hist_method=tp["hist_method"], pack_bits=pack_bits)
                    return treelib.build_tree(
                        codes_d, g, h, wt, fm, edges_d,
                        max_depth=tp["max_depth"], nbins=nbins,
                        min_rows=tp["min_rows"],
                        min_split_improvement=tp["min_split_improvement"],
                        reg_lambda=tp["reg_lambda"],
                        reg_alpha=tp["reg_alpha"], max_abs_leaf=cap,
                        hist_method=tp["hist_method"], pack_bits=pack_bits,
                        n_shard_blocks=local_blocks,
                        mtries_rate=mtries_rate, key=ktree,
                        compact_cap=cap_slots, axis_name=axis,
                        monotone=mono_d)

                scale_d = torch.tensor(scale, device=dev)
                if stream is not None:
                    tr, leaf_vals, gain_f, cover = stream(
                        g, h, wt, fm, edges_d, ktree, m, scale_d)
                else:
                    out = grow(compact_cap)
                    if compact_cap and int(out[4]) > 0:
                        # exactness is never traded: the same tree (same
                        # keys), grown with dense levels
                        dense_rebuilds += 1
                        out = grow(0)
                    tr, leaf_idx, gain_f, cover = out[:4]
                    tr = tr._replace(value=tr.value * scale_d)
                    leaf_vals = treelib.value_at(tr.value, leaf_idx)
                margins[:, k] += leaf_vals
                if oob:
                    # out-of-bag: rows this tree did not sample take its vote
                    oob_sum[:, k] += leaf_vals * (1.0 - row_mask)
                trees[k].append(tr)
                covers[k].append(cover)
                gains = gains + gain_f
                new.append(tr)
                new_vals.append(leaf_vals)
            if oob:
                oob_cnt += 1.0 - row_mask
            if dart is not None:
                fn, fd = _dart_norm(dart["normalize_type"], len(drop_idx),
                                    tp["learn_rate"])
                if drop_idx:
                    # margins − dropped + new → + fn·new + fd·dropped
                    margins = (margins + _f32(fn - 1.0, dev)
                               * torch.stack(new_vals, dim=1)
                               + _f32(fd, dev) * dsum)
                    for i in drop_idx:
                        dart_scales[i] *= fd
                dart_scales.append(fn)
            built = m + 1
            if built in chunk_ends and self.job is not None and not pod:
                # one rank's cancellation would strand the others: a pod
                # takes none, as in the reference
                self.job.check_cancelled()
            if valid is None and built not in events:
                if chunk_end(built):
                    break
                continue
            _sync(dev)
            t_ev = time.perf_counter()
            if valid is not None:
                vals_v = [treelib.predict_codes(tr, codes_v, tp["max_depth"])
                          for tr in new]
                for k, v in enumerate(vals_v):
                    margins_v[:, k] += v
                if drop_idx:
                    # the validation margins never had the dropped rounds
                    # taken out
                    margins_v = (margins_v + _f32(fn - 1.0, dev)
                                 * torch.stack(vals_v, dim=1)
                                 + _f32(fd - 1.0, dev) * dsum_v)
            if built in events:
                if oob:
                    # DRF scores its out-of-bag votes, on the host in f64
                    # (a pod gathers every rank's real rows: rank order is
                    # the global row order)
                    rows = torch.cat([oob_sum[:n_real], oob_cnt[:n_real, None],
                                      margins[:n_real]], dim=1).cpu().numpy()
                    if pod:
                        rows = distdata.allgather_rows(rows)
                    rows = rows.astype(np.float64)
                    osum, ocnt, mnp = rows[:, :K], rows[:, K:K + 1], rows[:, K + 1:]
                    oob_mean = np.where(ocnt > 0, osum / np.maximum(ocnt, 1.0),
                                        mnp / built)
                    val = _host_event_loss(problem, dist, self._mode,
                                           oob_mean * built, yk_g, built)
                else:
                    val = float(_event_loss(margins, y_d, n_real, 1.0 / built,
                                            self._mode, problem, dist,
                                            n_blocks=loss_blocks,
                                            axis_name=axis, align=align))
                ev = _event_record(problem, built, val)
                if valid is not None:
                    # a pod's validation rows are each rank's own: their
                    # sums fold over the ranks in rank order (the same on
                    # every rank; not the one-rank sum's bits)
                    vval = float(_event_loss(
                        margins_v, y_v, n_v, 1.0 / built, self._mode,
                        problem, dist, n_blocks=1 if pod else 0,
                        axis_name=axis, align=align))
                    ev.update({f"validation_{k2}": v2 for k2, v2 in
                               _event_record(problem, built, vval).items()
                               if k2 not in ("number_of_trees", "timestamp")})
                history.append(ev)
            _sync(dev)
            score_s += time.perf_counter() - t_ev
            if built in events and stopper is not None:
                # the stopper watches the validation metric where there is one
                name = (f"validation_{stopper.metric}" if valid is not None
                        else stopper.metric)
                v = ev.get(name)
                if v is None:
                    v = ev.get("validation_training_deviance" if valid is not None
                               else "training_deviance", np.nan)
                stop = stopper.record(v)
                # every rank scored the same folded loss; the vote keeps
                # a rank from leaving the next tree's gathers alone
                if distdata.global_any(stop) if pod else stop:
                    break
            if chunk_end(built):
                break
        for i, s in enumerate(dart_scales):
            if s != 1.0:
                # bake the round's DART scale into its stored leaf values
                for k in range(K):
                    trees[k][i] = trees[k][i]._replace(
                        value=trees[k][i].value * _f32(s, dev))
        if dense_rebuilds:
            _log.warning(
                "%d of %d trees overflowed the compact-node cap %d and were "
                "rebuilt with dense levels", dense_rebuilds,
                K * len(trees[0]), compact_cap)
        forest = [treelib.Tree(*[torch.stack([getattr(t, f) for t in tk])
                                 for f in treelib.Tree._fields])
                  for tk in trees]
        _sync(dev)
        t_trees = time.perf_counter()
        model = SharedTreeModel(self, x, y, bm, problem, nclass, domain, dist,
                                f0.copy() if K > 1 else float(f0[0]), forest,
                                [torch.stack(c) for c in covers],
                                tp["max_depth"], dev, mode=self._mode)
        model.compact_cap = compact_cap
        model.dense_rebuilds = dense_rebuilds
        model.balance_dists = balance_dists
        if self._parms.get("calibrate_model"):
            model.calibrator = self._fit_calibrator(model, pod)
        # the kind of histogram pass each tree ran (the reference's fit plan)
        model.hist_plan = treelib.histogram_level_plan(
            tp["max_depth"], compact_cap, tp.get("grow_policy", "depthwise"))
        if dart is not None:
            model.dart_scales = dart_scales   # per round, baked into values
        model._npad = npad     # CV passes this to re-bin folds as _npad_floor
        if pod:
            # the pod the model was fit on: its blocks and this rank's
            model._pod = dict(ranks=cloud.size, rank=cloud.self_idx,
                              n_shards=n_shards, local_blocks=local_blocks,
                              npad=npad, quota=quota, rows=n_real)
        if stream is not None:
            # the fit's stream: blocks and bytes moved, resident peaks
            delta = {k2: store.counters[k2] - stream0[k2]
                     for k2 in store.counters}
            model._stream_stats = dict(
                blocks=int(ooc_blocks),
                blocks_uploaded=delta["uploaded"],
                blocks_evicted=delta["evicted"],
                blocks_reused=delta["reused"],
                streamed_bytes=delta["bytes_streamed"],
                bytes_per_tree=int(delta["bytes_streamed"]
                                   / max(len(trees[0]), 1)),
                resident_block_peak=int(store.peak_window_bytes()),
                spilled_blocks=delta["spilled"],
                restored_blocks=delta["restored"],
                spilled_bytes=delta["bytes_spilled"],
                restored_bytes=delta["bytes_restored"],
                disk_bytes=int(store.disk_bytes()),
                resident_host_peak=int(store.host_peak_window_bytes()),
                goss=bool(goss_cfg))
            if not use_cache:
                store.close()      # the fit owns a store the cache does not
        model.scoring_history = ScoringHistory(history)
        gain_total = gains.cpu().numpy().astype(np.float64)
        if gain_total.sum() > 0:
            order = np.argsort(-gain_total)
            model.varimp_table = [
                (list(x)[i], float(gain_total[i]),
                 float(gain_total[i] / gain_total.max()),
                 float(gain_total[i] / gain_total.sum()))
                for i in order]
        ntrees = model.ntrees_built
        # a pod's training metrics are this rank's own rows (as the
        # reference's): the global numbers live in the scoring history
        if problem == "binomial" and dist == "bernoulli" and not drf \
                and not pod:
            # the whole training-metric reduction runs on the device (AUC2
            # binned design): only the bin counts come back
            qs, npos, nneg, nll, sq = _binom_binned_stats(margins[:, 0],
                                                          y_d[:, 0], n)
            model.training_metrics = ModelMetricsBinomial.from_binned(
                qs.cpu().numpy(), npos.cpu().numpy(), nneg.cpu().numpy(),
                float(nll), float(sq))
        else:
            m_np = unpadr(margins).astype(np.float64)
            if oob:
                # DRF training metrics are out-of-bag: each row is scored
                # by the trees that did not sample it; rows every tree
                # sampled fall back to the in-bag forest average
                osum = unpadr(oob_sum).astype(np.float64)
                ocnt = unpadr(oob_cnt).astype(np.float64)[:, None]
                m_np = np.where(ocnt > 0, osum / np.maximum(ocnt, 1.0),
                                m_np / max(ntrees, 1)) * max(ntrees, 1)
            model.training_metrics = _metrics_for(
                problem, yvec, probs_from_margins(self._mode, problem, dist,
                                                  m_np, ntrees))
        if valid is not None:
            if drf:
                model.validation_metrics = model._make_metrics(valid)
            else:
                mv = margins_v.cpu().numpy().astype(np.float64)
                model.validation_metrics = _metrics_for(
                    problem, valid.vec(y),
                    probs_from_margins(self._mode, problem, dist, mv, ntrees))
        # host-clock split of the fit (the device is synchronised at each
        # mark): frame→matrix + binning, packing + upload, the boosting loop
        # less its scoring, the scoring events with the validation margin
        # walks, training and validation metrics
        model.fit_timings = dict(bins_s=t_bins - t0, upload_s=t_up - t_bins,
                                 trees_s=t_trees - t_up - score_s,
                                 score_s=score_s,
                                 metrics_s=time.perf_counter() - t_trees)
        return model
