"""H2OXGBoostEstimator — `tree_method=hist` on the shared-tree fit loop.

Port of `h2o3_tpu/models/xgboost.py` (reference parity:
`h2o-ext-xgboost/src/main/java/hex/tree/xgboost/`, `XGBoostModel.java`'s
parameter map; estimator surface `h2o-py/h2o/estimators/xgboost.py`). The
class maps XGBoost's parameter names onto the port's shared-tree fit loop
(`models/shared_tree.py`), so gbtree fits run the histogram kernel B1
(`csrc/hist.cu`) at every level, on 8-bit QuantilesGlobal codes at the
default `max_bins=256`. What it adds:

* xgboost's leaf regularization: `reg_lambda` shrinks the Newton step and
  `reg_alpha` soft-thresholds G, both inside `tree.build_tree`;
* `booster="dart"`: the fit loop's DART branches (dropout by round);
* `objective="rank:ndcg"` with a `group_column`: pairwise lambdarank
  gradients (`_make_lambdarank`, `_lambdarank_pass`), plain torch on the
  fit's device. Queries are sorted by size and cut into chunks, each
  padded to its own largest group with at most 2^27 pair elements; a
  query's arithmetic is the reference's, whose single padding to the
  largest group would cost Q·G² pair elements a round;
* `booster="gblinear"`: boosted coordinate descent on a linear model
  (`_gblinear_train`, two true-f32 matmuls a round), returned as a
  `GLMModel` under the xgboost algo;
* `grow_policy="lossguide"` with `max_leaves`: leaf-wise growth
  (`tree.build_tree_lossguide`), one B1 pass of L = 1 a split, under the
  reference's parameter checks (monotone constraints raise its
  `ValueError`).

The reference's multi-process row gathers for
ranking and its multi-device and multi-process gblinear lanes are item 9:
the port fits in one process on one device, where those gathers are the
identity and the one-device lane is the one that runs.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .glm import GLMModel, attach_linear_artifacts
from .metrics import ndcg_at_k
from .model_base import DataInfo, _sync, response_info
from .shared_tree import H2OSharedTreeEstimator

# at most this many (query, i, j) pair elements in one lambdarank chunk;
# a size-sorted chunk also stops where its largest group would pass
# PAD_GROWTH times its smallest (or PAD_FLOOR documents), which bounds
# the padding to about half the chunk's pairs
PAIR_CHUNK = 1 << 27
PAD_GROWTH, PAD_FLOOR = 1.25, 16


class _GBLinearModel(GLMModel):
    """gblinear's fitted model: a GLMModel (same scoring, coefficient
    tables, metrics and MOJO payload) under the xgboost algo."""

    algo = "xgboost"


class H2OXGBoostEstimator(H2OSharedTreeEstimator):
    algo = "xgboost"
    _mode = "gbm"
    _param_defaults = dict(
        ntrees=50,
        max_depth=6,
        min_rows=1.0,                 # = min_child_weight
        min_child_weight=1.0,
        learn_rate=0.3,               # = eta
        eta=None,
        sample_rate=1.0,              # = subsample
        subsample=None,
        col_sample_rate=1.0,          # = colsample_bylevel
        colsample_bylevel=None,
        col_sample_rate_per_tree=1.0,  # = colsample_bytree
        colsample_bytree=None,
        max_abs_leafnode_pred=0.0,
        max_delta_step=0.0,
        score_tree_interval=0,
        min_split_improvement=0.0,    # = gamma
        gamma=None,
        nthread=-1,
        max_bins=256,
        max_leaves=0,
        tree_method="auto",           # auto/exact/approx/hist → all hist
        grow_policy="depthwise",
        booster="gbtree",
        reg_lambda=1.0,
        reg_alpha=0.0,
        quiet_mode=True,
        distribution="AUTO",
        tweedie_power=1.5,
        normalize_type="tree",
        rate_drop=0.0,
        one_drop=False,
        skip_drop=0.0,
        dmatrix_type="auto",
        backend="auto",
        gpu_id=None,
        objective=None,               # e.g. "rank:ndcg" (+ group_column)
        group_column=None,
        ndcg_k=10,
    )

    def _tree_params(self):
        p = self._parms
        self._check_unread()

        def pick(a, b, default):
            va = p.get(a)
            return float(va) if va is not None else float(p.get(b, default) or default)

        return dict(
            ntrees=int(p.get("ntrees", 50)),
            max_depth=int(p.get("max_depth", 6)),
            # min_child_weight maps to the weight-count min_rows, as in the
            # reference (not xgboost's hessian sum)
            min_rows=pick("min_child_weight", "min_rows", 1.0),
            nbins=int(p.get("max_bins", 256)) - 1,  # +1 NA bin added downstream
            learn_rate=pick("eta", "learn_rate", 0.3),
            learn_rate_annealing=1.0,
            sample_rate=pick("subsample", "sample_rate", 1.0),
            col_sample_rate=pick("colsample_bylevel", "col_sample_rate", 1.0),
            col_sample_rate_per_tree=pick("colsample_bytree",
                                          "col_sample_rate_per_tree", 1.0),
            min_split_improvement=pick("gamma", "min_split_improvement", 0.0),
            histogram_type="QuantilesGlobal",  # xgboost hist = sketch quantiles
            hist_method="auto",
            mtries=0,
            reg_lambda=float(p.get("reg_lambda", 1.0)),
            reg_alpha=float(p.get("reg_alpha", 0.0)),
            grow_policy=str(p.get("grow_policy", "depthwise")),
            max_leaves=int(p.get("max_leaves", 0) or 0),
            # xgboost: 0 = no cap, for both knobs
            max_abs_leaf=min(
                float(p.get("max_abs_leafnode_pred", 0) or 0) or np.inf,
                float(p.get("max_delta_step", 0) or 0) or np.inf),
            # DART (xgboost dart.cc): a boosting ROUND drops as a whole
            dart=(dict(rate_drop=float(p.get("rate_drop", 0) or 0),
                       one_drop=bool(p.get("one_drop", False)),
                       skip_drop=float(p.get("skip_drop", 0) or 0),
                       normalize_type=str(p.get("normalize_type", "tree")))
                  if str(p.get("booster", "gbtree")) == "dart" else None),
        )

    def _check_params(self):
        """The reference's checks (`XGBoostModel.java` createParamsMap
        honors or rejects these), each `ValueError` as written there."""
        p = self._parms
        booster = str(p.get("booster", "gbtree"))
        if booster not in ("gbtree", "dart", "gblinear"):
            raise ValueError(f"booster={booster!r}: expected 'gbtree', "
                             "'dart', or 'gblinear'")
        if booster == "gblinear":
            obj = p.get("objective")
            if obj and str(obj).startswith("rank"):
                raise ValueError(
                    f"objective={obj!r} is not supported with "
                    "booster='gblinear' (lambdarank needs trees)")
            dist = str(p.get("distribution", "AUTO"))
            if dist not in ("AUTO", "gaussian", "bernoulli", "multinomial"):
                raise ValueError(
                    f"distribution={dist!r} with booster='gblinear': only "
                    "AUTO/gaussian/bernoulli/multinomial links are "
                    "implemented for the linear booster")
        for k in ("rate_drop", "skip_drop"):
            v = float(p.get(k, 0) or 0)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{k}={v}: must be in [0, 1]")
            if v != 0.0 and booster != "dart":
                raise ValueError(f"{k} is a DART parameter; set "
                                 "booster='dart' to use it")
        if bool(p.get("one_drop", False)) and booster != "dart":
            raise ValueError("one_drop is a DART parameter; set "
                             "booster='dart' to use it")
        if str(p.get("normalize_type", "tree")) not in ("tree", "forest"):
            raise ValueError("normalize_type must be 'tree' or 'forest'")
        gp = str(p.get("grow_policy", "depthwise"))
        if gp not in ("depthwise", "lossguide"):
            raise ValueError(f"grow_policy={gp!r}: expected 'depthwise' or "
                             "'lossguide'")
        if gp == "lossguide":
            ml = int(p.get("max_leaves", 0) or 0)
            if ml == 1 or ml < 0:
                raise ValueError(f"max_leaves={ml}: a tree has at least 2 "
                                 "leaves (0 = bounded by max_depth only)")
            if int(p.get("max_depth", 6)) < 1:
                raise ValueError(
                    "grow_policy='lossguide' needs max_depth >= 1: the heap "
                    "tree layout is depth-capped (leaf-wise growth stops at "
                    "max_leaves OR max_depth, whichever binds first)")
            if p.get("monotone_constraints"):
                raise ValueError("monotone_constraints are not yet supported "
                                 "with grow_policy='lossguide'")
        elif int(p.get("max_leaves", 0) or 0) > 0:
            raise ValueError("max_leaves needs grow_policy='lossguide' "
                             "(depthwise growth is bounded by max_depth)")

    def _is_rank(self) -> bool:
        obj = self._parms.get("objective")
        return bool(obj) and str(obj).startswith("rank")

    def _pod_off_lane(self, y, train: Frame):
        """gblinear and the lambdarank objective have no pod lane (the
        reference fits both globally on a pod: ROADMAP queue A, item 9,
        parts 3 and 4); gbtree and DART reach the tree path's."""
        if str(self._parms.get("booster", "gbtree")) == "gblinear":
            return "booster='gblinear' has no multi-process lane"
        if self._is_rank():
            return (f"objective={self._parms.get('objective')!r} has no "
                    "multi-process lane")
        return None

    def _cv_can_reuse(self) -> bool:
        """gblinear folds fit a DataInfo design from the fold frame's raw x
        columns, and ranking folds rebuild lambdarank state (and NDCG) from
        the fold frame: both need full fold frames, not sliced codes."""
        if str(self._parms.get("booster", "gbtree")) == "gblinear":
            return False
        if self._is_rank():
            return False
        return super()._cv_can_reuse()

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]):
        self._check_params()
        if str(self._parms.get("booster", "gbtree")) == "gblinear":
            return self._fit_gblinear(x, y, train, valid)
        if not self._is_rank():
            return super()._fit(x, y, train, valid)
        obj = self._parms.get("objective")
        gcol = self._parms.get("group_column") or "qid"
        if gcol not in train.names:
            raise ValueError(
                f"objective={obj!r} needs group_column (qid); {gcol!r} not in frame"
            )
        k = int(self._parms.get("ndcg_k", 10))
        qid = train.vec(gcol).numeric_np().astype(np.int64)
        rel = train.vec(y).numeric_np().astype(np.float64)
        x = [n for n in x if n != gcol]
        dev = devlib.resolve(self._parms.get("device"))
        self._objective_fn = _make_lambdarank(qid, rel, k, dev)
        try:
            model = super()._fit(x, y, train, valid)
        finally:
            self._objective_fn = None
        # NDCG as the headline metric of a ranking model
        scores = model._margins(model._matrix(train))[:, 0]
        model.training_metrics.description = (
            f"NDCG@{k}={ndcg_at_k(rel, scores, qid, k):.5f}")
        return model

    def _fit_gblinear(self, x, y, train: Frame, valid: Optional[Frame]):
        """`booster="gblinear"`, xgboost's linear booster
        (`xgboost/src/linear/updater_shotgun.cc` CoordinateDelta). Each
        round is one Jacobi ("shotgun") pass: Xᵀg and (X∘X)ᵀh give every
        coordinate's gradient and hessian sums at the current margin, and
        the elastic-net delta (reg_lambda L2, reg_alpha soft threshold) is
        applied to every weight at once, damped by eta. The design is the
        port's device design without standardization, intercept last."""
        p = self._parms
        yvec = train.vec(y)
        problem, nclass, domain = response_info(yvec)
        family = {"binomial": "binomial",
                  "multinomial": "multinomial"}.get(problem, "gaussian")
        dist = str(p.get("distribution", "AUTO"))
        if dist != "AUTO":
            # an explicitly requested link must MATCH the response type
            want = {"bernoulli": "binomial", "multinomial": "multinomial",
                    "gaussian": "gaussian"}[dist]
            if want != family:
                raise ValueError(
                    f"distribution={dist!r} is inconsistent with the "
                    f"response ({problem}, which implies {family}); drop "
                    "the distribution parameter or fix the response type")
        rounds = int(p.get("ntrees", 50))
        eta = float(p.get("eta") if p.get("eta") is not None
                    else p.get("learn_rate", 0.3) or 0.3)
        lam = float(p.get("reg_lambda", 1.0))
        alpha = float(p.get("reg_alpha", 0.0))
        dev = devlib.resolve(p.get("device"))

        t0 = time.perf_counter()
        n = train.nrow
        w = (train.vec(p["weights_column"]).numeric_np()
             if p.get("weights_column") else np.ones(n)).astype(np.float32)
        if family == "binomial":
            yarr = (np.asarray(yvec.data, np.float32)
                    if yvec.type == "enum"
                    else yvec.numeric_np().astype(np.float32))
        elif family == "multinomial":
            yarr = np.asarray(yvec.data, np.float32)
        else:
            yarr = yvec.numeric_np().astype(np.float32)
        dinfo = DataInfo(train, x, standardize=False)
        design_t = {}
        Xd = dinfo.device_design(train, fit=True, add_intercept=True,
                                 device=dev, timings=design_t)
        yd = torch.from_numpy(yarr).to(dev)
        wd = torch.from_numpy(w).to(dev)
        _sync(dev)
        t_design = time.perf_counter()
        K = nclass if family == "multinomial" else 1
        W = _gblinear_train(Xd, yd, wd, family=family, n_class=K,
                            rounds=rounds, eta=eta, lam=lam, alpha=alpha)
        W = W.cpu().numpy().astype(np.float64)
        t_rounds = time.perf_counter()
        beta = W if family == "multinomial" else W[0]
        model = _GBLinearModel(self, x, y, dinfo, family, beta, domain,
                               lambda_best=lam, device=dev)
        attach_linear_artifacts(model, train, valid, Xd, n)
        t_end = time.perf_counter()
        # host-clock split: the design's host pack, upload and expansion,
        # the boosting rounds (β read back at their end), the metrics
        model.fit_timings = dict(design_t, rounds_s=t_rounds - t_design,
                                 metrics_s=t_end - t_rounds,
                                 total_s=t_end - t0)
        return model

    def _cv_predict(self, model, frame: Frame) -> np.ndarray:
        if isinstance(model, GLMModel):  # gblinear fold models
            return model._score(frame)
        return super()._cv_predict(model, frame)

    def ndcg(self, frame: Frame, k: Optional[int] = None) -> float:
        gcol = self._parms.get("group_column") or "qid"
        qid = frame.vec(gcol).numeric_np().astype(np.int64)
        rel = frame.vec(self.model.y).numeric_np().astype(np.float64)
        scores = self.model._margins(self.model._matrix(frame))[:, 0]
        return ndcg_at_k(rel, scores, qid,
                         k or int(self._parms.get("ndcg_k", 10)))


def _gblinear_train(Xd: torch.Tensor, yd: torch.Tensor, wd: torch.Tensor, *,
                    family: str, n_class: int, rounds: int, eta: float,
                    lam: float, alpha: float) -> torch.Tensor:
    """All gblinear rounds on the design's device; returns (K, p) W.

    A round: margins by one (n, p)×(p, K) matmul, per-row (g, h) from the
    family's link (xgboost's multiclass h = 2·p·(1−p)), coordinate sums
    Xᵀg and (X∘X)ᵀh, then xgboost's CoordinateDelta (elastic net, clamped
    where the weight would cross zero) applied to every weight, zero where
    the hessian sum is below 1e-5, damped by eta. The intercept (the last
    column) is unregularized, like xgboost's bias updater. The matmuls are
    true f32 (no TF32), as the reference's at Precision.HIGHEST."""
    dev = Xd.device
    pdim = Xd.shape[1]
    X2 = Xd * Xd
    free = torch.ones(pdim, dtype=torch.float32, device=dev)
    free[pdim - 1] = 0.0
    lam_v = (lam * free)[:, None]               # (p, 1) broadcast over K
    alpha_v = (alpha * free)[:, None]
    onehot = (torch.nn.functional.one_hot(yd.to(torch.int64), n_class)
              .to(torch.float32) if family == "multinomial" else None)
    Wt = torch.zeros((pdim, n_class), dtype=torch.float32, device=dev)
    for _ in range(rounds):
        margin = Xd @ Wt                        # (n, K)
        if family == "binomial":
            mu = torch.sigmoid(margin[:, 0])
            g = ((mu - yd) * wd)[:, None]
            h = (mu * (1 - mu) * wd)[:, None]
        elif family == "multinomial":
            pr = torch.softmax(margin, dim=1)
            g = (pr - onehot) * wd[:, None]
            h = 2.0 * pr * (1 - pr) * wd[:, None]
        else:
            g = ((margin[:, 0] - yd) * wd)[:, None]
            h = wd[:, None]
        G = Xd.t() @ g                          # (p, K)
        H = X2.t() @ h
        gl2 = G + lam_v * Wt
        denom = H + lam_v
        tmp = Wt - gl2 / denom
        dw = torch.where(tmp >= 0,
                         torch.maximum(-(gl2 + alpha_v) / denom, -Wt),
                         torch.minimum(-(gl2 - alpha_v) / denom, -Wt))
        dw = torch.where(H < 1e-5, torch.zeros_like(dw), dw)  # hess guard
        Wt = Wt + eta * dw
    return Wt.t()


class _RankChunk:
    """One chunk of query groups, each padded to the chunk's largest: row
    ids (the pad slot is N), relevance, gain 2^rel − 1, validity and the
    queries' 1/IDCG@k, on the device."""

    def __init__(self, idx, rmat, gmat, valid, inv_idcg, dev):
        self.idx = torch.from_numpy(idx).to(dev)
        self.rel = torch.from_numpy(rmat.astype(np.float32)).to(dev)
        self.gain = torch.from_numpy(gmat.astype(np.float32)).to(dev)
        self.valid = torch.from_numpy(valid).to(dev)
        self.inv_idcg = torch.from_numpy(inv_idcg.astype(np.float32)).to(dev)
        G = idx.shape[1]
        ar = torch.arange(G, device=dev)
        self.earlier = ar[None, :] < ar[:, None]        # [i, j] = j < i


def rank_chunks(qid: np.ndarray, rel: np.ndarray, k: int, dev):
    """The lambdarank pass's query chunks: the queries in order of size
    (stable over `np.unique` order), each chunk padded to its own largest
    group, holding at most PAIR_CHUNK pair elements (one query at least)
    and ending where its largest group would pass max(PAD_FLOOR,
    PAD_GROWTH × its smallest). The ideal DCG@k of each query is computed
    on the host in f64, as the reference does."""
    N = len(qid)
    order = np.argsort(qid, kind="mergesort")
    qs = qid[order]
    starts = (np.flatnonzero(np.r_[True, qs[1:] != qs[:-1]]) if N
              else np.zeros(0, np.int64))
    ends = np.r_[starts[1:], N].astype(np.int64)
    sizes = ends - starts
    gains = (2.0 ** rel - 1.0).astype(np.float64)
    qorder = np.argsort(sizes, kind="stable")
    chunks = []
    a = 0
    Q = len(qorder)
    while a < Q:
        b = a + 1
        G = int(sizes[qorder[a]])
        g_cap = max(PAD_FLOOR, PAD_GROWTH * G)
        while b < Q:
            G2 = max(G, int(sizes[qorder[b]]))
            if G2 > g_cap or (b + 1 - a) * G2 * G2 > PAIR_CHUNK:
                break
            G, b = G2, b + 1
        sel = qorder[a:b]
        G = int(sizes[sel].max())
        idx = np.full((len(sel), G), N, np.int64)
        for r, q in enumerate(sel):
            idx[r, : sizes[q]] = order[starts[q]:ends[q]]
        valid = idx < N
        rmat = np.where(valid, rel[np.minimum(idx, N - 1)], 0.0)
        gmat = np.where(valid, gains[np.minimum(idx, N - 1)], 0.0)
        idcg = np.zeros(len(sel))
        for r in range(len(sel)):
            ideal = np.sort(rmat[r][valid[r]])[::-1]
            idcg[r] = ((2.0 ** ideal - 1)
                       / np.log2(np.arange(2, len(ideal) + 2)))[:k].sum()
        inv_idcg = np.where(idcg > 0, 1.0 / np.maximum(idcg, 1e-12), 0.0)
        chunks.append(_RankChunk(idx, rmat, gmat, valid, inv_idcg, dev))
        a = b
    return chunks


def _make_lambdarank(qid: np.ndarray, rel: np.ndarray, k: int, dev):
    """xgboost `rank:ndcg`: for each query, pairs (i, j) with rel_i > rel_j
    give λ = σ(−(s_i − s_j))·|ΔNDCG_ij| to g_i with a minus sign and to g_j
    with a plus, and σ(1−σ)|ΔNDCG_ij| to both hessians. Returns the
    objective `(margins, y) → (g, h)` over the fit's padded rows."""
    chunks = rank_chunks(qid, rel, k, dev)
    n_rows = len(qid)
    # the discount 1/log2(rank + 2) of every rank a query can give
    gmax = max([c.idx.shape[1] for c in chunks], default=1)
    disc = 1.0 / torch.log2(torch.arange(gmax, dtype=torch.float32,
                                         device=dev) + 2.0)

    def objective(margin, y):
        return _lambdarank_pass(margin, chunks, n_rows, disc)

    return objective


def _lambdarank_pass(margin: torch.Tensor, chunks, n_rows: int,
                     disc_of_rank: torch.Tensor):
    """One lambdarank (g, h) pass over every chunk of query groups,
    returned padded to len(margin): g 0 and h 1e-6 on pad rows, h floored
    at 1e-6 on real ones.

    Per chunk, in f32 as the reference: a row's rank in its query is the
    count of better-scored rows plus equal-scored earlier ones (the rank
    of a stable sort by score, descending), its discount 1/log2(rank + 2)
    (`disc_of_rank`, one table a fit); |ΔNDCG_ij| = |(gain_i −
    gain_j)(disc_i − disc_j)|/IDCG; ρ = σ(−clip(s_i − s_j, ±35)). ρ is
    evaluated in f64 and rounded once, and a row's sums over its pairs are
    taken in f64 and rounded once, so a query's g and h do not depend on
    the chunk it lies in (a vectorized f32 exp and its scalar tail may
    differ by an ulp on the CPU)."""
    dev = margin.device
    s_pad = torch.cat([margin.to(torch.float32),
                       torch.zeros(1, dtype=torch.float32, device=dev)])
    g = torch.zeros(n_rows + 1, dtype=torch.float32, device=dev)
    h = torch.zeros(n_rows + 1, dtype=torch.float32, device=dev)
    ninf = torch.tensor(-float("inf"), device=dev)
    for c in chunks:
        vv = c.valid
        sc = torch.where(vv, s_pad[c.idx], ninf)                   # (q, G)
        si, sj = sc[:, :, None], sc[:, None, :]
        rk = ((si < sj) | ((si == sj) & c.earlier)).sum(dim=2)
        disc = torch.where(vv, disc_of_rank[rk], torch.zeros_like(sc))
        delta = (torch.abs((c.gain[:, :, None] - c.gain[:, None, :])
                           * (disc[:, :, None] - disc[:, None, :]))
                 * c.inv_idcg[:, None, None])
        s0 = torch.where(vv, sc, torch.zeros_like(sc))
        rho = torch.sigmoid(-torch.clamp(s0[:, :, None] - s0[:, None, :],
                                         -35.0, 35.0).to(torch.float64)
                            ).to(torch.float32)
        ok = ((c.rel[:, :, None] > c.rel[:, None, :])
              & vv[:, :, None] & vv[:, None, :])
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        lam = torch.where(ok, rho * delta, zero)
        hess = torch.where(ok, rho * (1 - rho) * delta, zero)
        f64 = torch.float64
        g_q = -(lam.sum(dim=2, dtype=f64) - lam.sum(dim=1, dtype=f64))
        h_q = hess.sum(dim=2, dtype=f64) + hess.sum(dim=1, dtype=f64)
        # every row sits in one query; pad slots land on index n_rows
        g[c.idx.reshape(-1)] = g_q.to(torch.float32).reshape(-1)
        h[c.idx.reshape(-1)] = h_q.to(torch.float32).reshape(-1)
    M = margin.shape[0]
    g_full = torch.zeros(M, dtype=torch.float32, device=dev)
    g_full[:n_rows] = g[:n_rows]
    h_full = torch.full((M,), 1e-6, dtype=torch.float32, device=dev)
    h_full[:n_rows] = torch.clamp(h[:n_rows], min=1e-6)
    return g_full, h_full


XGBoost = H2OXGBoostEstimator
