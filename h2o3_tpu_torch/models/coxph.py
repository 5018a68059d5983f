"""H2OCoxProportionalHazardsEstimator — Cox PH survival regression.

Port of `h2o3_tpu/models/coxph.py` (reference parity:
`hex/coxph/CoxPH.java`: risk-set sums per event time, Newton-Raphson on
the partial log-likelihood, `ties` ∈ {efron, breslow}; `CoxPHModel.java`:
coef/exp(coef)/se(coef), loglik, concordance).

The host preparation is the reference's: the `stop_column` check, the
column filter, the uncentred `DataInfo` expansion and its column centring,
the event and weight reads, the strata key and, per stratum, the
descending mergesort by stop time and the start-sorted permutation. The
tie structure (`tie_first`, `tie_size`, `last_in_tie`) is the reference's
Python loop written as numpy run boundaries: the same integer arrays.

Per Newton step the partial likelihood runs on the model's device in f64
(`partial_ll`): η = Xβ, the cumulative risk-set sums {Σ w·e^η, Σ w·e^η·x,
Σ w·e^η·x xᵀ} in stop order (and in start order with a `start_column`,
removed through `searchsorted` on the negated start times), read at each
tie group's last row (`risk_set_sums`). The reference sums them in f32
over every row of a stratum; over 10⁵ rows the prefix error does not
average out of the gradient and its Newton loop may never meet its
`max|step| < 1e-8` stop (ROADMAP §C), so the port sums in f64. Efron's
terms are expanded to one term per event of a tie group of d > 1 events
(f = k/d), Breslow's to one per group; the events' own sums come from
`torch.segment_reduce` over the contiguous event rows, and every term is
summed at once, with no Python loop over event times. The Newton solve,
its `lstsq` fallback, the stop and the standard errors stay host f64.

Harrell's concordance counts the concordant, tied and comparable pairs
exactly in int64 on the device (`concordance_counts`): rows sorted by
descending time, the linear predictor ranked, and each event's "rows with
a strictly later time" prefix split into aligned power-of-two blocks,
each counted by a `searchsorted` in that level's block-sorted keys —
O(n log² n) where the reference's loop over events is O(events × n). The
linear predictor is the reference's host `X @ beta` on the uncentred
design, so equal counts give a bit-equal C.

Kept as the reference has them (ROADMAP §C): the validation and CV-fold
metrics are the training metrics; CV's metrics are a regression of `lp`
on the event column; a `ties` value other than "efron" fits Breslow.
`lre_min` and `interactions` are accepted by the reference and never
read: only their defaults are ported.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from .metrics import ModelMetricsBase
from .model_base import (DataInfo, H2OEstimator, H2OModel, _sync,
                         check_unread, warn_host_solver)

_ITEM10 = "ROADMAP queue A, item 10"
_UNREAD = dict(lre_min=9.0, interactions=None)
# f64 elements a chunk of the cumulative sums or of the Efron terms holds
# ((rows, p, p) and (events, p, p)); p = 4 needs no chunking below 10⁶ rows
CHUNK_ELEMS = 1 << 24


def tie_structure(ts: np.ndarray):
    """`tie_first`, `tie_size` and `last_in_tie` of stop times sorted in
    descending order: the reference's run loop (`coxph.py:230-241`) as
    run boundaries, with its equality test (NaN starts a run of its
    own)."""
    m = len(ts)
    tie_first = np.zeros(m, np.int64)
    tie_size = np.zeros(m, np.int64)
    last_in_tie = np.zeros(m, np.int64)
    if m == 0:
        return tie_first, tie_size, last_in_tie
    starts = np.concatenate([[0], np.flatnonzero(~(ts[1:] == ts[:-1])) + 1])
    ends = np.concatenate([starts[1:], [m]])
    sizes = ends - starts
    tie_first[:] = np.repeat(starts, sizes)
    tie_size[starts] = sizes
    last_in_tie[:] = np.repeat(ends - 1, sizes)
    return tie_first, tie_size, last_in_tie


def _sum_plan(at: np.ndarray, n: int, p: int, dev) -> list:
    """Row chunks of the cumulative sums and, per chunk, which entries of
    `at` (row indices, -1 = none) it answers."""
    rows = max(1, CHUNK_ELEMS // (p * p + p + 1))
    plan = []
    for lo in range(0, max(n, 1), rows):
        hi = min(n, lo + rows)
        sel = np.flatnonzero((at >= lo) & (at < hi))
        plan.append((lo, hi, torch.from_numpy(sel).to(dev),
                     torch.from_numpy(at[sel] - lo).to(dev)))
    return plan


def risk_set_sums(X: torch.Tensor, r: torch.Tensor, plan: list, q: int):
    """Cumulative Σ_{j≤i} r_j·{1, x_j, x_j x_jᵀ} in f64 over the rows in
    their order, read at `q` rows through `plan` (`_sum_plan`): returns
    (q,), (q, p), (q, p, p); an entry no chunk answers (row -1) is 0. The
    1 + p + p² sums are laid out as rows and each is one 1-D `cumsum` (a
    device-wide scan on the card; a scan along the outer dimension of an
    (n, p, p) tensor runs one thread a column there); the rows run in
    chunks whose last cumulative value carries into the next."""
    p = X.shape[1]
    K = 1 + p + p * p
    dev = X.device
    out = torch.zeros((K, q), dtype=torch.float64, device=dev)
    carry = torch.zeros(K, dtype=torch.float64, device=dev)
    for lo, hi, sel, loc in plan:
        if hi <= lo:
            continue
        rx = r[lo:hi, None] * X[lo:hi]
        Y = torch.cat([r[None, lo:hi], rx.t(),
                       (rx[:, :, None] * X[lo:hi, None, :]).reshape(
                           hi - lo, p * p).t()])
        C = torch.stack([torch.cumsum(Y[k], 0) for k in range(K)])
        C += carry[:, None]
        out[:, sel] = C[:, loc]
        carry = C[:, -1]
    return out[0], out[1:1 + p].t(), out[1 + p:].t().reshape(q, p, p)


class _Stratum:
    """One stratum's rows sorted by descending stop time, on the device,
    with its event groups and their Efron/Breslow terms."""

    def __init__(self, Xs, w, event, ts, t0, ties: str, dev):
        m, p = Xs.shape
        tie_first, _, last_in_tie = tie_structure(ts)
        ev = event.astype(bool)
        erows = np.flatnonzero(ev)
        gfirst, d = np.unique(tie_first[erows], return_counts=True)
        # per group sw = Σ w over its events (contiguous in row order)
        sw = (np.add.reduceat(w[erows], np.cumsum(d) - d) if len(d)
              else np.zeros(0))
        efron = ties == "efron"
        # one term per event of an Efron group of d > 1, else one a group
        reps = np.where(efron & (d > 1), d, 1)
        tg = np.repeat(np.arange(len(gfirst)), reps)
        k = np.arange(len(tg)) - np.repeat(np.cumsum(reps) - reps, reps)
        dd = d[tg]
        multi = efron & (dd > 1)
        self.p = p
        self.n_groups = len(gfirst)
        self.multi_groups = int((d > 1).sum())
        self.need_e = bool(multi.any())
        self.X = torch.from_numpy(np.ascontiguousarray(Xs, np.float64)).to(dev)
        self.w = torch.from_numpy(np.asarray(w, np.float64)).to(dev)
        self.erows = torch.from_numpy(erows).to(dev)
        self.ev_len = torch.from_numpy(d).to(dev)
        self.t_group = torch.from_numpy(tg).to(dev)
        self.t_f = torch.from_numpy(np.where(multi, k / np.maximum(dd, 1),
                                             0.0)).to(dev)
        self.t_c = torch.from_numpy(np.where(multi, sw[tg] / np.maximum(dd, 1),
                                             sw[tg])).to(dev)
        li = last_in_tie[gfirst]
        self.plan = _sum_plan(li, m, p, dev)
        self.start = None
        if t0 is not None:
            sp = np.argsort(-t0, kind="mergesort")
            start_sorted = torch.from_numpy(t0[sp]).to(dev)
            times = torch.from_numpy(np.ascontiguousarray(ts[gfirst])).to(dev)
            kk = torch.searchsorted(-start_sorted, -times, right=True)
            self.start = (torch.from_numpy(sp).to(dev),
                          _sum_plan(kk.cpu().numpy() - 1, m, p, dev))

    def partial_ll(self, beta: torch.Tensor):
        """(ll, grad, hess) f64 device tensors of the stratum at β."""
        X, w, G = self.X, self.w, self.n_groups
        eta = X @ beta
        r = w * torch.exp(eta)
        s0, s1, s2 = risk_set_sums(X, r, self.plan, G)
        if self.start is not None:
            sp, plan = self.start
            c0, c1, c2 = risk_set_sums(X[sp], r[sp], plan, G)
            s0, s1, s2 = s0 - c0, s1 - c1, s2 - c2
        e = self.erows
        ll = (w[e] * eta[e]).sum()
        grad = (w[e, None] * X[e]).sum(0)
        hess = torch.zeros((self.p, self.p), dtype=torch.float64,
                           device=X.device)
        T = self.t_group.shape[0]
        if T == 0:
            return ll, grad, hess
        zg = torch.zeros((G, 1), dtype=torch.float64, device=X.device)
        e0, e1, e2 = zg[:, 0], zg, zg[:, :, None]
        if self.need_e:
            re, Xe = r[e], X[e]
            seg = dict(reduce="sum", lengths=self.ev_len, axis=0)
            e0 = torch.segment_reduce(re, **seg)
            e1 = torch.segment_reduce(re[:, None] * Xe, **seg)
            e2 = torch.segment_reduce(
                re[:, None, None] * (Xe[:, :, None] * Xe[:, None, :]), **seg)
        rows = max(1, CHUNK_ELEMS // (self.p * self.p))
        for lo in range(0, T, rows):
            g = self.t_group[lo:lo + rows]
            f, c = self.t_f[lo:lo + rows], self.t_c[lo:lo + rows]
            d0 = s0[g] - f * e0[g]
            d1 = s1[g] - f[:, None] * e1[g]
            d2 = s2[g] - f[:, None, None] * e2[g]
            ll = ll - (c * torch.log(torch.clamp(d0, min=1e-300))).sum()
            grad = grad - ((c / d0)[:, None] * d1).sum(0)
            hess = hess + (c[:, None, None] * (
                d2 / d0[:, None, None]
                - (d1[:, :, None] * d1[:, None, :]) / (d0 ** 2)[:, None, None]
            )).sum(0)
        return ll, grad, hess


def concordance_counts(time_: torch.Tensor, event: torch.Tensor,
                       lp: torch.Tensor):
    """(concordant, tied, comparable) pair counts of Harrell's C, exact in
    int64, with the reference's definitions: for every event row i (event
    ≠ 0) and every row j with time_j > time_i strictly, over all rows,
    weights and strata ignored: comparable; concordant if lp_j < lp_i;
    tied if lp_j == lp_i. Rows sorted by descending time put each event's
    comparable rows in a prefix [0, P_i); the prefix splits into aligned
    blocks of 2^l rows, one a level at most, and a level's block counts
    come from `searchsorted` in its keys block·R' + rank sorted once."""
    dev = time_.device
    n = time_.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if n == 0:
        return zero, zero, zero
    tkey = torch.where(torch.isnan(time_),
                       torch.full_like(time_, -float("inf")), time_)
    order = torch.argsort(tkey, descending=True, stable=True)
    _, rank_all = torch.unique(lp, return_inverse=True)
    rank = rank_all[order]
    R1 = int(rank.max().item()) + 2
    asc = torch.sort(tkey).values
    is_ev = (event != 0) & ~torch.isnan(time_)
    qt, qr = tkey[is_ev], rank_all[is_ev]
    P = n - torch.searchsorted(asc, qt, right=True)
    less = torch.zeros_like(P)
    leq = torch.zeros_like(P)
    pos = torch.arange(n, device=dev)
    for lvl in range(max(1, int(n).bit_length())):
        has = ((P >> lvl) & 1) == 1
        blk = (P >> lvl) - 1
        base = blk << lvl
        keys = torch.sort((pos >> lvl) * R1 + rank).values
        q = torch.clamp(blk, min=0) * R1 + qr
        lo = torch.searchsorted(keys, q) - base
        hi = torch.searchsorted(keys, q, right=True) - base
        less += torch.where(has, lo, zero)
        leq += torch.where(has, hi, zero)
    return less.sum(), (leq - less).sum(), P.sum()


def _concordance(time_, event, lp, device=None) -> float:
    """Harrell's C = (concordant + ½·tied) / comparable in f64, from
    `concordance_counts` on the device (nan with no comparable pair)."""
    dev = devlib.resolve(device)
    conc, ties, comp = (int(v) for v in concordance_counts(
        torch.from_numpy(np.asarray(time_, np.float64)).to(dev),
        torch.from_numpy(np.asarray(event, np.float64)).to(dev),
        torch.from_numpy(np.asarray(lp, np.float64)).to(dev)))
    if comp == 0:
        return float("nan")
    return float((float(conc) + 0.5 * float(ties)) / float(comp))


class CoxPHModel(H2OModel):
    algo = "coxph"

    def __init__(self, params, x, y, dinfo, beta, se, loglik, loglik_null,
                 concordance, n_event, stop_col, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self.dinfo = dinfo
        self.beta = beta
        self.se_coef = se
        self.loglik = loglik
        self.loglik_null = loglik_null
        self.concordance = concordance
        self.n_event = n_event
        self.stop_col = stop_col
        self.device = devlib.resolve(device)

    def coef(self):
        return dict(zip(self.dinfo.coef_names, self.beta))

    def coefficients_table(self):
        z = self.beta / np.maximum(self.se_coef, 1e-300)
        return [
            dict(name=n, coef=float(b), exp_coef=float(np.exp(b)),
                 se_coef=float(s), z_coef=float(zz))
            for n, b, s, zz in zip(self.dinfo.coef_names, self.beta,
                                   self.se_coef, z)
        ]

    def predict(self, test_data: Frame) -> Frame:
        """Linear predictor (log relative hazard) on the uncentred design,
        the reference's host `X @ beta`."""
        X = self.dinfo.transform(test_data)
        return Frame.from_dict({"lp": X @ self.beta})

    def _make_metrics(self, frame: Frame):
        return self.training_metrics


class H2OCoxProportionalHazardsEstimator(H2OEstimator):
    algo = "coxph"
    _param_defaults = dict(
        ties="efron",
        stop_column=None,
        start_column=None,
        stratify_by=None,
        use_all_factor_levels=False,
        init=0.0,
        lre_min=9.0,
        max_iterations=20,
        interactions=None,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> CoxPHModel:
        warn_host_solver('coxph', train.nrow, 500000)
        p = self._parms
        stop_col = p.get("stop_column")
        if stop_col is None:
            raise ValueError("coxph requires stop_column")
        check_unread("CoxPH", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        t_start = time.perf_counter()
        ties = str(p.get("ties", "efron")).lower()
        start_col = p.get("start_column")
        strat_cols = p.get("stratify_by") or []
        if isinstance(strat_cols, str):
            strat_cols = [strat_cols]
        x = [c for c in x if c not in (stop_col, start_col) and c not in strat_cols]
        dinfo = DataInfo(train, x, standardize=False,
                         use_all_factor_levels=bool(p.get("use_all_factor_levels", False)))
        X = dinfo.fit_transform(train).astype(np.float64)
        # centre the columns: the reference solves on centred covariates
        xbar = X.mean(axis=0)
        Xc = X - xbar
        t = train.vec(stop_col).numeric_np()
        t0 = train.vec(start_col).numeric_np() if start_col else None
        yv = train.vec(y)
        event = (np.asarray(yv.data, np.float64) if yv.type == "enum"
                 else yv.numeric_np()).astype(np.float64)
        wcol = p.get("weights_column")
        w = train.vec(wcol).numeric_np() if wcol else np.ones(len(t))
        n = len(t)

        # strata = distinct combinations of the stratify_by columns; the
        # partial likelihood is computed per stratum and summed
        if strat_cols:
            keys = np.zeros(n, np.int64)
            for c in strat_cols:
                v = train.vec(c)
                codes = (np.asarray(v.data, np.int64) if v.type == "enum"
                         else v.numeric_np().astype(np.int64))
                keys = keys * (codes.max() + 2) + codes
            _, strata = np.unique(keys, return_inverse=True)
        else:
            strata = np.zeros(n, np.int64)

        groups: List[_Stratum] = []
        for s in np.unique(strata):
            rows = np.nonzero(strata == s)[0]
            order = np.argsort(-t[rows], kind="mergesort")
            rows = rows[order]
            groups.append(_Stratum(Xc[rows], w[rows], event[rows], t[rows],
                                   t0[rows] if t0 is not None else None,
                                   ties, dev))
        _sync(dev)
        t_prep = time.perf_counter()
        pdim = Xc.shape[1]

        def accumulate(beta):
            bd = torch.from_numpy(np.asarray(beta, np.float64)).to(dev)
            ll = torch.zeros((), dtype=torch.float64, device=dev)
            grad = torch.zeros(pdim, dtype=torch.float64, device=dev)
            hess = torch.zeros((pdim, pdim), dtype=torch.float64, device=dev)
            for g in groups:
                lg, gg, hg = g.partial_ll(bd)
                ll, grad, hess = ll + lg, grad + gg, hess + hg
            return (float(ll), grad.cpu().numpy(), hess.cpu().numpy())

        beta = np.full(pdim, float(p.get("init", 0.0)))
        ll = ll_null = None
        if not beta.any():
            ll_null = accumulate(beta)[0]
        iters, stopped = 0, False
        newton_ms = []
        for it in range(int(p.get("max_iterations", 20))):
            t_it = time.perf_counter()
            ll, grad, hess = accumulate(beta)
            try:
                step = np.linalg.solve(hess + 1e-9 * np.eye(pdim), grad)
            except np.linalg.LinAlgError:
                step = np.linalg.lstsq(hess, grad, rcond=None)[0]
            beta = beta + step
            iters = it + 1
            newton_ms.append(1e3 * (time.perf_counter() - t_it))
            if np.max(np.abs(step)) < 1e-8:
                stopped = True
                break
        if ll_null is None:
            ll_null = accumulate(np.zeros(pdim))[0]
        ll, grad, hess = accumulate(beta)
        try:
            se = np.sqrt(np.maximum(np.diag(np.linalg.inv(hess + 1e-9 * np.eye(pdim))), 0))
        except np.linalg.LinAlgError:
            se = np.full(pdim, np.nan)
        t_newton = time.perf_counter()
        conc = _concordance(t, event, X @ beta, device=dev)
        t_conc = time.perf_counter()
        model = CoxPHModel(self, x, y, dinfo, beta, se, float(ll), float(ll_null),
                           conc, int(event.sum()), stop_col, device=dev)
        model.training_metrics = ModelMetricsBase(nobs=n, description=f"concordance={conc:.4f}")
        # host-clock split (the device is synchronised at each mark): the
        # host sort and tie groups with their upload, the Newton loop (each
        # iteration's ms), the concordance
        model.fit_timings = dict(prep_s=t_prep - t_start,
                                 newton_s=t_newton - t_prep,
                                 concordance_s=t_conc - t_newton,
                                 total_s=t_conc - t_start)
        model.newton = dict(iterations=iters, stopped_on_step=stopped,
                            ms=newton_ms,
                            multi_event_groups=sum(g.multi_groups
                                                   for g in groups))
        return model

    def _cv_predict(self, model: CoxPHModel, frame: Frame) -> np.ndarray:
        return model.predict(frame).vec("lp").numeric_np()


CoxPH = H2OCoxProportionalHazardsEstimator
