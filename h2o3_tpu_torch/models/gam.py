"""H2OGeneralizedAdditiveEstimator — GAM (GLM + penalized smooth terms).

Port of `h2o3_tpu/models/gam.py` (reference parity: `hex/gam/GAM.java` +
`hex/gam/MatrixFrameUtils/GamUtils.java`: each `gam_column` is expanded
into a cubic-regression-spline basis with `num_knots` knots at quantiles,
a roughness penalty S scaled by `scale` is added to the GLM normal
equations, and identifiability comes from centring the basis).

The knots (`np.unique(np.quantile(...))`), the basis and its centres, the
relative penalty scale and the ridge term are host numpy, copied verbatim
(`ops/splines.py` is the port's own copy), so they are the reference's bit
for bit. The design [linear | splines | 1] lives on the card: the linear
block through `DataInfo.device_design` (one-hot, mean imputation and NaN
→ 0 on the device, the values of `DataInfo.fit_transform`), the spline
block built on the host in f64, cast to f32 and uploaded once. Each IRLS
iteration is the GLM's `_gram_step` on the card in true f32, over chunks
of GRAM_CHUNK_ROWS rows whose results add in f64 (`chunked_gram`: the
reference's one f32 product over all rows leaves Δβ above
`beta_epsilon` on a large frame, and its IRLS never stops); the p×p solve
with the penalty stays host f64 (+1e-8·I, `lstsq` on failure), with the
reference's single gaussian step and `beta_epsilon` stop.

`_score` forms η in f64 from the f32 design on the model's device and
rounds it to f32 before the inverse link, as the reference's
`_linkinv(family, jnp.asarray(eta))` does. Under `family="AUTO"` a
response of more than two levels fits gaussian on its codes, as the
reference does (ROADMAP §C). `bs`, `spline_orders`, `alpha` and
`keep_gam_cols` are accepted by the reference and never read: only their
defaults are ported (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from ..ops.splines import second_diff_penalty as _second_diff_penalty
from ..ops.splines import spline_basis as _spline_basis
from .glm import _gram_step, _linkinv
from .metrics import ModelMetricsBinomial, ModelMetricsRegression
from .model_base import (DataInfo, H2OEstimator, H2OModel, _sync,
                         check_unread, response_info, warn_host_solver)

_ITEM10 = "ROADMAP queue A, item 10"
# rows a Gram chunk: each chunk's X'WX is a true-f32 product, the chunks'
# sums add in f64
GRAM_CHUNK_ROWS = 2048
_UNREAD = dict(bs=None, spline_orders=None, alpha=None, keep_gam_cols=False)


def chunked_gram(X, y, w, beta, family: str, rows: int = GRAM_CHUNK_ROWS):
    """X'WX and X'Wz of one IRLS iteration: the GLM's `_gram_step` in true
    f32 over each chunk of `rows` rows, the chunks' results summed in f64
    on the device. One f32 product over all rows rounds its long sums by
    ~√n ulps; on the unstandardized, nearly collinear spline basis
    (condition ≈1e6) that moves Δβ by ~1e-3 from one iteration to the
    next, above `beta_epsilon`, and the reference's IRLS then runs all
    `max_iterations` (ROADMAP §C)."""
    p = X.shape[1]
    gram = torch.zeros((p, p), dtype=torch.float64, device=X.device)
    xy = torch.zeros(p, dtype=torch.float64, device=X.device)
    for lo in range(0, X.shape[0], rows):
        g, v = _gram_step(X[lo:lo + rows], y[lo:lo + rows], w[lo:lo + rows],
                          beta, family)
        gram += g
        xy += v
    return gram, xy


class GAMModel(H2OModel):
    algo = "gam"

    def __init__(self, params, x, y, dinfo, family, beta, domain, gam_spec,
                 device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        self.dinfo = dinfo
        self.family = family
        self.beta = beta
        self.domain = domain
        self.gam_spec = gam_spec  # list of (col, knots, basis_center)
        self.device = devlib.resolve(device)

    def _design(self, frame: Frame) -> torch.Tensor:
        """[linear | splines | 1] in f32 on the model's device."""
        parts = []
        if self.dinfo.x:
            parts.append(self.dinfo.device_design(frame, fit=False,
                                                  device=self.device))
        for col, knots, center in self.gam_spec:
            # NaN→0 matches the training-time basis (see _fit)
            B = _spline_basis(np.nan_to_num(frame.vec(col).numeric_np()),
                              knots) - center
            parts.append(torch.from_numpy(B.astype(np.float32)).to(
                self.device))
        parts.append(torch.ones((frame.nrow, 1), dtype=torch.float32,
                                device=self.device))
        return torch.cat(parts, dim=1)

    def _score(self, frame: Frame, Xd: Optional[torch.Tensor] = None) -> np.ndarray:
        if Xd is None:
            Xd = self._design(frame)
        beta = torch.from_numpy(np.asarray(self.beta, np.float64)).to(
            Xd.device)
        eta = Xd.to(torch.float64) @ beta
        return _linkinv(self.family, eta.to(torch.float32)).cpu().numpy()

    def coef(self) -> Dict[str, float]:
        names = list(self.dinfo.coef_names)
        for col, knots, _ in self.gam_spec:
            names += [f"{col}_cr_{i}" for i in range(len(knots) - 1)]
        names.append("Intercept")
        return dict(zip(names, self.beta))

    def predict(self, test_data: Frame) -> Frame:
        out = self._score(test_data)
        if self.family == "binomial":
            d = {"predict": np.asarray(self.domain, dtype=object)[(out > 0.5).astype(int)],
                 str(self.domain[0]): 1 - out, str(self.domain[1]): out}
            return Frame.from_dict(d, column_types={"predict": "enum"})
        return Frame.from_dict({"predict": out})

    def _make_metrics(self, frame: Frame, Xd: Optional[torch.Tensor] = None):
        out = self._score(frame, Xd=Xd)
        yv = frame.vec(self.y)
        if self.family == "binomial":
            return ModelMetricsBinomial.make(np.asarray(yv.data), out)
        return ModelMetricsRegression.make(yv.numeric_np(), out)


class H2OGeneralizedAdditiveEstimator(H2OEstimator):
    algo = "gam"
    _param_defaults = dict(
        family="AUTO",
        gam_columns=None,
        num_knots=None,
        scale=None,
        bs=None,
        spline_orders=None,
        standardize=False,
        lambda_=None,
        alpha=None,
        max_iterations=50,
        beta_epsilon=1e-4,
        keep_gam_cols=False,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> GAMModel:
        warn_host_solver('gam', train.nrow, 500000)
        p = self._parms
        gam_cols: List[str] = list(p.get("gam_columns") or [])
        if not gam_cols:
            raise ValueError("gam requires gam_columns")
        check_unread("GAM", _ITEM10, p, _UNREAD)
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        # h2o-py allows nested lists for multivariate splines; flatten singles
        gam_cols = [c[0] if isinstance(c, (list, tuple)) else c for c in gam_cols]
        yvec = train.vec(y)
        problem, nclass, domain = response_info(yvec)
        family = p.get("family", "AUTO")
        if family == "AUTO":
            family = "binomial" if problem == "binomial" else "gaussian"

        def _per_col(val, default, name):
            if val is None:
                return [default] * len(gam_cols)
            if np.isscalar(val):
                return [val] * len(gam_cols)
            val = list(val)
            if len(val) == 1:
                return val * len(gam_cols)
            if len(val) != len(gam_cols):
                raise ValueError(
                    f"gam: {name} has {len(val)} entries for "
                    f"{len(gam_cols)} gam_columns"
                )
            return val

        nks = _per_col(p.get("num_knots"), 10, "num_knots")
        scales = _per_col(p.get("scale"), 1.0, "scale")
        lin_x = [c for c in x if c not in gam_cols]
        dinfo = DataInfo(train, lin_x, standardize=bool(p.get("standardize", False)))
        n_lin = len(dinfo.coef_names)
        gam_spec = []
        blocks = []
        pen_blocks = []  # (offset, S·scale)
        off = n_lin
        for col, k, sc in zip(gam_cols, nks, scales):
            v = train.vec(col).numeric_np()
            knots = np.unique(np.quantile(v[~np.isnan(v)], np.linspace(0, 1, max(int(k), 3))))
            B = _spline_basis(np.nan_to_num(v), knots)
            center = B.mean(axis=0)
            Bc = (B - center).astype(np.float32)
            gam_spec.append((col, knots, center))
            # normalize S to the Gram block's scale so `scale` is a relative
            # smoothing knob (the reference normalizes its penalty similarly)
            Sk = _second_diff_penalty(Bc.shape[1])
            rel = float((Bc**2).sum()) / max(np.trace(Sk), 1e-12)
            pen_blocks.append((off, Sk * rel * 1e-3 * float(sc)))
            off += Bc.shape[1]
            blocks.append(Bc)
        n = train.nrow
        pdim = off
        t_basis = time.perf_counter()

        # the design [linear | splines | 1] on the device, f32
        design_t: Dict[str, float] = {}
        parts = [dinfo.device_design(train, fit=True, device=dev,
                                     timings=design_t)]
        parts += [torch.from_numpy(Bc).to(dev) for Bc in blocks]
        parts.append(torch.ones((n, 1), dtype=torch.float32, device=dev))
        Xd = torch.cat(parts, dim=1)
        del parts, blocks

        if family == "binomial":
            yarr = (np.asarray(yvec.data, np.float32) if yvec.type == "enum"
                    else yvec.numeric_np().astype(np.float32))
        else:
            yarr = yvec.numeric_np().astype(np.float32)
        wcol = p.get("weights_column")
        w = (train.vec(wcol).numeric_np() if wcol else np.ones(n)).astype(np.float32)
        yd = torch.from_numpy(yarr).to(dev)
        wd = torch.from_numpy(w).to(dev)
        _sync(dev)
        t_design = time.perf_counter()

        # penalty matrix over the full (p+1) system
        S = np.zeros((pdim + 1, pdim + 1))
        for o, Sk in pen_blocks:
            m = Sk.shape[0]
            S[o : o + m, o : o + m] += Sk
        lam = p.get("lambda_")
        ridge = float(lam[0] if isinstance(lam, (list, tuple)) else (lam or 0.0))
        if ridge > 0:
            S[np.arange(pdim), np.arange(pdim)] += ridge * n

        beta = np.zeros(pdim + 1)
        gram_ms: List[float] = []
        converged = False
        beta_eps = float(p.get("beta_epsilon", 1e-4))
        for it in range(int(p.get("max_iterations", 50))):
            tg = time.perf_counter()
            gram, xy = chunked_gram(Xd, yd, wd, torch.from_numpy(
                beta.astype(np.float32)).to(dev), family)
            gram, xy = gram.cpu().numpy(), xy.cpu().numpy()
            gram_ms.append((time.perf_counter() - tg) * 1e3)
            A = gram + S
            try:
                nb = np.linalg.solve(A + 1e-8 * np.eye(pdim + 1), xy)
            except np.linalg.LinAlgError:
                nb = np.linalg.lstsq(A, xy, rcond=None)[0]
            delta = np.max(np.abs(nb - beta))
            beta = nb
            if delta < beta_eps:
                converged = True
                break
            if family == "gaussian":
                break
        t_irls = time.perf_counter()

        model = GAMModel(self, x, y, dinfo, family, beta, domain, gam_spec,
                         device=dev)
        model.penalty = S            # (p+1)² f64: the roughness and ridge terms
        model.iterations = len(gram_ms)
        model.converged = converged
        model.gram_ms = gram_ms
        model.training_metrics = model._make_metrics(train, Xd=Xd)
        del Xd
        if valid is not None:
            model.validation_metrics = model._make_metrics(valid)
        t_end = time.perf_counter()
        # host-clock split: the host knots, basis, centres and penalty; the
        # design on the device (linear block's pack/upload/expansion, spline
        # block's upload); the IRLS loop (each Gram read back to the host
        # for the f64 solve); the metrics
        design_t["h2d_s"] = (t_design - t_basis - design_t["pack_s"]
                             - design_t["expand_s"])
        model.fit_timings = dict(
            basis_s=t_basis - t0, **design_t, irls_s=t_irls - t_design,
            metrics_s=t_end - t_irls, total_s=t_end - t0)
        return model

    def _cv_predict(self, model: GAMModel, frame: Frame) -> np.ndarray:
        return model._score(frame)


GAM = H2OGeneralizedAdditiveEstimator
