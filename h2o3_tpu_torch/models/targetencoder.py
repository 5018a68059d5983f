"""H2OTargetEncoderEstimator — categorical target encoding, single device.

Port of `h2o3_tpu/models/targetencoder.py` (reference parity:
`ai/h2o/targetencoding/TargetEncoder.java` and `TargetEncoderModel.java`:
per-level target means under `data_leakage_handling` "None", "KFold" or
"LeaveOneOut", blended toward the prior by λ = 1/(1 + exp(−(n − k)/f)) with
`inflection_point` k and `smoothing` f, and uniform `noise` on a training
transform; `transform` appends `<col>_te` columns).

The per-level sums and counts run on the model's device in f64
(`level_tables`, one `index_add_` each; the counts are exact integers, and
so are the sums of a binary response, in any order). The KFold out-of-fold
tables are the global ones minus each fold's rows, subtracted as the
reference subtracts them. A transform gathers each row's level from those
tables on the device and does the reference's f64 arithmetic there
(`_blend`'s `max(f, 1e-12)` and `s / max(c, 1e-12)`, where an empty level's
mean is 0, not the prior; LeaveOneOut's `sums − y` and `max(cnts − 1, 0)`);
the result is an f32 column.

The host draws are the reference's, in its order: KFold's fold assignment
`default_rng(seed).integers(0, 5, n)` when no `fold_column` is given, and
the noise, a fresh `default_rng(seed)` per transform drawing
`uniform(−noise, noise, n)` once per encoded column in `encodings` order,
only on a training transform. The prior is `np.nanmean` of the response.

`data_leakage_handling` is read as the reference reads it: "KFold" and
"LeaveOneOut" by name, "None" otherwise. The reference encodes any other
spelling (h2o-py's "k_fold" among them) silently as "None"; the port
raises `ValueError` for it (ROADMAP §C).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import device as devlib
from ..frame.frame import Frame
from ..frame.vec import Vec
from .metrics import ModelMetricsBase
from .model_base import H2OEstimator, H2OModel, _sync

LEAKAGE_MODES = ("None", "KFold", "LeaveOneOut")


def level_tables(codes: torch.Tensor, y: torch.Tensor, K: int):
    """(sums, counts), each (K,) f64, of `y` (n,) f64 per level code
    `codes` (n,) int64; rows with a negative code (NA) are skipped."""
    ok = codes >= 0
    c, yv = codes[ok], y[ok]
    sums = torch.zeros(K, dtype=torch.float64, device=y.device).index_add_(0, c, yv)
    cnts = torch.zeros(K, dtype=torch.float64, device=y.device).index_add_(
        0, c, torch.ones_like(yv))
    return sums, cnts


def _host_codes(v: Vec, dom) -> np.ndarray:
    """The reference's `_encode_col` codes: enum codes (a numeric column's
    values as integers), remapped to the training domain `dom` (−1 for an
    unseen level) where the frame's domain differs."""
    codes = (np.asarray(v.data) if v.type == "enum"
             else v.numeric_np().astype(np.int64))
    if v.type == "enum" and v.domain != dom and v.domain:
        lookup = {d: i for i, d in enumerate(dom)}
        remap = np.asarray([lookup.get(d, -1) for d in v.domain], np.int64)
        codes = np.where(codes >= 0, remap[np.maximum(codes, 0)], -1)
    return np.asarray(codes, np.int64)


def blend(s: torch.Tensor, c: torch.Tensor, prior: float, k: float,
          f: float) -> torch.Tensor:
    """The reference's `_blend`, in f64: λ·(s / max(c, 1e-12)) + (1 − λ)·prior."""
    lam = 1.0 / (1.0 + torch.exp(-(c - k) / max(f, 1e-12)))
    mean = s / torch.clamp(c, min=1e-12)
    return lam * mean + (1 - lam) * prior


class TargetEncoderModel(H2OModel):
    algo = "targetencoder"

    def __init__(self, params, x, y, encodings, prior, blending, k, f, noise,
                 leakage, fold_assign, seed, device=None):
        super().__init__(params)
        self.x = list(x)
        self.y = y
        # col → (domain, sums, counts, {fold id: (sums, counts)}), f64 numpy
        self.encodings = encodings
        self.prior = prior
        self.blending = blending
        self.k = k
        self.f = f
        self.noise = noise
        self.leakage = leakage
        self._fold_assign = fold_assign  # training-time fold ids (KFold)
        self.seed = seed
        self.device = devlib.resolve(device)

    def _encode(self, codes: np.ndarray, sums, cnts, y_d, loo: bool,
                fold_idx=None) -> torch.Tensor:
        """(n,) f64 encodings on the device. `sums`/`cnts` are (K,) tables,
        or (n_folds, K) with `fold_idx` (n,) each row's table."""
        dev = self.device
        K = sums.shape[-1]
        cd = torch.from_numpy(codes).to(dev)
        ok = (cd >= 0) & (cd < K)
        ci = torch.clamp(cd, 0, K - 1)
        st = torch.from_numpy(np.ascontiguousarray(sums, np.float64)).to(dev)
        ct = torch.from_numpy(np.ascontiguousarray(cnts, np.float64)).to(dev)
        if fold_idx is None:
            s, c = st[ci], ct[ci]
        else:
            s, c = st[fold_idx, ci], ct[fold_idx, ci]
        if loo:
            s = s - y_d
            c = torch.clamp(c - 1, min=0)
        if self.blending:
            enc = blend(s, c, self.prior, self.k, self.f)
        else:
            enc = torch.where(c > 0, s / torch.clamp(c, min=1e-12),
                              torch.full_like(s, self.prior))
        return torch.where(ok, enc, torch.full_like(enc, self.prior))

    def transform(self, frame: Frame, as_training: bool = False,
                  noise: Optional[float] = None) -> Frame:
        """Append `<col>_te` columns (TargetEncoderModel.transformAsTrainingFrame
        / transform)."""
        dev = self.device
        t0 = time.perf_counter()
        out = {n: v for n, v in zip(frame.names, frame.vecs())}
        yv = frame.vec(self.y) if (self.y in frame.names) else None
        y_d = None
        if yv is not None:
            y_arr = (np.asarray(yv.data, np.float64) if yv.type == "enum"
                     else yv.numeric_np())
            y_d = torch.from_numpy(np.ascontiguousarray(y_arr, np.float64)).to(dev)
        rng = np.random.default_rng(self.seed)
        nz = self.noise if noise is None else noise
        kfold = (as_training and self.leakage == "KFold"
                 and self._fold_assign is not None
                 and len(self._fold_assign) == frame.nrow)
        fold_idx = None
        host_s = 0.0
        for col, (dom, sums, cnts, fold_tables) in self.encodings.items():
            if col not in frame.names:
                continue
            v = frame.vec(col)
            codes = _host_codes(v, dom)
            if kfold:
                fids = sorted(fold_tables)
                if fold_idx is None:
                    fold_idx = torch.from_numpy(np.searchsorted(
                        np.asarray(fids), self._fold_assign).astype(np.int64)).to(dev)
                enc = self._encode(
                    codes, np.stack([fold_tables[f][0] for f in fids]),
                    np.stack([fold_tables[f][1] for f in fids]), None, False,
                    fold_idx)
            else:
                loo = (as_training and self.leakage == "LeaveOneOut"
                       and y_d is not None)
                enc = self._encode(codes, sums, cnts, y_d if loo else None, loo)
            if as_training and nz:
                th = time.perf_counter()
                draw = rng.uniform(-nz, nz, len(codes))
                host_s += time.perf_counter() - th
                enc = enc + torch.from_numpy(draw).to(dev)
            out[f"{col}_te"] = Vec(enc.to(torch.float32).cpu().numpy(), "real")
        self.transform_timings = dict(noise_draw_s=host_s,
                                      total_s=time.perf_counter() - t0)
        return Frame(out)

    def predict(self, test_data: Frame) -> Frame:
        return self.transform(test_data)

    def _make_metrics(self, frame: Frame):
        return self.training_metrics


class H2OTargetEncoderEstimator(H2OEstimator):
    algo = "targetencoder"
    _param_defaults = dict(
        columns=None,
        data_leakage_handling="None",
        blending=False,
        inflection_point=10.0,
        smoothing=20.0,
        noise=0.01,
    )

    def _fit(self, x, y, train: Frame, valid: Optional[Frame]) -> TargetEncoderModel:
        p = self._parms
        leakage = str(p.get("data_leakage_handling", "None"))
        if leakage not in LEAKAGE_MODES:
            raise ValueError(
                f"data_leakage_handling={leakage!r}: expected one of "
                f"{LEAKAGE_MODES} (the reference encodes any other spelling "
                "as 'None'; ROADMAP §C)")
        dev = devlib.resolve(p.get("device"))
        t0 = time.perf_counter()
        cols: List[str] = list(p.get("columns") or
                               [c for c in x if train.vec(c).type == "enum"])
        yvec = train.vec(y)
        y_arr = (np.asarray(yvec.data, np.float64) if yvec.type == "enum"
                 else yvec.numeric_np())
        prior = float(np.nanmean(y_arr))
        seed = int(self._parms.get("_actual_seed", 1234))

        fold_assign = None
        if leakage == "KFold":
            fc = p.get("fold_column")
            if fc:
                fold_assign = train.vec(fc).numeric_np().astype(np.int64)
            else:
                rng = np.random.default_rng(seed)
                fold_assign = rng.integers(0, 5, train.nrow)
        t_host = time.perf_counter() - t0

        t1 = time.perf_counter()
        y_d = torch.from_numpy(np.ascontiguousarray(y_arr, np.float64)).to(dev)
        fa_d = (torch.from_numpy(fold_assign).to(dev)
                if fold_assign is not None else None)
        fids = np.unique(fold_assign) if fold_assign is not None else []
        encodings: Dict[str, tuple] = {}
        for col in cols:
            v = train.vec(col)
            if v.type != "enum":
                continue
            codes = torch.from_numpy(np.asarray(v.data, np.int64)).to(dev)
            K = max(v.nlevels, 1)
            sums, cnts = level_tables(codes, y_d, K)
            fold_tables = {}
            for fid in fids:
                # out-of-fold tables: the global ones minus the fold's rows
                m = (codes >= 0) & (fa_d == int(fid))
                fs = sums.clone().index_add_(0, codes[m], -y_d[m])
                fcn = cnts.clone().index_add_(
                    0, codes[m], torch.full_like(y_d[m], -1.0))
                fold_tables[fid] = (fs.cpu().numpy(), fcn.cpu().numpy())
            encodings[col] = (v.domain, sums.cpu().numpy(), cnts.cpu().numpy(),
                              fold_tables)
        _sync(dev)
        t_dev = time.perf_counter() - t1

        model = TargetEncoderModel(
            self, cols, y, encodings, prior,
            bool(p.get("blending", False)),
            float(p.get("inflection_point", 10.0)),
            float(p.get("smoothing", 20.0)),
            float(p.get("noise", 0.01)),
            leakage, fold_assign, seed, device=dev,
        )
        model.training_metrics = ModelMetricsBase(nobs=train.nrow)
        # host: the prior and the fold draw; device: the level tables
        # (uploads and the copies back included)
        model.fit_timings = dict(host_s=t_host, levels_s=t_dev,
                                 total_s=time.perf_counter() - t0)
        return model

    def transform(self, frame: Frame, **kw) -> Frame:
        return self.model.transform(frame, **kw)


TargetEncoder = H2OTargetEncoderEstimator
