"""CPU rehearsal of the smoke's phase 38 (`chip_smoke.py`): the numbers its
bars are set from, on the port with `device="cpu"`.

    python tools/phase38_rehearsal.py [--parts te,w2v,agg,lg] [--rows N]
        [--w2v-lr LR ...] [--threads T]

- te: TargetEncoder (38(a)'s parameters) on `make_airlines_gam_like`
  rows, then phase 4's GBM on DepTime, Distance and the two encodings
  against the same GBM on the raw enums and on DepTime and Distance
  alone: the three holdout AUCs and the gaps (38(a)'s bar, TE_RAW_TOL).
- w2v: Word2Vec at 38(b)'s parameters (W2V38) on `make_text8_like`
  tokens, once per `--w2v-lr` given (default: W2V38's): the vocabulary, pairs and steps, the host parts'
  walls, and each planted word's top synonym (38(b)'s bar).
- agg: Aggregator at its defaults on phase 14's Covertype frame cut to
  `--agg-rows` (AGG_ROWS): the passes, exemplars, and the walls of the
  block pass and the host loop (the host loop is the same code on the
  card).
- lg: XGBoost_1 depthwise against lossguide with 31 leaves (38(e)) at
  `--rows` rows: both holdout AUCs on 100,000 fresh rows, and the gap.

Each part prints one JSON line. On 8 CPUs the whole run takes several
minutes; `--rows` cuts (e)'s frame.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def te_part():
    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2OTargetEncoderEstimator)

    fr, fh, yh = cs.te_airlines_frames()
    t0 = time.perf_counter()
    te = H2OTargetEncoderEstimator(device="cpu", columns=cs.TE_COLS, **cs.TE38)
    te.train(x=cs.TE_COLS, y="IsDepDelayed", training_frame=fr)
    tr = te.model.transform(fr, as_training=True)
    th = te.model.transform(fh)
    rec = dict(rows=cs.TE_ROWS, encode_s=time.perf_counter() - t0)
    te_cols = [f"{c}_te" for c in cs.TE_COLS]
    for tag, frame, hold, x in (
            ("raw", fr, fh, ["DepTime", "Distance"] + cs.TE_COLS),
            ("te", tr, th, ["DepTime", "Distance"] + te_cols),
            ("numeric", fr, fh, ["DepTime", "Distance"])):
        t0 = time.perf_counter()
        g = H2OGradientBoostingEstimator(device="cpu", **cs.TE_GBM)
        g.train(x=x, y="IsDepDelayed", training_frame=frame)
        p1 = g.predict(hold).vec("YES").numeric_np()
        rec[f"auc_{tag}"] = cs._auc(yh, p1)
        rec[f"gbm_{tag}_s"] = time.perf_counter() - t0
    rec["gap_raw"] = rec["auc_te"] - rec["auc_raw"]
    rec["gap_numeric"] = rec["auc_te"] - rec["auc_numeric"]
    print("te: " + json.dumps(rec), flush=True)


def w2v_part(lrs):
    from h2o3_tpu_torch.estimators import H2OWord2vecEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.frame.vec import Vec

    t0 = time.perf_counter()
    words, groups = cs.make_text8_like(cs.W2V_TOKENS, 38)
    fr = Frame({"words": Vec(None, "string", strings=words)})
    gen_s = time.perf_counter() - t0
    for lr in lrs:
        params = dict(cs.W2V38, init_learning_rate=lr)
        t0 = time.perf_counter()
        m = H2OWord2vecEstimator(device="cpu", **params).train(
            training_frame=fr).model
        wall = time.perf_counter() - t0
        tops = {w: list(m.find_synonyms(w, 1)) for g in groups for w in g}
        inside = sum(t[0] in g for g in groups for w in g
                     for t in [tops[w]] if t)
        print("w2v: " + json.dumps(dict(
            lr=lr, generate_s=gen_s, wall_s=wall, fit_split=m.fit_timings,
            **m.fit_stats, top_in_group=inside,
            planted=sum(len(g) for g in groups),
            tops={w: t[0] if t else None for w, t in tops.items()})),
            flush=True)


def agg_part(rows):
    from h2o3_tpu_torch.estimators import H2OAggregatorEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    X, _ = cs.make_covtype_like(cs.COV_ROWS, 5)
    fr = Frame.from_numpy(X[:rows], names=cs.COV_NAMES)
    t0 = time.perf_counter()
    m = H2OAggregatorEstimator(device="cpu", **cs.AGG38).train(
        x=cs.COV_NAMES, training_frame=fr).model
    print("agg: " + json.dumps(dict(
        rows=rows, wall_s=time.perf_counter() - t0,
        fit_split=m.fit_timings, passes=m.passes,
        exemplars=len(m.exemplar_idx))), flush=True)


def lg_part(rows):
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    names = [f"f{i}" for i in range(cs.N_FEAT)]
    X, y = cs.make_higgs_like(rows)
    fr = Frame.from_numpy(np.column_stack([X, y]),
                          names=names + ["label"]).asfactor("label")
    Xt, yt = cs.make_higgs_like(cs.XGB_PREDICT_ROWS, seed=1)
    ft = Frame.from_numpy(np.column_stack([Xt, yt]),
                          names=names + ["label"]).asfactor("label")
    rec = dict(rows=rows)
    for tag, params in (("depthwise", cs.XGB_1), ("lossguide", cs.LG38)):
        t0 = time.perf_counter()
        m = H2OXGBoostEstimator(seed=42, device="cpu", **params).train(
            y="label", training_frame=fr).model
        rec[f"{tag}_s"] = time.perf_counter() - t0
        rec[f"auc_{tag}"] = cs._auc(yt, m.predict(ft).vec("1").numeric_np())
    rec["gap"] = rec["auc_lossguide"] - rec["auc_depthwise"]
    print("lg: " + json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="te,w2v,agg,lg")
    ap.add_argument("--rows", type=int, default=cs.N_ROWS)
    ap.add_argument("--w2v-lr", type=float, nargs="*",
                    default=[cs.W2V38["init_learning_rate"]])
    ap.add_argument("--agg-rows", type=int, default=cs.AGG_ROWS)
    ap.add_argument("--threads", type=int, default=0)
    a = ap.parse_args()
    if a.threads:
        torch.set_num_threads(a.threads)
    parts = a.parts.split(",")
    if "te" in parts:
        te_part()
    if "w2v" in parts:
        w2v_part(a.w2v_lr)
    if "agg" in parts:
        agg_part(a.agg_rows)
    if "lg" in parts:
        lg_part(a.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
