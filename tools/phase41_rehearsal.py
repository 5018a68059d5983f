"""CPU rehearsal of the smoke's phase 41(c) (`chip_smoke.py`): the numbers
its AUC bars are set from, on the port with `device="cpu"`.

    python tools/phase41_rehearsal.py [--rows N] [--positives K]
        [--trees T] [--seeds S,...] [--threads T]

Draws `make_creditcard_labelled` at `--rows` rows with `--positives`
positives (default a quarter of the dataset's 284,807 and 492, the same
rate), splits it as the smoke does (CC41_SPLIT) and fits (c)'s DRF
(CC41_DRF: sample_rate_per_class [0.1, 1.0], default depth) on the
training part, once per generator seed. Prints one JSON line a seed: the
out-of-bag and holdout AUCs, the generator's own AUCs on the same rows,
and the gaps (generator less forest). CC41_DRF_FLOORS is set under the
lowest of them.
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


def run(rows: int, positives: int, trees: int, seed: int) -> dict:
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.metrics import auc_exact

    X, y, p = cs.make_creditcard_labelled(seed, n=rows, positives=positives)
    fr = Frame.from_numpy(np.column_stack([X, y]),
                          names=cs.CC_NAMES + ["Class"]).asfactor("Class")
    perm = np.random.default_rng(seed + 1).permutation(rows)
    a = int(cs.CC41_SPLIT[0] * rows)
    b = int((cs.CC41_SPLIT[0] + cs.CC41_SPLIT[1]) * rows)
    tr, ho = np.sort(perm[:a]), np.sort(perm[b:])
    t0 = time.perf_counter()
    est = H2ORandomForestEstimator(device="cpu",
                                   **dict(cs.CC41_DRF, ntrees=trees))
    est.train(y="Class", training_frame=fr.take(tr))
    wall = time.perf_counter() - t0
    p1 = np.asarray(est.model.predict(fr.take(ho)).vec("1").data, np.float64)
    rec = dict(rows=rows, positives=positives, trees=trees, seed=seed,
               max_depth=est.model.max_depth, fit_s=wall,
               oob_auc=float(est.model.training_metrics.auc),
               generator_train_auc=auc_exact(y[tr], p[tr]),
               holdout_auc=auc_exact(y[ho], np.round(p1, 6)),
               generator_holdout_auc=auc_exact(y[ho], p[ho]))
    rec["oob_gap"] = rec["generator_train_auc"] - rec["oob_auc"]
    rec["holdout_gap"] = rec["generator_holdout_auc"] - rec["holdout_auc"]
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=cs.CC_ROWS // 4)
    ap.add_argument("--positives", type=int, default=cs.CC_FRAUD // 4)
    ap.add_argument("--trees", type=int, default=cs.CC41_DRF["ntrees"])
    ap.add_argument("--seeds", default="41")
    ap.add_argument("--threads", type=int, default=2)
    a = ap.parse_args()
    torch.set_num_threads(a.threads)
    for seed in (int(s) for s in a.seeds.split(",")):
        print(json.dumps(run(a.rows, a.positives, a.trees, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
