"""AUC floor for the DRF phase of `chip_smoke.py`, from the JAX package.

    JAX_PLATFORMS=cpu python tools/drf_auc_floor.py [n_rows] [ntrees]

Trains the reference `H2ORandomForestEstimator` (the JAX package, on the
CPU) at its defaults with the smoke's `ntrees=50, seed=42` on `n_rows`
(default 100,000) rows of the bench's HIGGS-like generator, and scores
100,000 fresh rows (generator seed 1). Prints one JSON line with the
out-of-bag training AUC, the holdout AUC and the floor `min(both) - 0.01`.
On the CPU the reference runs its `segment` or `host` histogram method
(the Pallas kernels need a TPU; they build the same forest up to their
bf16 rounding), and clamps the depth to 17 for its 8 GB budget.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h2o3_tpu.frame.frame import Frame  # noqa: E402
from h2o3_tpu.models.drf import H2ORandomForestEstimator  # noqa: E402
from h2o3_tpu.models.metrics import ModelMetricsBinomial  # noqa: E402


def make_higgs_like(n_rows: int, n_feat: int = 28, seed: int = 0):
    """bench.py::make_higgs_like."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    logits = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 1.5 * X[:, 2] * X[:, 3]
              + 0.7 * np.sin(3 * X[:, 4]) + 0.5 * (X[:, 5] ** 2 - 1))
    y = (rng.random(n_rows) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


def main() -> int:
    n_rows = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    ntrees = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    names = [f"f{i}" for i in range(28)] + ["label"]
    X, y = make_higgs_like(n_rows)
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    drf = H2ORandomForestEstimator(ntrees=ntrees, seed=42)
    t0 = time.time()
    drf.train(y="label", training_frame=fr)
    fit_s = time.time() - t0
    Xt, yt = make_higgs_like(100_000, seed=1)
    ft = Frame.from_numpy(np.column_stack([Xt, yt]), names=names).asfactor("label")
    p1 = np.asarray(drf.predict(ft).vec("1").data, np.float64)
    holdout = ModelMetricsBinomial.make(yt.astype(np.int64), p1).auc
    oob = float(drf.auc())
    print(json.dumps(dict(n_rows=n_rows, ntrees=ntrees,
                          max_depth=int(drf.model.max_depth), fit_s=fit_s,
                          oob_auc=oob, holdout_auc=float(holdout),
                          floor=min(oob, float(holdout)) - 0.01)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
