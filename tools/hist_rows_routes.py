"""Both routes of the row-major histogram kernel (B2) at each level width.

    python3 tools/hist_rows_routes.py

Needs a CUDA card. At N = 1,000,000 rows, F = 28, B = 21 (the DRF path's
shape, half the rows weighted as in a sibling pass) it times, for each L,
the route `hist_cuda.rows_plan` picks and the other one where it can run
(the shared route only while one feature's histogram fits shared memory),
by CUDA events (median of 20 launches after 3 warm-up launches). Prints
one JSON line per L; the wrapper's route threshold is read from them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h2o3_tpu_torch.ops import hist_cuda  # noqa: E402

N, F, B = 1_000_000, 28, 21
WIDTHS = [1, 4, 16, 64, 128, 256, 512, 1024, 2048, 4097]


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, B, (N, F), dtype=np.uint8)).to(dev)
    w = (rng.random(N) < 0.5).astype(np.float32)
    g = rng.normal(size=N).astype(np.float32)
    vals = torch.from_numpy(np.stack([w, g * w, w])).to(dev)
    plan = hist_cuda.rows_plan
    for L in WIDTHS:
        node = torch.from_numpy(rng.integers(0, L, N, dtype=np.int32)).to(dev)
        chosen = plan(L, B, F)
        rec = dict(L=L, chosen=chosen[0])
        ref = hist_cuda.hist_plain_rows(codes, node, vals, L, B)
        for route in ("shared", "global"):
            if route == "shared" and chosen[0] == "global":
                continue
            forced = chosen if route == chosen[0] else ("global", 0, 0, 0)
            hist_cuda.rows_plan = lambda *a, _p=forced: _p
            try:
                got = hist_cuda.hist_build_rows(codes, node, vals, L, B)
                torch.cuda.synchronize()
                rec[f"{route}_max_abs_err"] = float((got - ref).abs().max())
                rec[f"{route}_ms"] = time_ms(
                    lambda: hist_cuda.hist_build_rows(codes, node, vals, L, B))
            finally:
                hist_cuda.rows_plan = plan
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
