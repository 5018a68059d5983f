"""AutoML's full plan (BASELINE.json config 5) on the HIGGS-shaped frame.

    python3 tools/automl_higgs.py [--rows 100000] [--nfolds 5] [--small]

Needs a CUDA card. Runs `chip_smoke.py`'s phase 33(a) at a size the smoke
cannot afford: `make_higgs_like`'s --rows rows of 28 features and a binary
label, `H2OAutoML` with no time budget and --nfolds-fold CV through every
step of the plan (XGBoost_1-3, GLM_1, DRF_1, XRT_1, GBM_1-5,
DeepLearning_1-3, the three random grids, both stacked ensembles). Prints
the card's name and power limit, the leaderboard, each candidate's wall
and phase split from the train pool's records, the family totals, the
pool's occupancy, peak device memory, and the device's busy share over the
AutoML run, read as the mean of `nvidia-smi`'s utilization.gpu (the share
of each sample period in which a kernel ran) sampled every 200 ms beside
it. With --small it runs phase 33(b) too (card vs CPU, and the grid at
parallelism 2 vs 1), its CPU run in a child process beside the AutoML.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


class BusySampler:
    """`nvidia-smi`'s utilization.gpu of card 0, sampled every `ms`
    milliseconds by a child process for as long as the block runs."""

    def __init__(self, ms: int = 200):
        self.ms = ms
        self.samples: list = []

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-i", "0", f"-lms={self.ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.samples.append(float(line.strip()))
            except ValueError:
                pass

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)
        return False

    def share(self):
        return (sum(self.samples) / len(self.samples) / 100.0
                if self.samples else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--nfolds", type=int, default=5)
    ap.add_argument("--small", action="store_true",
                    help="also run phase 33(b): card vs CPU, the grid at "
                    "parallelism 2 vs 1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("automl_higgs: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    if args.small:
        smoke.automl_cpu_start()     # 33(b)'s CPU run, beside phase 33(a)
    with BusySampler() as busy:
        rec = smoke.automl_path(dev, card, rows=args.rows,
                                nfolds=args.nfolds, tag="automl_higgs")
    print(f"automl_higgs on {card}: AutoML {rec['wall_s']:.3f} s, device "
          f"busy share {busy.share()} (mean of {len(busy.samples)} "
          "nvidia-smi utilization.gpu samples, 200 ms apart, over the whole "
          "phase)", flush=True)
    if args.small:
        smoke.automl_small_checks(dev, card)
    print(f"walls: {json.dumps(smoke.PHASE33_WALLS)}, command "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
