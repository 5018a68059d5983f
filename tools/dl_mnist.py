"""DeepLearning on the smoke's MNIST-shaped frame at a chosen epoch count.

    python3 tools/dl_mnist.py [--epochs 10]

Needs a CUDA card. Runs `chip_smoke.py`'s phase 32(a) and (c) with
DL_EPOCHS set to --epochs (the estimator's default, 10, unless given):
`make_mnist_like`'s 60,000 + 10,000 rows of 784 pixels, the default
network (Rectifier, hidden [200, 200], ADADELTA, mini-batch 32), the
fit's split, samples/s, the launches and device time a step from two
profiled fits differenced, the logloss and accuracy, `predict` against
the MOJO and one served batch. The smoke cuts the epochs to keep its own
wall; this script measures the default. Prints the card's name and power
limit and the phase's JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=float, default=10.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dl_mnist: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(card, flush=True)
    smoke.DL_EPOCHS = args.epochs
    t0 = time.perf_counter()
    smoke.dl_mnist_path(dev, card)
    print(f"walls: {json.dumps(smoke.PHASE32_WALLS)}, command "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
