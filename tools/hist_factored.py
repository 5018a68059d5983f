"""The feature-major histogram kernel (B1, `hist_cuda.hist_build`) at each
pass of a depth-6 tree, on uniform codes and on the smoke frame's own codes.

    python3 tools/hist_factored.py [--parent DIR] [--sweep] [--profile]
                                   [--sass] [--out FILE]

Needs a CUDA card. At N = 1,000,000 rows, F = 28, B = 21, with
`chip_smoke.py`'s fixtures (`pass_inputs`, `fit_codes`, `bound_ms_of`), it
checks every run (bit for bit against `hist_plain_fixed`, within rtol 1e-5 /
atol 1e-5·max of `hist_plain`) and times it by CUDA events with the L2
flushed before each launch (median of 20 launches after 3 warm-up ones):

* the plan `block_plan` picks, at each pass (L = 1, 1, 2, 4, 8, 16) and at
  the deep L = 1024 pass;
* with --parent DIR: the same entry of another checkout of the repo (the
  parent commit unpacked with `git archive`, say), loaded from DIR and built
  into DIR's own build directory, timed in turns with this one (parent,
  this, this, parent; each time is the mean of its two turns);
* with --sweep: rows per tile (`hist_cuda.TILE_ROWS`), threads per block
  (`THREADS`) and the least rows per block (`MIN_ROWS_PER_BLOCK`) over a
  grid, and alone, at the others' defaults, the shared-memory budget
  (`SMEM_PAIR` set to the opt-in window: one block per SM in place of two)
  and smaller tiles and blocks;
* with --profile: the device time of each of the pass's kernels (and the
  memset) by torch.profiler over 5 passes, on uniform codes.

--sass prints the atomic instructions `cuobjdump -sass` finds in each kernel
of the built library, and the build's `-Xptxas -v` report (registers,
spills, shared memory). One JSON line per pass and code law; with --out
the lines also go to FILE.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as smoke  # noqa: E402
from h2o3_tpu_torch.ops import hist_cuda  # noqa: E402
from hist_rows_routes import kernel_ms, load_hist_cuda, sass_atomics  # noqa: E402

SWEEP = dict(TILE_ROWS=(512, 1024), THREADS=(512, 1024),
             MIN_ROWS_PER_BLOCK=(1024, 4096))
# swept alone, at the others' defaults
SWEEP_ALONE = dict(SMEM_PAIR=(hist_cuda.SMEM_MAX,), TILE_ROWS=(256,),
                   THREADS=(256,))


def timed(build, codes, node, vals, L, fixed=None, ref=None) -> float:
    """Median cold ms of build(codes, node, vals, L, B), after checking one
    run: bit-equal to `fixed` when given, else within tolerance of `ref`."""
    got = build(codes, node, vals, L, smoke.NBINS)
    torch.cuda.synchronize()
    if fixed is not None:
        if not torch.equal(got, fixed):
            raise AssertionError(f"L={L}: differs from hist_plain_fixed")
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
    del got
    return smoke.time_ms_cold(lambda: build(codes, node, vals, L, smoke.NBINS))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of another checkout to time")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(smoke.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    hist_cuda.build()
    other = load_hist_cuda(args.parent) if args.parent else None
    if other is not None:
        other.build()
    sink = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    if args.sass:
        emit({"sass_atomics": {k: v for k, v in sass_atomics().items()
                               if "hist_rows_" not in k}})
        emit({"ptxas": [ln for ln in hist_cuda.build_log.splitlines()
                        if "ptxas" in ln and "hist_rows_" not in ln]})
    N, F, B = smoke.N_ROWS, smoke.N_FEAT, smoke.NBINS
    rng = np.random.default_rng(5)
    laws = {"uniform": torch.from_numpy(
        rng.integers(0, B, (F, N), dtype=np.uint8)).to(dev),
        "fit": smoke.fit_codes(dev)}
    sizes = {k: getattr(hist_cuda, k) for k in {**SWEEP, **SWEEP_ALONE}}
    this = hist_cuda.hist_build
    wrong = []
    for L, sibling in smoke.PASSES + [(smoke.DEEP_L, True)]:
        node, vals = smoke.pass_inputs(rng, dev, L, sibling)
        n_w = int((vals[0] != 0).sum())
        for law, codes in laws.items():
            fixed = hist_cuda.hist_plain_fixed(codes, node, vals, L, B)
            ref = hist_cuda.hist_plain(codes, node, vals, L, B)
            p = hist_cuda.block_plan(L, B, F, N)
            rec = dict(L=L, sibling=sibling, law=law, weighted_rows=n_w,
                       bound_ms=smoke.bound_ms_of(n_w, L)[0],
                       plan=p._asdict())
            if other is None:
                rec["ms"] = timed(this, codes, node, vals, L, fixed)
            else:
                turns = [timed(fn, codes, node, vals, L,
                               fixed if fn is this else None, ref)
                         for fn in (other.hist_build, this, this,
                                    other.hist_build)]
                rec["parent_ms"] = (turns[0] + turns[3]) / 2
                rec["ms"] = (turns[1] + turns[2]) / 2
                rec["turns_ms"] = turns
            if args.sweep:
                sweep = {}
                grid = [dict(zip(SWEEP, v))
                        for v in itertools.product(*SWEEP.values())]
                grid += [{k: v} for k, vs in SWEEP_ALONE.items() for v in vs]
                try:
                    for cfg in grid:
                        for k, v in cfg.items():
                            setattr(hist_cuda, k, v)
                        key = "_".join(f"{k}{v}" for k, v in cfg.items())
                        try:
                            sweep[key] = timed(this, codes, node, vals, L,
                                               fixed)
                        except AssertionError as e:    # keep sweeping
                            sweep[key] = f"wrong: {e}"
                            wrong.append((L, law, key))
                        for k, v in sizes.items():
                            setattr(hist_cuda, k, v)
                finally:
                    for k, v in sizes.items():
                        setattr(hist_cuda, k, v)
                rec["sweep_ms"] = sweep
            if args.profile and law == "uniform":
                rec["kernels_ms"] = kernel_ms(
                    lambda: this(codes, node, vals, L, B))
            del fixed, ref
            emit(rec)
    if sink:
        sink.close()
    if wrong:
        print(f"configurations that differ from hist_plain_fixed: {wrong}",
              file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
