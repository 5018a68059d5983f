"""The row-major histogram kernels (B2, `hist_cuda.hist_build_rows`) at every
width of the DRF fit's level plan, on a uniform and a skewed node law.

    python3 tools/hist_rows_routes.py [--parent DIR] [--sweep] [--profile]
                                      [--sass] [--out FILE]

Needs a CUDA card. At N = 1,000,000 rows, F = 28, B = 21, with
`chip_smoke.py`'s fixtures (`drf_widths`, `rows_fixture`, `bound_ms_of`),
it checks each run against `hist_plain_rows` and times it by CUDA events
(median of 20 launches after 3 warm-up launches):

* the plan `rows_plan` picks, at every width and node law;
* with --parent DIR: the same entry of another checkout of the repo (the
  parent commit unpacked with `git archive`, say), loaded from DIR and built
  into DIR's own build directory, timed in turns with this one (parent,
  this, this, parent; each time is the mean of its two turns);
* with --sweep: the plan with G (`hist_cuda.GROUP_NODES`, nodes per group
  at most) and C (`hist_cuda.CHUNK_ROWS`, rows per chunk) set over a grid;
* with --profile: the device time of each of the pass's kernels (and the
  counters' memset), by torch.profiler over 5 passes, on the uniform law.

--sass prints the atomic instructions `cuobjdump -sass` finds in each kernel
of the built library, and the build's `-Xptxas -v` report (registers,
spills, shared memory). One JSON line per width and law; with --out the
lines also go to FILE.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from collections import Counter

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from h2o3_tpu_torch.ops import hist_cuda  # noqa: E402

GROUPS = (1, 2, 4, 8, 16)
CHUNKS = (256, 512, 1024, 2048)


def load_hist_cuda(root: str):
    """`h2o3_tpu_torch/ops/hist_cuda.py` of the checkout at `root`, as a
    module of its own (its source and build directory are root's)."""
    path = os.path.join(root, "h2o3_tpu_torch", "ops", "hist_cuda.py")
    spec = importlib.util.spec_from_file_location("other_hist_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_atomics() -> dict:
    """{kernel: {atomic opcode: count}} from `cuobjdump -sass` of the
    library `hist_cuda.build()` loaded."""
    so = hist_cuda.library_path()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        return {"error": res.stderr.strip()[-500:]}
    out, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = Counter()
            continue
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)",
                             line):
            out[fn][op] += 1
    return {k: dict(v) for k, v in out.items()}


def kernel_ms(fn, reps: int = 5) -> dict:
    """{kernel or memset name: mean device ms per call} of fn() under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = re.sub(r"^.*?(hist_\w+).*$", r"\1", e.name)
            out[name[:60]] += e.time_range.elapsed_us() / 1e3 / reps
    return dict(out)


def checked_ms(build, codes, node, vals, L, ref) -> tuple[float, float]:
    """(max |err| against ref, median ms) of build(codes, node, vals, L, B)."""
    got = build(codes, node, vals, L, smoke.NBINS)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    del got
    return err, smoke.time_ms(
        lambda: build(codes, node, vals, L, smoke.NBINS))


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
        emit({"sass_atomics": sass_atomics()})
        emit({"ptxas": [ln for ln in hist_cuda.build_log.splitlines()
                        if "ptxas" in ln]})
    N, F, B = smoke.N_ROWS, smoke.N_FEAT, smoke.NBINS
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, B, (N, F), dtype=np.uint8)).to(dev)
    g = rng.normal(size=N).astype(np.float32)
    sizes = hist_cuda.GROUP_NODES, hist_cuda.CHUNK_ROWS
    for L, n_fit in smoke.drf_widths():
        for law in ("uniform", "skewed"):
            node_np, w = smoke.rows_fixture(rng, L, law == "skewed")
            node = torch.from_numpy(node_np).to(dev)
            vals = torch.from_numpy(np.stack([w, g * w, w])).to(dev)
            ref = hist_cuda.hist_plain_rows(codes, node, vals, L, B)
            p = hist_cuda.rows_plan(L, B, F, N)
            rec = dict(L=L, law=law, launches=n_fit,
                       bound_ms=smoke.bound_ms_of(int(w.sum()), L)[0],
                       plan=dict(G=p.group_nodes, fb=p.feats_per_block,
                                 C=p.chunk_rows, grid=p.grid,
                                 smem=p.smem))
            this = hist_cuda.hist_build_rows
            if other is None:
                rec["max_abs_err"], rec["ms"] = checked_ms(this, codes, node,
                                                           vals, L, ref)
            else:
                turns = [checked_ms(fn, codes, node, vals, L, ref)
                         for fn in (other.hist_build_rows, this, this,
                                    other.hist_build_rows)]
                rec["parent_max_abs_err"] = max(turns[0][0], turns[3][0])
                rec["max_abs_err"] = max(turns[1][0], turns[2][0])
                rec["parent_ms"] = (turns[0][1] + turns[3][1]) / 2
                rec["ms"] = (turns[1][1] + turns[2][1]) / 2
                rec["turns_ms"] = [t[1] for t in turns]
            if args.sweep:
                sweep = {}
                try:
                    for G in GROUPS:
                        for C in CHUNKS:
                            if G > L:
                                continue
                            hist_cuda.GROUP_NODES = G
                            hist_cuda.CHUNK_ROWS = C
                            sweep[f"G{G}_C{C}"] = checked_ms(
                                this, codes, node, vals, L, ref)[1]
                finally:
                    hist_cuda.GROUP_NODES, hist_cuda.CHUNK_ROWS = sizes
                rec["sweep_ms"] = sweep
            if args.profile and law == "uniform":
                rec["kernels_ms"] = kernel_ms(
                    lambda: this(codes, node, vals, L, B))
            del ref
            emit(rec)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
