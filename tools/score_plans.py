"""The forest-scoring kernels' launch plans on the smoke's fitted forests.

    python3 tools/score_plans.py [--parent DIR] [--sweep] [--rows N,N,...]
                                 [--out FILE]

Needs a CUDA card. Fits `chip_smoke.py`'s GBM (1M x 28, depth 6, 20 trees)
and DRF (1M x 28, defaults, 50 trees, depth 19) through its phases 4 and 8,
builds each forest's score table (bytes and build time printed), and at
each N of --rows (default: the smoke's SCORE_ROWS) on rows of the smoke's
generator with 5 % NaN:

* runs the plan `score_cuda.score_plan` picks and, on the GBM's forest, the
  streamed plan too (a resident plan cannot hold the DRF's forest); each
  must equal `predict_forest_ordered` bit for bit. Times: CUDA events with
  the L2 flushed before each call (median of 20; 5 at the DRF's 100k and
  1M rows), and the device time of all the plan's kernels (walk and fold)
  from torch.profiler, L2 warm;
* with --parent DIR: `forest_score` of another checkout (the parent commit
  unpacked with `git archive`, say), loaded from DIR as a package of its
  own and built into DIR's build directory, held within 1e-5 of
  `predict_forest_raw` and timed the same way, in turns with this one
  (parent, this, this, parent; each time is the mean of its two turns);
* at N >= 100,000: the levels the walks end on (`leaf_levels`);
* with --sweep, at N >= 100,000: `forest_score`'s own plan, timed the
  same way before and after the sweep (its drift bounds the sweep's);
  the resident plan on the GBM's forest
  with its rows staged in shared memory and read from global memory; the
  streamed plan on the DRF's forest over the trees per chunk (1, 2, 4:
  score.cu compiled once for each with -DSCORE_STREAM_CHUNK, into the
  package's build directory), the staged levels and the rows per block
  (half, once and twice `stream_rows_per_block`'s), rows staged or not;
  each launched through the C entries with those sizes, timed by CUDA
  events, L2 warm (median of 10 at the DRF's sizes, else 20), each checked
  bit for bit.

Prints the build's `-Xptxas -v` report and one JSON line per case; with
--out the lines also go to FILE.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from h2o3_tpu_torch.models.tree import (forest_leaves,  # noqa: E402
                                        predict_forest_ordered,
                                        predict_forest_raw)
from h2o3_tpu_torch.ops import hist_cuda, score_cuda  # noqa: E402

CHUNKS = (1, 2, 4)
LEVELS = (8, 10, 11, 12, 13)


def load_score_cuda(root: str):
    """`h2o3_tpu_torch/ops/score_cuda.py` of the checkout at `root`, its
    package loaded under a name of its own (its sources and build
    directory are root's)."""
    name = "other_h2o3_tpu_torch"
    pkg_dir = os.path.join(root, "h2o3_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.ops.score_cuda")


def chunk_library(chunk: int):
    """score.cu built with SCORE_STREAM_CHUNK = chunk (a copy of its text
    with the define in front, in the package's build directory)."""
    src = hist_cuda.BUILD_DIR / f"score_chunk{chunk}.cu"
    hist_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(f"#define SCORE_STREAM_CHUNK {chunk}\n"
                   + score_cuda.SOURCE.read_text())
    lib, _ = hist_cuda.build_library(src, f"h2o3score_c{chunk}")
    return score_cuda.bind(lib)


def sweep_launchers(nt, depth, n, sms, name):
    """(sizes, launch) pairs that --sweep times: on the GBM's forest the
    resident plan with and without its rows staged; on the DRF's the
    streamed plan over CHUNKS x LEVELS x rows per block (half, once and
    twice the default's), with and without its rows staged, where it fits
    a block. launch(pack, forest, X) returns the scores."""
    F = smoke.N_FEAT
    x_tile = score_cuda._x_tile_bytes(F)

    def resident(stage_x):
        smem = score_cuda.resident_bytes(nt, depth) + (x_tile if stage_x else 0)
        grid = min(-(-n // score_cuda.THREADS),
                   score_cuda._blocks_per_sm(smem) * sms)

        def launch(pack, forest, X):
            out = torch.empty(n, device=X.device)
            rc = score_cuda.build().h2o3_forest_score_resident(
                pack.nodes.data_ptr(), forest.value.data_ptr(), X.data_ptr(),
                out.data_ptr(), n, F, nt, forest.feat.shape[1], depth,
                int(stage_x), grid, smem,
                torch.cuda.current_stream().cuda_stream)
            hist_cuda.check_launch(rc, "resident sweep")
            return out
        return dict(kind="resident", stage_x=stage_x, grid=grid,
                    smem=smem), launch

    def streamed(lib, chunk, levels, rpb, stage_x):
        sl = min(levels, depth)
        smem = (score_cuda.RECORD_BYTES * chunk * (2 ** sl - 1)
                + (x_tile if stage_x else 0))

        def launch(pack, forest, X):
            out = torch.empty(n, device=X.device)
            scratch = torch.empty((nt, n), device=X.device)
            rc = lib.h2o3_forest_score_streamed(
                pack.nodes.data_ptr(), forest.value.data_ptr(), X.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), n, F, nt,
                forest.feat.shape[1], depth, levels, rpb, int(stage_x), smem,
                torch.cuda.current_stream().cuda_stream)
            hist_cuda.check_launch(rc, "streamed sweep")
            return out
        return dict(kind="streamed", chunk=chunk, staged_levels=levels,
                    rows_per_block=rpb, stage_x=stage_x, smem=smem), launch

    if name == "gbm":
        return [resident(sx) for sx in (True, False)]
    rpb0 = score_cuda.score_plan(nt, depth, F, n, sms).rows_per_block
    out = []
    for chunk in CHUNKS:
        lib = chunk_library(chunk)
        for levels in LEVELS:
            for rpb in sorted({max(256, rpb0 // 2), rpb0, 2 * rpb0}):
                for sx in (True, False):
                    sizes, launch = streamed(lib, chunk, levels, rpb, sx)
                    if sizes["smem"] <= hist_cuda.SMEM_MAX:
                        out.append((sizes, launch))
    return out


def leaf_levels(forest, X, depth) -> dict:
    """Where the walks of X end: the mean level of the leaf each (tree, row)
    reaches, and the share of walks reaching each level from 8 down."""
    level = torch.floor(torch.log2((forest_leaves(forest, X, depth)
                                    + 1).double()))
    return dict(mean=float(level.mean()),
                share_at_least={d: float((level >= d).double().mean())
                                for d in range(8, depth + 1)})


def emit(rec: dict, out) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of another checkout to time")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--rows", default=",".join(map(str, smoke.SCORE_ROWS)))
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("score_plans: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(card, flush=True)
    out = open(args.out, "w") if args.out else None
    score_cuda.build()
    print(score_cuda.build_log.strip(), flush=True)
    other = load_score_cuda(args.parent) if args.parent else None
    if other is not None:
        other.build()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    _, fr, gbm = smoke.main_path(dev)
    _, drf = smoke.drf_path(dev, fr)
    del fr
    rng = smoke.np.random.default_rng(17)
    for name, model in (("gbm", gbm), ("drf", drf)):
        forest, depth = model.forest[0], model.max_depth
        nt = int(forest.feat.shape[0])
        torch.cuda.synchronize()
        t0 = smoke.time.perf_counter()
        pack = score_cuda.build_score_pack(forest, smoke.N_FEAT)
        torch.cuda.synchronize()
        emit(dict(card=card, forest=name, trees=nt, depth=depth,
                  pack_bytes=pack.nodes.numel() * pack.nodes.element_size(),
                  pack_build_ms=(smoke.time.perf_counter() - t0) * 1e3,
                  walk_nodes=dict(zip(("above_last_level", "split", "leaves"),
                                      smoke.walk_nodes(forest, depth)))),
             out)
        for n in map(int, args.rows.split(",")):
            X = torch.from_numpy(smoke.score_rows(rng, n)).to(dev)
            want = predict_forest_ordered(forest, X, depth)
            raw = predict_forest_raw(forest, X, depth)
            big = n >= 100_000 and depth > 10
            reps, dreps = (5, 8) if big else (20, 20)
            kinds = ["resident", "streamed"] if name == "gbm" else ["streamed"]
            bound, nbytes = smoke.score_bound_ms(forest, depth, n)
            base = dict(card=card, forest=name, N=n, bound_ms=bound,
                        bytes=nbytes,
                        default=score_cuda.score_plan(nt, depth, smoke.N_FEAT,
                                                      n, sms).kind)
            for kind in kinds:
                plan = score_cuda.score_plan(nt, depth, smoke.N_FEAT, n, sms,
                                             kind=kind)

                def run(kind=kind):
                    return score_cuda.forest_score(forest, X, depth, pack=pack,
                                                   kind=kind)

                if not torch.equal(run(), want):
                    raise AssertionError(f"{kind} plan on {name} at N={n} "
                                         "differs from predict_forest_ordered")
                if other is not None:
                    def parent():
                        return other.forest_score(forest, X, depth)

                    got = parent()
                    torch.cuda.synchronize()
                    scale = max(1.0, float(raw.abs().max()))
                    err = float((got - raw).abs().max())
                    if not err <= 1e-5 * scale:
                        raise AssertionError(f"parent kernel on {name} at "
                                             f"N={n}: max |err| {err:.3e}")
                    turns = [smoke.time_ms_cold(f, reps=reps)
                             for f in (parent, run, run, parent)]
                    rec = dict(base, plan=kind, ms=(turns[1] + turns[2]) / 2,
                               parent_ms=(turns[0] + turns[3]) / 2,
                               turns_ms=turns)
                    rec["parent_device_ms"], _, _ = smoke.kernel_device_ms(
                        parent, "forest_score", reps=dreps)
                else:
                    rec = dict(base, plan=kind,
                               ms=smoke.time_ms_cold(run, reps=reps))
                rec["device_ms"], rec["device_kernels"], rec["by_kernel"] = \
                    smoke.kernel_device_ms(run, "forest_score_", reps=dreps)
                rec["plan_args"] = plan._asdict()
                emit(rec, out)
            if n >= 100_000:
                emit(dict(base, leaf_levels=leaf_levels(forest, X, depth)),
                     out)
            if args.sweep and n >= 100_000:
                def default():
                    return score_cuda.forest_score(forest, X, depth, pack=pack)

                sreps = 10 if big else 20
                launchers = sweep_launchers(nt, depth, n, sms, name)
                ref = [smoke.time_ms(default, reps=sreps)]
                for sizes, launch in launchers:
                    def run(launch=launch):
                        return launch(pack, forest, X)

                    if not torch.equal(run(), want):
                        raise AssertionError(f"{sizes} differs")
                    emit(dict(base, sweep=True, **sizes,
                              warm_ms=smoke.time_ms(run, reps=sreps)), out)
                ref.append(smoke.time_ms(default, reps=sreps))
                emit(dict(base, sweep=True, kind="default",
                          warm_ms_before_after=ref), out)
            del X, want, raw
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
