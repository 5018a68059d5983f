"""The TreeSHAP kernel on the smoke's fitted forests.

    python3 tools/shap_replay.py [--parent DIR] [--drf-rows N,N,...]
                                 [--out FILE]

Needs a CUDA card. Prints the `-Xptxas -v` report of the kernel's depth
buckets (registers, stack, spills), fits `chip_smoke.py`'s GBM (1M x 28,
depth 6, 20 trees) and DRF (1M x 28, defaults, 50 trees, depth 19) through
its phases 4 and 8, builds each forest's path plan (`build_shap_plan`:
bytes, leaves, steps, build time) and times `shap_cuda.tree_shap` with the
plan prebuilt, by CUDA events (median of 5; 1 at the DRF's), on rows of
the smoke's generator with 5 % NaN: the GBM on 100,000 rows, the DRF at
each N of --drf-rows (default 1,000 and 10,000). Each time stands beside
its FP64 bound (`chip_smoke.shap_bound_ms`: `shap_ops` over 17e12 ops/s)
and the replay's own count (`chip_smoke.replay_ops`).

With --parent DIR: `shap_cuda.tree_shap` of another checkout
(the parent commit unpacked with `git archive`, say), loaded from DIR as a
package of its own and built into DIR's build directory. Its output must
equal this one's bit for bit (both are bit-equal twins of
`tree_shap_plain`), and it is timed in turns with this one (parent, this,
this, parent; each time the mean of its two turns) at the GBM's 100,000
rows and at the DRF's smallest N. At that N the DRF's tree with the most
leaves is also timed alone, as a forest of one tree: all trees' blocks
run at once there, so one tree's warps can set the whole call's time.
One JSON line per case; with --out the lines also go to FILE.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from h2o3_tpu_torch.models import tree_shap as ts  # noqa: E402
from h2o3_tpu_torch.ops import shap_cuda  # noqa: E402


def load_shap_cuda(root: str):
    """`h2o3_tpu_torch/ops/shap_cuda.py` of the checkout at `root`, its
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
    return importlib.import_module(f"{name}.ops.shap_cuda")


def emit(rec: dict, out) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of another checkout to time")
    ap.add_argument("--drf-rows", default="1000,10000")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shap_replay: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(card, flush=True)
    out = open(args.out, "w") if args.out else None
    t0 = time.perf_counter()
    shap_cuda.build()
    other = load_shap_cuda(args.parent) if args.parent else None
    if other is not None:
        other.build()
    emit(dict(card=card, build_s=time.perf_counter() - t0,
              ptxas=smoke.shap_ptxas(shap_cuda.build_log)), out)

    _, fr, gbm = smoke.main_path(dev)
    _, drf = smoke.drf_path(dev, fr)
    del fr
    rng = smoke.np.random.default_rng(23)
    F = smoke.N_FEAT
    for name, model, rows in (
            ("gbm", gbm, [smoke.SHAP_ROWS]),
            ("drf", drf, [int(n) for n in args.drf_rows.split(",")])):
        forest, cover = model.forest[0], model.covers[0]
        depth = model.max_depth
        scale = 1.0 / model.ntrees_built if model.mode == "drf" else 1.0
        bias = ts.forest_bias(forest, cover, scale)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = ts.build_shap_plan(forest, cover, F)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        dfs, replay = (smoke.shap_ops(forest, depth, F),
                       smoke.replay_ops(forest, depth, F))
        emit(dict(card=card, forest=name, trees=model.ntrees_built,
                  depth=depth, plan_bytes=plan.nbytes(),
                  plan_build_ms=build_ms, leaves=int(plan.leaf_level.numel()),
                  steps=int(plan.step_zin.numel()), shap_ops_per_row=dfs,
                  replay_ops_per_row=replay, replay_over_dfs=replay / dfs),
             out)
        for i, n in enumerate(rows):
            X = torch.from_numpy(smoke.np.ascontiguousarray(
                smoke.score_rows(rng, n), smoke.np.float64)).to(dev)
            reps = 5 if name == "gbm" else 1
            last = {}

            def run():
                last["this"] = shap_cuda.tree_shap(forest, cover, X, scale,
                                                   bias, plan=plan)

            bound, by, ops, _ = smoke.shap_bound_ms(forest, depth, F, n)
            rec = dict(card=card, forest=name, rows=n, bound_ms=bound,
                       bound_by=by,
                       replay_bound_ms=replay * n / smoke.FP64_OPS_PER_S * 1e3)
            if other is None or i > 0:
                rec["ms"] = smoke.time_ms(run, reps=reps, warmup=1)
            else:
                def parent():
                    last["parent"] = other.tree_shap(forest, cover, X, scale,
                                                     bias)

                turns = [smoke.time_ms(f, reps=reps, warmup=1)
                         for f in (parent, run, run, parent)]
                same = (torch.equal(last["this"].isnan(),
                                    last["parent"].isnan())
                        and torch.equal(last["this"].nan_to_num(),
                                        last["parent"].nan_to_num()))
                if not same:
                    raise AssertionError(f"{name} at {n} rows: the kernel "
                                         "differs from the parent's")
                rec.update(ms=(turns[1] + turns[2]) / 2,
                           parent_ms=(turns[0] + turns[3]) / 2,
                           turns_ms=turns, equal_to_parent=same)
            rec["x_bound"] = rec["ms"] / bound
            if name == "drf" and i == 0:
                per = (plan.tree_leaf[1:] - plan.tree_leaf[:-1]).cpu()
                t = int(per.argmax())
                one = type(forest)(*[f[t:t + 1].contiguous() for f in forest])
                c1 = cover[t:t + 1].contiguous()
                p1 = ts.build_shap_plan(one, c1, F)
                b1 = ts.forest_bias(one, c1, scale)
                rec["heaviest_tree"] = dict(
                    index=t, leaves=int(per[t]),
                    leaves_mean=float(per.double().mean()),
                    ms=smoke.time_ms(lambda: shap_cuda.tree_shap(
                        one, c1, X, scale, b1, plan=p1), reps=1, warmup=1))
            emit(rec, out)
            del X, last
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
