"""Chip smoke for the PyTorch/CUDA port (h2o3_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. The card's name and power limit (nvidia-smi).
2. Build the histogram kernel (csrc/hist.cu) with nvcc and time the build.
3. Kernel vs its plain PyTorch versions at the bench shape (N = 1,000,000
   rows, F = 28 features, B = 21 bins) for each of a depth-6 tree's six
   passes (the root pass with every row weighted; the sibling passes with
   about half the rows at zero weight, as `build_tree` hands them over),
   from seeded numpy inputs, on two code laws: uniform random codes and the
   smoke frame's own UniformAdaptive codes (most rows in a few central
   bins). The kernel must equal `hist_plain_fixed` bit for bit, give the
   same bits on a second launch, lie within the tolerance of `hist_plain`
   (f32), and lie no farther from an f64 sum than `hist_plain` does in each
   channel (w, g·w, h·w); both errors against f64 are printed per channel.
   Times: the kernel's on both laws, with the L2 flushed before each
   launch, the plain version's and one `index_add_` call's, and the bound.
   Then one deep pass (L = 1024, which the kernel splits into node slices)
   is checked the same way, untimed.
4. The main path through the port's public API: a 1M x 28 HIGGS-like
   frame, `asfactor("label")`, a depth-6 UniformAdaptive GBM of 20 trees,
   `auc()`, `predict` on 100k fresh rows. The launch counts are zeroed just
   before and read just after; every level must have launched the kernel.
5. Reference check on a small input: the same fit on cuda and on the CPU
   (plain versions, which the CPU tests hold against the JAX package) must
   give the same forest and predictions.
6. Where the time goes: one more fit at the main path's width, of
   PROFILE_TREES trees, under torch.profiler: the device's busy share of the
   fit's wall time, the kernels that take the most device time, and B1's
   device time summed over its kernels.
7. The row-major kernels (B2) vs their plain version at N = 1,000,000,
   F = 28, B = 21, row-major codes, at every distinct width of the DRF
   fit's level plan (L = 1, 2, 4, ..., 2^17 and the 4097 compaction slots;
   the root at L = 1 with the in-bag 63.2 % of rows weighted, the other
   passes about half), on a uniform node law and on a skewed one (half the
   weighted rows in one node, every fourth node empty): kernel times on
   both, plain and `index_add_` times and the bound on the uniform one.
8. The DRF path through the public API: the 1M x 28 frame, a default
   `H2ORandomForestEstimator(ntrees=DRF_TREES, hist_method="pallas")`
   (depth 20, clamped to the card's memory; mtries, row sampling,
   active-node compaction), OOB `auc()`, `predict` on 100k fresh rows. The
   dispatch must be "pallas" only and the B2 launches must equal the passes
   the level plan predicts plus those of the dense rebuilds; OOB and
   holdout AUC must reach DRF_AUC_FLOOR and equal DRF_AUCS (binary labels
   keep every histogram sum exact, so any right kernel builds this forest).
9. Reference check: a small DRF (4000 x 8, depth 14, level 13 in compact
   slots) on cuda and on the CPU gives the same forest and predictions.
10. Where the DRF fit's time goes: DRF_PROFILE_TREES trees under
   torch.profiler, with B2's device time summed over all its kernels.

Each path is driven with every launch count set to 0 just before it and
read just after. The last line is {"ok": true, "device": {...}}; the line
before it is the kernel table as JSON.
"""

from __future__ import annotations

import json
import math
from collections import Counter
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
N_ROWS, N_FEAT, NBINS, DEPTH, NTREES = 1_000_000, 28, 21, 6, 20
LEVEL_WIDTHS = [1, 1, 2, 4, 8, 16]   # histogram passes of one depth-6 tree
# (L, sibling pass) per pass: a sibling pass weights only the left children
PASSES = [(L, i > 0) for i, L in enumerate(LEVEL_WIDTHS)]
DEEP_L = 1024                        # a depth-11 sibling pass: node slices
PROFILE_TREES = 5
# training AUC of the smoke's GBM on an H100 (PERF.md §5); B1's fixed-point
# sums differ from f32 ones in the last bits, so the fit must stay within
# 1e-3 of it
GBM_AUC = 0.780812
DRF_TREES = 50
# the DRF fit's plan: depth 20 clamped to 19 by the card's memory (phase 8
# reads the depth back), 4096 compact slots; every tree overflows them at 1M
# rows and is rebuilt with dense levels
DRF_DEPTH, DRF_CAP = 19, 4096
DRF_PROFILE_TREES = 2
# the reference DRF (JAX package, CPU) on the same generator at 100k rows:
# OOB AUC 0.80553, holdout AUC 0.81410 (tools/drf_auc_floor.py); less 0.01
DRF_AUC_FLOOR = 0.7955
# OOB and holdout AUC of that fit on an H100 with the reference's exact sums
# (PERF.md §5); a kernel that sums right gives them to 1e-6
DRF_AUCS = (0.832020, 0.837229)


def make_higgs_like(n_rows: int, n_feat: int = 28, seed: int = 0):
    """The bench's HIGGS-like generator (bench.py::make_higgs_like)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_feat)).astype(np.float32)
    logits = (
        1.2 * X[:, 0]
        - 0.8 * X[:, 1]
        + 1.5 * X[:, 2] * X[:, 3]
        + 0.7 * np.sin(3 * X[:, 4])
        + 0.5 * (X[:, 5] ** 2 - 1)
    )
    y = (rng.random(n_rows) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(0)}, power limit not readable"


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_ms_cold(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, by CUDA events around each call,
    with the L2 cache flushed before each call and outside the events: a
    pass's inputs fit the card's 50 MB L2. The flush writes 1 GiB (~0.3 ms),
    so the host has enqueued all of fn()'s launches before the device
    reaches the first event, and the events time the device's work."""
    flush = torch.empty(1 << 28, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def fit_codes(dev):
    """(F, N) uint8 feature-major codes of the main path's frame as its fit
    bins them (UniformAdaptive, 20 bins and the NA bin)."""
    from h2o3_tpu_torch.frame.binning import build_bins

    X, _ = make_higgs_like(N_ROWS)
    bm = build_bins(X, nbins=NBINS, histogram_type="UniformAdaptive", seed=42)
    return torch.from_numpy(np.ascontiguousarray(bm.codes.T)).to(dev)


def pass_inputs(rng, dev, L, sibling):
    """Node ids (N,) int32 and vals (3, N) f32 of one B1 pass: every row
    weighted at the root, about half in a sibling pass; g normal, h
    uniform."""
    w = (rng.random(N_ROWS) < 0.5 if sibling
         else np.ones(N_ROWS, bool)).astype(np.float32)
    g = rng.normal(size=N_ROWS).astype(np.float32)
    h = rng.random(N_ROWS).astype(np.float32)
    vals = torch.from_numpy(np.stack([w, g * w, h * w])).to(dev)
    node = torch.from_numpy(rng.integers(0, L, N_ROWS, dtype=np.int32)).to(dev)
    return node, vals


def channels(errs):
    return "/".join(f"{e:.1e}" for e in errs)


def check_b1(codes, node, vals, L):
    """B1 at one pass against its plain versions; returns (max |kernel -
    hist_plain|, kernel's and hist_plain's max |err| against an f64 sum per
    channel). Raises unless the kernel equals `hist_plain_fixed` bit for
    bit, repeats its bits on a second launch, lies within rtol 1e-5 / atol
    1e-5·max of `hist_plain`, and lies no farther from f64 in any
    channel."""
    from h2o3_tpu_torch.ops import hist_cuda

    got = hist_cuda.hist_build(codes, node, vals, L, NBINS)
    again = hist_cuda.hist_build(codes, node, vals, L, NBINS)
    fixed = hist_cuda.hist_plain_fixed(codes, node, vals, L, NBINS)
    ref = hist_cuda.hist_plain(codes, node, vals, L, NBINS)
    f64 = hist_cuda.hist_plain(codes, node, vals, L, NBINS, torch.float64)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"L={L}: two launches of B1 differ")
    if not torch.equal(got, fixed):
        raise AssertionError(
            f"L={L}: B1 differs from hist_plain_fixed by "
            f"{float((got - fixed).abs().max()):.3e}")
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    err = float((got - ref).abs().max())
    err_k, err_p = ([float(e) for e in
                     (x.double() - f64).abs().reshape(-1, 3).amax(0)]
                    for x in (got, ref))
    if any(k > p for k, p in zip(err_k, err_p)):
        raise AssertionError(
            f"L={L}: B1 lies farther from f64 than hist_plain in a channel "
            f"(w/g·w/h·w): {channels(err_k)} against {channels(err_p)}")
    return err, err_k, err_p


def kernel_vs_plain(dev):
    """Phase 3: per pass of a depth-6 tree, the kernel against its plain
    versions on the same seeded inputs, on uniform codes and on the fit's
    own codes; returns (per-pass rows, max |kernel - hist_plain|)."""
    from h2o3_tpu_torch.ops import hist_cuda

    rng = np.random.default_rng(7)
    laws = {"uniform": torch.from_numpy(
        rng.integers(0, NBINS, (N_FEAT, N_ROWS), dtype=np.uint8)).to(dev),
        "fit": fit_codes(dev)}
    rows, worst = [], 0.0
    for L, sibling in PASSES + [(DEEP_L, True)]:
        node, vals = pass_inputs(rng, dev, L, sibling)
        n_w = int((vals[0] != 0).sum())
        rec = dict(L=L, sibling=sibling, weighted_rows=n_w)
        for law, codes in laws.items():
            err, err_k, err_p = check_b1(codes, node, vals, L)
            worst = max(worst, err)
            tag = "" if law == "uniform" else "fit_"
            rec.update({f"{tag}max_abs_err": err,
                        f"{tag}f64_err": err_k, f"{tag}plain_f64_err": err_p})
            if L == DEEP_L:
                continue
            rec[f"{tag}ms"] = time_ms_cold(
                lambda: hist_cuda.hist_build(codes, node, vals, L, NBINS))
        if L == DEEP_L:
            p = hist_cuda.block_plan(L, NBINS, N_FEAT, N_ROWS)
            print(f"hist L={L} (deep, {p.grid[2]} node slices of "
                  f"{p.nodes_per_block}, {p.grid[0]} row blocks): equals "
                  f"hist_plain_fixed on both code laws; max |err| vs f64 "
                  f"(w/g·w/h·w) uniform {channels(rec['f64_err'])} "
                  f"(hist_plain {channels(rec['plain_f64_err'])}), fit codes "
                  f"{channels(rec['fit_f64_err'])} "
                  f"({channels(rec['fit_plain_f64_err'])})", flush=True)
            continue
        codes = laws["uniform"]
        rec["plain_ms"] = time_ms(
            lambda: hist_cuda.hist_plain(codes, node, vals, L, NBINS), reps=5)
        # one library call computing the same histogram: flat ids
        # f·L·B + node·B + code into an (F·L·B, 3) buffer
        ids = (torch.arange(N_FEAT, device=dev, dtype=torch.int64)[:, None]
               * (L * NBINS) + node.to(torch.int64)[None, :] * NBINS
               + codes.to(torch.int64)).reshape(-1)
        src = vals.t().repeat(N_FEAT, 1)
        buf = torch.zeros((N_FEAT * L * NBINS, 3), device=dev)
        rec["library_ms"] = time_ms(lambda: buf.zero_().index_add_(0, ids, src),
                                    reps=10)
        del ids, src, buf
        rec["bound_ms"], rec["bytes"] = bound_ms_of(n_w, L)
        rows.append(rec)
        print(f"hist L={L:2d} {'sibling' if sibling else 'root   '}: kernel "
              f"{rec['ms']:.4f} ms uniform, {rec['fit_ms']:.4f} ms fit codes "
              f"(L2 flushed); plain {rec['plain_ms']:.4f} ms, index_add_ "
              f"{rec['library_ms']:.4f} ms, bytes bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bytes'] / 1e6:.1f} MB); max |err| vs f64 (w/g·w/h·w) "
              f"uniform: kernel {channels(rec['f64_err'])}, hist_plain "
              f"{channels(rec['plain_f64_err'])}; fit codes: kernel "
              f"{channels(rec['fit_f64_err'])}, hist_plain "
              f"{channels(rec['fit_plain_f64_err'])}", flush=True)
    return rows, worst


def main_path(dev):
    """Phase 4: the port's main path at full width; returns its record."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.metrics import auc_exact
    from h2o3_tpu_torch.ops import hist_cuda, histogram

    X, y = make_higgs_like(N_ROWS)
    names = [f"f{i}" for i in range(N_FEAT)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    gbm = H2OGradientBoostingEstimator(
        ntrees=NTREES, max_depth=DEPTH, learn_rate=0.1,
        histogram_type="UniformAdaptive", seed=42, device=str(dev))
    hist_cuda.launches = hist_cuda.launches_rows = 0
    histogram.DISPATCH.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    gbm.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    wall = time.time() - t0
    auc = float(gbm.auc())
    Xt, yt = make_higgs_like(100_000, seed=1)
    ft = Frame.from_numpy(np.column_stack([Xt, yt]), names=names).asfactor("label")
    t1 = time.time()
    pred = gbm.predict(ft)
    pred_s = time.time() - t1
    launches = hist_cuda.launches
    rows_launches = hist_cuda.launches_rows
    dispatch = dict(histogram.DISPATCH)
    p1 = np.asarray(pred.vec("1").data, np.float64)
    rec = dict(wall_s=wall, trees_per_s=NTREES / wall, auc=auc,
               holdout_auc=auc_exact(yt, p1), predict_s=pred_s,
               fit_timings=gbm.model.fit_timings,
               hist_launches=launches, dispatch=dispatch)
    print("main path: " + json.dumps(rec), flush=True)
    if auc < 0.75 or abs(auc - GBM_AUC) > 1e-3:
        raise AssertionError(f"training AUC {auc}: below 0.75 or more than "
                             f"1e-3 from {GBM_AUC}")
    if pred.names != ["predict", "0", "1"] or pred.nrow != 100_000:
        raise AssertionError(f"predict frame {pred.names} x {pred.nrow}")
    if not np.all(np.isfinite(p1)):
        raise AssertionError("predict returned non-finite probabilities")
    expect = NTREES * DEPTH
    if launches != expect or dispatch.get("pallas_factored") != expect \
            or set(dispatch) != {"pallas_factored"} or rows_launches:
        raise AssertionError(f"histogram dispatch {dispatch}, {launches} "
                             f"kernel launches; expected {expect} kernel "
                             "launches and no other method")
    return rec, fr


def profile_fit(est, fr, tag="profile"):
    """Phases 6 and 10: one fit of `est` on the main path's frame under
    torch.profiler. Busy share = the union of the device's kernel and copy
    intervals over the fit's wall time (the profiler's own host overhead
    lengthens that wall, so the share reads low)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        est.train(y="label", training_frame=fr)
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # B1's kernels (scale, main, fold) and B2's (count, scan, scatter and
    # the bucketed main kernel)
    b1 = {k[:80]: v / 1e3 for k, v in by_name.items() if "hist_fixed_" in k}
    b2 = {k[:80]: v / 1e3 for k, v in by_name.items() if "hist_rows_" in k}
    rec = dict(trees=est.model.ntrees_built, wall_s=wall,
               device_busy_s=busy_us / 1e6,
               busy_share=busy_us / 1e6 / wall, device_events=len(spans),
               fit_timings=est.model.fit_timings,
               top_device_ms={k[:80]: v / 1e3 for k, v in top},
               b1_device_ms=sum(b1.values()), b1_kernels_ms=b1,
               b2_device_ms=sum(b2.values()), b2_kernels_ms=b2)
    print(f"{tag}: " + json.dumps(rec), flush=True)
    return rec


def small_reference_check(dev):
    """Phase 5: cuda and CPU fits of one small problem agree."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    X, y = make_higgs_like(4000, n_feat=8, seed=3)
    names = [f"f{i}" for i in range(8)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    fits = {}
    for d in (str(dev), "cpu"):
        est = H2OGradientBoostingEstimator(
            ntrees=5, max_depth=4, learn_rate=0.1, seed=42,
            histogram_type="UniformAdaptive", device=d)
        est.train(y="label", training_frame=fr)
        fits[d] = est
    a, b = fits[str(dev)].model.forest, fits["cpu"].model.forest
    for f in ("feat", "bin", "is_split"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"cuda and cpu forests differ in {f}")
    dv = float((a.value.cpu() - b.value).abs().max())
    pa = np.asarray(fits[str(dev)].predict(fr).vec("1").data)
    pb = np.asarray(fits["cpu"].predict(fr).vec("1").data)
    dp = float(np.abs(pa - pb).max())
    print(f"small reference check: forest structure equal, max |value diff| "
          f"{dv:.3e}, max |predict diff| {dp:.3e}", flush=True)
    if dv > 1e-5 or dp > 1e-5:
        raise AssertionError("cuda and cpu fits disagree beyond 1e-5")


def drf_widths():
    """(L, launches per smoke fit) for every distinct B2 width of the DRF
    fit: each tree's compact attempt and its dense rebuild."""
    from h2o3_tpu_torch.models.tree import histogram_level_plan

    n = Counter(L for _, L in histogram_level_plan(DRF_DEPTH, DRF_CAP)
                + histogram_level_plan(DRF_DEPTH))
    return sorted((L, DRF_TREES * c) for L, c in n.items())


def rows_fixture(rng, L, skewed):
    """Node ids (N,) int32 and weights (N,) f32 of one B2 pass: the in-bag
    63.2 % of rows weighted at L = 1, half the rows elsewhere; node ids
    uniform, or skewed: half the weighted rows in node L // 2, every fourth
    node empty."""
    w = rng.random(N_ROWS) < (0.632 if L == 1 else 0.5)
    node = rng.integers(0, L, N_ROWS)
    if skewed:
        node = np.where(node % 4 == 3, node - 1, node)
        node[w & (rng.random(N_ROWS) < 0.5)] = L // 2
    return node.astype(np.int32), w.astype(np.float32)


def bound_ms_of(n_weighted, L):
    """Least time of one histogram pass (B1 or B2) on the card: the codes
    of the weighted rows, node ids and values of every row and the output,
    once each, over the memory rate (the adds take less); and those
    bytes."""
    nbytes = (n_weighted * N_FEAT + 16 * N_ROWS
              + L * N_FEAT * NBINS * 3 * 4)
    flops = 3 * n_weighted * N_FEAT
    return max(nbytes / HBM_BYTES_PER_S, flops / 67e12) * 1e3, nbytes


def rows_vs_plain(dev):
    """Phase 7: the B2 kernels against `hist_plain_rows` at every width of
    the DRF plan, on seeded row-major inputs; returns (per-width rows,
    max |err|)."""
    from h2o3_tpu_torch.ops import hist_cuda

    rng = np.random.default_rng(11)
    codes = torch.from_numpy(
        rng.integers(0, NBINS, (N_ROWS, N_FEAT), dtype=np.uint8)).to(dev)
    g = rng.normal(size=N_ROWS).astype(np.float32)
    rows, worst = [], 0.0
    for L, n_fit in drf_widths():
        rec = dict(L=L, launches=n_fit, per_tree=n_fit / DRF_TREES)
        for law in ("uniform", "skewed"):
            node_np, w = rows_fixture(rng, L, law == "skewed")
            vals = torch.from_numpy(np.stack([w, g * w, w])).to(dev)
            node = torch.from_numpy(node_np).to(dev)
            got = hist_cuda.hist_build_rows(codes, node, vals, L, NBINS)
            ref = hist_cuda.hist_plain_rows(codes, node, vals, L, NBINS)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, rtol=1e-5,
                                       atol=1e-5 * float(ref.abs().max()))
            err = float((got - ref).abs().max())
            del got, ref
            worst = max(worst, err)
            ms = time_ms(lambda: hist_cuda.hist_build_rows(codes, node, vals,
                                                           L, NBINS))
            if law == "skewed":
                rec.update(skewed_ms=ms, skewed_max_abs_err=err)
                continue
            plain_ms = time_ms(lambda: hist_cuda.hist_plain_rows(
                codes, node, vals, L, NBINS), reps=5)
            # one library call computing the same histogram: flat ids
            # f·L·B + node·B + code into an (F·L·B, 3) buffer
            ids = (torch.arange(N_FEAT, device=dev, dtype=torch.int64)[None, :]
                   * (L * NBINS) + node.to(torch.int64)[:, None] * NBINS
                   + codes.to(torch.int64)).reshape(-1)
            src = vals.t()[:, None, :].expand(N_ROWS, N_FEAT, 3).reshape(-1, 3)
            buf = torch.zeros((N_FEAT * L * NBINS, 3), device=dev)
            lib_ms = time_ms(lambda: buf.zero_().index_add_(0, ids, src),
                             reps=10)
            del ids, src, buf
            n_w = int(w.sum())
            bound_ms, nbytes = bound_ms_of(n_w, L)
            rec.update(weighted_rows=n_w, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound_ms, bytes=nbytes,
                       max_abs_err=err)
        rows.append(rec)
        print(f"rows hist L={L:6d} ({n_fit:3d} per fit): kernel "
              f"{rec['ms']:.4f} ms uniform, {rec['skewed_ms']:.4f} ms skewed; "
              f"plain {rec['plain_ms']:.4f} ms, index_add_ "
              f"{rec['library_ms']:.4f} ms, bytes bound {rec['bound_ms']:.4f} "
              f"ms ({rec['bytes'] / 1e6:.1f} MB), max |err| "
              f"{max(rec['max_abs_err'], rec['skewed_max_abs_err']):.3e}",
              flush=True)
    return rows, worst


def drf_path(dev, fr):
    """Phase 8: the DRF path at full width; returns its record."""
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.frame.frame import Frame
    from h2o3_tpu_torch.models.metrics import auc_exact
    from h2o3_tpu_torch.models.tree import histogram_level_plan
    from h2o3_tpu_torch.ops import hist_cuda, histogram

    drf = H2ORandomForestEstimator(ntrees=DRF_TREES, hist_method="pallas",
                                   seed=42, device=str(dev))
    hist_cuda.launches = hist_cuda.launches_rows = 0
    histogram.DISPATCH.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.time()
    drf.train(y="label", training_frame=fr)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, b1_launches = hist_cuda.launches_rows, hist_cuda.launches
    dispatch = dict(histogram.DISPATCH)
    model = drf.model
    oob_auc = float(drf.auc())
    Xt, yt = make_higgs_like(100_000, seed=1)
    names = [f"f{i}" for i in range(N_FEAT)] + ["label"]
    ft = Frame.from_numpy(np.column_stack([Xt, yt]), names=names).asfactor("label")
    t1 = time.time()
    pred = drf.predict(ft)
    pred_s = time.time() - t1
    p1 = np.asarray(pred.vec("1").data, np.float64)
    plan = histogram_level_plan(model.max_depth, model.compact_cap)
    expect = (DRF_TREES * len(plan)
              + model.dense_rebuilds * len(histogram_level_plan(model.max_depth)))
    rec = dict(wall_s=wall, trees_per_s=DRF_TREES / wall,
               max_depth_used=model.max_depth, compact_cap=model.compact_cap,
               compact_overflows=model.dense_rebuilds,
               dense_rebuilds=model.dense_rebuilds, oob_auc=oob_auc,
               holdout_auc=auc_exact(yt, p1), predict_s=pred_s,
               fit_timings=model.fit_timings, hist_launches=launches,
               planned_passes=expect, dispatch=dispatch,
               peak_device_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(f"DRF depth used: {model.max_depth} (requested 20)", flush=True)
    print("drf path: " + json.dumps(rec), flush=True)
    if min(oob_auc, rec["holdout_auc"]) < DRF_AUC_FLOOR:
        raise AssertionError(f"DRF AUC below the floor {DRF_AUC_FLOOR}: OOB "
                             f"{oob_auc}, holdout {rec['holdout_auc']}")
    if max(abs(oob_auc - DRF_AUCS[0]),
           abs(rec["holdout_auc"] - DRF_AUCS[1])) > 1e-6:
        raise AssertionError(f"DRF forest differs: OOB AUC {oob_auc}, holdout "
                             f"{rec['holdout_auc']}, expected {DRF_AUCS}")
    if pred.names != ["predict", "0", "1"] or pred.nrow != 100_000 \
            or not np.all(np.isfinite(p1)):
        raise AssertionError("DRF predict frame wrong or non-finite")
    if expect != sum(n for _, n in drf_widths()):
        raise AssertionError(f"the fit ran {expect} B2 passes; phase 7 "
                             "weighted its widths for another plan")
    if launches != expect or dispatch != {"pallas": expect} or b1_launches:
        raise AssertionError(f"DRF histogram dispatch {dispatch}, {launches} "
                             f"B2 launches, {b1_launches} B1 launches; "
                             f"expected {expect} B2 launches and no other")
    return rec


def small_drf_check(dev):
    """Phase 9: cuda and CPU DRF fits of one small problem agree. Binary
    labels keep every histogram sum exact in f32, whatever the order of the
    atomics, so the forests must be the same."""
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.frame.frame import Frame

    X, y = make_higgs_like(4000, n_feat=8, seed=3)
    names = [f"f{i}" for i in range(8)] + ["label"]
    fr = Frame.from_numpy(np.column_stack([X, y]), names=names).asfactor("label")
    fits = {}
    for d in (str(dev), "cpu"):
        est = H2ORandomForestEstimator(ntrees=5, max_depth=14, seed=42,
                                       hist_method="pallas", device=d)
        est.train(y="label", training_frame=fr)
        fits[d] = est
    a, b = fits[str(dev)].model.forest, fits["cpu"].model.forest
    for f in ("feat", "bin", "is_split"):
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"cuda and cpu DRF forests differ in {f}")
    dv = float((a.value.cpu() - b.value).abs().max())
    pa = np.asarray(fits[str(dev)].predict(fr).vec("1").data)
    pb = np.asarray(fits["cpu"].predict(fr).vec("1").data)
    dp = float(np.abs(pa - pb).max())
    da = abs(fits[str(dev)].auc() - fits["cpu"].auc())
    print(f"small DRF check: forest structure equal ({int(a.is_split.sum())} "
          f"splits), max |value diff| {dv:.3e}, max |predict diff| {dp:.3e}, "
          f"OOB AUC diff {da:.3e}", flush=True)
    if dv > 1e-5 or dp > 1e-5 or da > 1e-5:
        raise AssertionError("cuda and cpu DRF fits disagree beyond 1e-5")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    from h2o3_tpu_torch.ops import hist_cuda

    t0 = time.time()
    hist_cuda.build()
    print(f"kernel build: {time.time() - t0:.2f} s", flush=True)
    if hist_cuda.build_log.strip():
        print(hist_cuda.build_log.strip(), flush=True)

    from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                           H2ORandomForestEstimator)

    rows, worst = kernel_vs_plain(dev)
    rec, fr = main_path(dev)
    small_reference_check(dev)
    profile_fit(H2OGradientBoostingEstimator(
        ntrees=PROFILE_TREES, max_depth=DEPTH, learn_rate=0.1,
        histogram_type="UniformAdaptive", seed=42, device=str(dev)), fr)
    rows_b2, worst_b2 = rows_vs_plain(dev)
    drf_rec = drf_path(dev, fr)
    small_drf_check(dev)
    profile_fit(H2ORandomForestEstimator(
        ntrees=DRF_PROFILE_TREES, hist_method="pallas", seed=42,
        device=str(dev)), fr, tag="drf profile")

    def total(passes, k):   # per tree: B2 widths weighted by passes per tree
        return sum(r[k] * r.get("per_tree", 1) for r in passes)

    kernels = [dict(
        name=name, route="cuda", source="h2o3_tpu_torch/csrc/hist.cu",
        replaces=replaces, launches=launches, max_abs_err=err,
        ms=total(passes, "ms"), plain_ms=total(passes, "plain_ms"),
        bound_ms=total(passes, "bound_ms"), bound_by="bytes",
        library_ms=total(passes, "library_ms"))
        for name, replaces, launches, err, passes in (
            ("hist_factored", "h2o3_tpu/ops/hist_pallas.py:103",
             rec["hist_launches"], worst, rows),
            ("hist_rows", "h2o3_tpu/ops/hist_pallas.py:174",
             drf_rec["hist_launches"], worst_b2, rows_b2))]
    print(f"times are sums over passes at N={N_ROWS}, F={N_FEAT}, B={NBINS}: "
          f"hist_factored over one depth-6 tree's six (L = {LEVEL_WIDTHS}; "
          "uniform codes, L2 flushed; "
          f"{total(rows, 'fit_ms'):.4f} ms on the fit's own codes), "
          f"hist_rows over one DRF tree's {DRF_DEPTH + 1} + {DRF_DEPTH} passes "
          "(compact attempt and dense rebuild; uniform node law); "
          "max_abs_err is against the f32 plain version (hist_factored also "
          "equals its fixed-point twin bit for bit)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
