"""Histogram tree builder and tree scoring — port of the depth-wise path of
`h2o3_tpu/models/tree.py`.

A tree is a perfect binary heap of static depth D (arrays of length
2^(D+1)-1). Each level runs one histogram pass (sibling subtraction from
level 1 on: only LEFT children are accumulated, right = parent − left),
the split search, and the row partition; rows of decided leaves keep
flowing left, so every depth-D cell inherits its deciding ancestor's rows
and value. NAs sit in the last bin and traverse right.

Levels wider than `compact_cap` run in active-node compaction (live nodes
in compact slots, an overflow count the fit loop checks), and `mtries_rate`
samples features per node and level with the reference's threefry draws
(`ops.prng`).

The TPU reference computes per-row lookups and leaf totals as one-hot
matmuls (the TPU has no fast gather); here they are true gathers and
exact integer sums.

Monotone constraints (``monotone``, an (F,) f32 vector in {-1, 0, 1}) run
on dense levels only: the split search admits a split on a constrained
feature only where its clipped child values keep the constraint's order,
and each node's value bounds pass to its children by the chosen split's
mid-point (the reference's LightGBM-style propagation), so no tree can
violate a constraint.

`build_tree_lossguide` is XGBoost's leaf-wise growth (`grow_policy=
"lossguide"`) into the same depth-capped heap: a frontier of leaf slots,
each split of the best-gain slot one L = 1 histogram pass of its left
child (B1 on the card) and the right child by subtraction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import packing, prng
from ..ops.histogram import (build_histograms, ordered_axis_fold,
                             resolve_method, widen)

_INF = float("inf")


class Tree(NamedTuple):
    """One decision tree as flat heap arrays (length 2^(D+1)-1), or a
    stacked forest ((ntrees, T) each)."""

    feat: torch.Tensor      # int32, split feature per node (0 where not split)
    bin: torch.Tensor       # int32, split bin per node
    thr: torch.Tensor       # f32, raw-value threshold (left iff x <= thr)
    is_split: torch.Tensor  # bool
    value: torch.Tensor     # f32, Newton leaf value at every node


def heap_size(depth: int) -> int:
    return 2 ** (depth + 1) - 1


def _tl1(a: torch.Tensor, reg_alpha: float) -> torch.Tensor:
    """xgboost ThresholdL1: soft-threshold a gradient sum by alpha."""
    return torch.sign(a) * torch.clamp(torch.abs(a) - reg_alpha, min=0.0)


def _nan_first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Row-wise argmax of a 2-D tensor with `jnp.argmax`'s rules: NaN is the
    maximum, and ties go to the first occurrence."""
    isn = torch.isnan(x)
    first_nan = isn.to(torch.int32).argmax(dim=1)
    clean = torch.where(isn, torch.full_like(x, -_INF), x)
    return torch.where(isn.any(dim=1), first_nan, clean.argmax(dim=1))


def _fused_level_best(hist, node_ok, feat_mask, keep, nbins: int, min_rows,
                      reg_lambda, reg_alpha, gsum, hsum, wsum,
                      monotone=None, lo=None, hi=None):
    """Best (gain, feature, bin) per level node from an (L, F, B, 3)
    histogram; `keep` is the (L, F) mtries column sample or None. The
    reference scans features keeping a running best with a strict `>` (NaN
    gains count as the maximum); that equals one flat argmax over (F·B)
    with first-occurrence ties and NaN-as-max, which is what this computes,
    over all features at once.

    With `monotone` ((F,) f32 in {-1, 0, 1}) and the nodes' (L,) value
    bounds `lo`/`hi`, each candidate's child values are the Newton values
    clipped into the bounds, a split on a constrained feature is admissible
    only where c·(vR − vL) ≥ 0, and the chosen split's (vL, vR) come back
    as two more outputs (0 where no split is admissible, as the
    reference's running scan leaves them)."""
    L, F, B = hist.shape[0], hist.shape[1], hist.shape[2]
    G, H, W = gsum[:, None, None], hsum[:, None, None], wsum[:, None, None]
    Gt = _tl1(G, reg_alpha)
    base = Gt * Gt / (H + reg_lambda)
    # one scan over the bins for all three channels: the bin axis is not
    # the innermost, so CUDA scans each (node, feature, channel) column in
    # order, as the CPU does. Per-channel views take the innermost-dim scan
    # kernel instead, which on an H100 was 70 % of the device time of a
    # depth-19 DRF fit at 1M rows.
    cum = torch.cumsum(hist, dim=2)                          # (L, F, B, 3)
    WL, GL, HL = cum[..., 0], cum[..., 1], cum[..., 2]
    GR, HR, WR = G - GL, H - HL, W - WL
    GLt, GRt = _tl1(GL, reg_alpha), _tl1(GR, reg_alpha)
    gain = (GLt * GLt / (HL + reg_lambda)
            + GRt * GRt / (HR + reg_lambda) - base)
    bin_ok = torch.arange(B, device=hist.device) < nbins - 1  # no NA-bin split
    ok = (WL >= min_rows) & (WR >= min_rows) & bin_ok[None, None, :]
    ok = ok & (feat_mask > 0)[None, :, None] & node_ok[:, None, None]
    if keep is not None:
        ok = ok & keep[:, :, None]
    if monotone is not None:
        lo3, hi3 = lo[:, None, None], hi[:, None, None]
        vL = torch.clamp(-GLt / (HL + reg_lambda + 1e-12), lo3, hi3)
        vR = torch.clamp(-GRt / (HR + reg_lambda + 1e-12), lo3, hi3)
        mc = monotone[None, :, None]
        ok = ok & ((mc == 0) | (mc * (vR - vL) >= 0))
    gain = torch.where(ok, gain, torch.full_like(gain, -_INF))
    flat = gain.reshape(L, F * B)
    best = _nan_first_argmax(flat)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    out = (best_gain, (best // B).to(torch.int32), (best % B).to(torch.int32))
    if monotone is None:
        return out
    # the reference's scan never takes a feature whose best is −inf
    none = torch.isneginf(best_gain)
    zero = torch.zeros_like(best_gain)
    return out + tuple(
        torch.where(none, zero, v.reshape(L, F * B).gather(1, best[:, None])[:, 0])
        for v in (vL, vR))


def _leaf_totals(ids: torch.Tensor, vals3: torch.Tensor, nseg: int,
                 n_shard_blocks: int = 0,
                 axis_name: Optional[str] = None) -> torch.Tensor:
    """Per-cell {Σw, Σg·w, Σh·w} totals of the final level, (nseg, 3); with
    ``n_shard_blocks`` per contiguous row block, folded in block order
    (with `axis_name`, every rank's blocks in rank order). On
    every device the sums are exact integer sums (`_fixed_totals`), rounded
    once to f32: float `index_add_` adds row by row (a leaf of thousands of
    rows drifts from the f64 sum) and, on the card, with atomics in an
    order that changes from run to run. So the CPU and the card give the
    same leaf values, and a fit gives the same ones every time."""
    ids = ids.to(torch.int64)
    if n_shard_blocks > 0:
        rows = ids.shape[0] // n_shard_blocks
        return ordered_axis_fold(torch.stack([
            _fixed_totals(ids[b * rows:(b + 1) * rows],
                          vals3[:, b * rows:(b + 1) * rows], nseg)
            for b in range(n_shard_blocks)]), axis_name)
    return _fixed_totals(ids, vals3, nseg)


def _fixed_totals(ids: torch.Tensor, vals3: torch.Tensor,
                  nseg: int) -> torch.Tensor:
    """(nseg, 3) f32 per-cell sums of vals3 (3, N), order-free: each
    channel is scaled by a power of two that leaves its N-row sum below
    2^62, rounded to int64 and summed with integer adds (exact in any
    order), then scaled back and rounded once to f32. A value's rounding
    error is at most N·max|v|/2^63, far below f32's. A channel holding a
    NaN or an infinity sums to NaN in every cell."""
    n = vals3.shape[1]
    if n == 0:
        return torch.zeros((nseg, 3), dtype=torch.float32, device=vals3.device)
    top = vals3.abs().amax(dim=1).to(torch.float64)
    finite = torch.isfinite(top)
    _, e = torch.frexp(torch.where(finite, top, 0.0))             # max < 2^e
    bits = 62 - max(n, 1).bit_length()
    scale = torch.ldexp(torch.ones(3, dtype=torch.float64, device=vals3.device),
                        bits - e)
    q = torch.round(torch.where(finite[:, None], vals3.to(torch.float64), 0.0)
                    * scale[:, None]).to(torch.int64)
    acc = torch.zeros((nseg, 3), dtype=torch.int64,
                      device=vals3.device).index_add_(0, ids, q.t())
    out = (acc.to(torch.float64) / scale).to(torch.float32)
    return torch.where(finite[None, :], out, float("nan"))


def value_at(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] — an exact gather (the reference's one-hot matvec at
    Precision.HIGHEST exists only because the TPU lacks one)."""
    return table[idx.to(torch.int64)]


class LevelRule:
    """The per-level arithmetic of a dense depth-wise level, shared by
    `build_tree` and the streamed step (`tree_stream.py`), which must
    compute the same bits: Newton node values, the fused split search with
    its gain-per-feature fold, and the raw thresholds.

    With `monotone` the rule also owns the level's value bounds: node
    values are clipped into them after `max_abs_leaf` (the bounds encode
    the constraint, so they win over the magnitude cap), and each dense
    level passes them to its children by the chosen split's mid-point
    (the reference's `tree.py:502-517`)."""

    _BIG = 3.4e38

    def __init__(self, feat_mask: torch.Tensor, edges: torch.Tensor,
                 nbins: int, min_rows: float, min_split_improvement: float,
                 reg_lambda: float, reg_alpha: float,
                 max_abs_leaf: Optional[float],
                 monotone: Optional[torch.Tensor] = None):
        F = edges.shape[0]
        self.feat_mask = feat_mask
        self.nbins = nbins
        self.min_rows = min_rows
        self.min_split_improvement = min_split_improvement
        self.reg_lambda = reg_lambda
        self.reg_alpha = reg_alpha
        self.max_abs_leaf = max_abs_leaf
        self.pad_edges = torch.cat(
            [edges.to(torch.float32),
             torch.full((F, 1), _INF, dtype=torch.float32,
                        device=edges.device)], dim=1)
        self.gain_per_feature = torch.zeros(F, dtype=torch.float32,
                                            device=edges.device)
        self.monotone = monotone
        if monotone is not None:
            self.lo = torch.full((1,), -self._BIG, dtype=torch.float32,
                                 device=edges.device)
            self.hi = torch.full((1,), self._BIG, dtype=torch.float32,
                                 device=edges.device)

    def newton(self, gs: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
        v = -_tl1(gs, self.reg_alpha) / (hs + self.reg_lambda + 1e-12)
        if self.max_abs_leaf is not None:
            v = torch.clamp(v, -self.max_abs_leaf, self.max_abs_leaf)
        v = v.to(torch.float32)
        if self.monotone is not None:
            v = torch.clamp(v, self.lo, self.hi)
        return v

    @staticmethod
    def totals(hist: torch.Tensor):
        """(wsum, gsum, hsum) per node (the same for every feature)."""
        return (hist[..., 0].sum(dim=2)[:, 0], hist[..., 1].sum(dim=2)[:, 0],
                hist[..., 2].sum(dim=2)[:, 0])

    def search(self, hist, node_ok, keep, gsum, hsum, wsum):
        """(do_split, feature, bin, raw threshold) per node. The split
        gains fold into `gain_per_feature` with `index_put_(accumulate=
        True)`: node order on the CPU, and on the card a sorted fold in the
        same order, so varimp has the same bits in every run (a float
        `index_add_` there adds with atomics in no fixed order). Under
        `monotone` the level's bounds then pass to the next level."""
        mono = self.monotone
        found = _fused_level_best(
            hist, node_ok, self.feat_mask, keep, self.nbins, self.min_rows,
            self.reg_lambda, self.reg_alpha, gsum, hsum, wsum, monotone=mono,
            lo=self.lo if mono is not None else None,
            hi=self.hi if mono is not None else None)
        best_gain, bf, bb = found[:3]
        do = best_gain > max(self.min_split_improvement, 1e-10)
        self.gain_per_feature.index_put_(
            (bf.to(torch.int64),),
            torch.where(do, best_gain, torch.zeros_like(best_gain)),
            accumulate=True)
        bthr = self.pad_edges[bf.to(torch.int64),
                              torch.clamp(bb, max=self.nbins - 2).to(torch.int64)]
        if mono is not None:
            self._propagate(do, bf, *found[3:])
        return do, bf, bb, bthr

    def _propagate(self, do, bf, vl, vr):
        """The children's bounds: on a ±1-constrained split the mid-point
        of the chosen child values caps the lower-valued side and floors
        the higher-valued one; other nodes' children inherit theirs."""
        lo, hi = self.lo, self.hi
        mid = 0.5 * (vl + vr)
        c = self.monotone[bf.to(torch.int64)] * do.to(torch.float32)
        hi_l = torch.where(c > 0, torch.minimum(hi, mid), hi)
        lo_l = torch.where(c < 0, torch.maximum(lo, mid), lo)
        hi_r = torch.where(c < 0, torch.minimum(hi, mid), hi)
        lo_r = torch.where(c > 0, torch.maximum(lo, mid), lo)
        self.lo = torch.stack([lo_l, lo_r], dim=1).reshape(-1)
        self.hi = torch.stack([hi_l, hi_r], dim=1).reshape(-1)

    def dense_level(self, heap: "Heap", d: int, hist: torch.Tensor,
                    active: torch.Tensor, keep):
        """Decide dense level d from its (2^d, F, B, 3) histogram: the
        nodes' values and covers, then their splits, written into `heap`;
        returns (do_split, feature, bin)."""
        L = 2 ** d
        base = L - 1
        wsum, gsum, hsum = self.totals(hist)
        heap.value[base:base + L] = self.newton(gsum, hsum)
        heap.cover[base:base + L] = wsum
        do_split, bf, bb, bthr = self.search(hist, active, keep, gsum, hsum,
                                             wsum)
        zero_i = torch.zeros_like(bf)
        heap.feat[base:base + L] = torch.where(do_split, bf, zero_i)
        heap.bin[base:base + L] = torch.where(do_split, bb, zero_i)
        heap.thr[base:base + L] = torch.where(do_split, bthr,
                                              torch.zeros_like(bthr))
        heap.split[base:base + L] = do_split
        return do_split, bf, bb

    def leaf_level(self, heap: "Heap", max_depth: int, tot: torch.Tensor):
        """The final level's values and covers from exact (2^D, 3) totals."""
        basef = 2 ** max_depth - 1
        T = heap_size(max_depth)
        heap.value[basef:T] = self.newton(tot[:, 1], tot[:, 2])
        heap.cover[basef:T] = tot[:, 0]


class Heap:
    """A tree's heap arrays under construction, one spare cell at index T
    (the compact phase's writes of dead slots, the reference's scatter
    ``mode="drop"``), cut off by `tree`."""

    def __init__(self, max_depth: int, device: torch.device):
        T = heap_size(max_depth)
        self.T = T
        self.feat = torch.zeros(T + 1, dtype=torch.int32, device=device)
        self.bin = torch.zeros(T + 1, dtype=torch.int32, device=device)
        self.thr = torch.zeros(T + 1, dtype=torch.float32, device=device)
        self.split = torch.zeros(T + 1, dtype=torch.bool, device=device)
        self.value = torch.zeros(T + 1, dtype=torch.float32, device=device)
        self.cover = torch.zeros(T + 1, dtype=torch.float32, device=device)

    def tree(self) -> Tree:
        T = self.T
        return Tree(self.feat[:T], self.bin[:T], self.thr[:T],
                    self.split[:T], self.value[:T])


def partition(codes: torch.Tensor, idx: torch.Tensor, bf: torch.Tensor,
              bb: torch.Tensor, do_split: torch.Tensor,
              pack_bits: int) -> torch.Tensor:
    """A dense level's row partition: decided-leaf rows flow left,
    splitters route by their code of the split feature; returns each row's
    next level-local node (int64)."""
    rf, rb, rs = bf[idx], bb[idx], do_split[idx]
    go_right = (_row_code(codes, rf, pack_bits) > rb) & rs
    return 2 * idx + go_right.to(torch.int64)


def compact_switch_depth(max_depth: int, compact_cap: int) -> int:
    """First level handled by active-node compaction (max_depth = never):
    the first level wider than the cap. Shared by `build_tree` and
    `histogram_level_plan`, so the plan is the structure that runs."""
    if not compact_cap:
        return max_depth
    for d in range(max_depth):
        if 2 ** d > compact_cap:
            return d
    return max_depth


def histogram_level_plan(max_depth: int, compact_cap: int = 0,
                         grow_policy: str = "depthwise"):
    """(label, n_nodes) of each histogram pass of one `build_tree`: d0 over
    1 node, deeper dense levels over the PARENT count (sibling subtraction
    accumulates only left children), then the compact transition and one
    pass per compact level over compact_cap + 1 slots. A lossguide tree's
    passes are all one kind, one node each (`lossguide_slots` counts
    them)."""
    if grow_policy == "lossguide":
        return [("lossguide_node", 1)]
    d_sw = compact_switch_depth(max_depth, compact_cap)
    levels = [("d%d" % d, 1 if d == 0 else 2 ** (d - 1))
              for d in range(min(d_sw, max_depth))]
    if d_sw < max_depth:
        levels.append(("compact_transition", compact_cap + 1))
        levels += [("d%d" % d, compact_cap + 1)
                   for d in range(d_sw, max_depth)]
    return levels


def _row_code(codes: torch.Tensor, rf: torch.Tensor, pack_bits: int) -> torch.Tensor:
    """codes[i, rf[i]] as int32: each row's code of its split feature
    (uint8 or int16 codes, or packed words)."""
    if pack_bits:
        return packing.packed_row_values(codes, rf, pack_bits)
    return codes.gather(1, rf.to(torch.int64)[:, None])[:, 0].to(torch.int32)


def _keep_mask(key, n_nodes: int, F: int, rate: torch.Tensor):
    """Per-(node, feature) column sample of one level (DRF mtries): the
    next key and an (n_nodes, F) bool mask, at least one feature kept per
    node (reference `tree.py:397-402`)."""
    key, sub = prng.split(key)
    keep = prng.uniform(sub, (n_nodes, F), rate.device) < rate
    keep[:, 0] |= ~keep.any(dim=1)
    return key, keep


def build_tree(
    codes: torch.Tensor,       # (N, F) uint8/int16 codes, or packed (N·bits/8, F)
    g: torch.Tensor,           # (N,) gradients
    h: torch.Tensor,           # (N,) hessians
    w: torch.Tensor,           # (N,) row weights (0 = pad / out of bag)
    feat_mask: torch.Tensor,   # (F,) f32 1/0 column mask
    edges: torch.Tensor,       # (F, nbins-2) raw-value right edges (+inf pad)
    max_depth: int,
    nbins: int,
    min_rows: float = 10.0,
    min_split_improvement: float = 0.0,
    reg_lambda: float = 1.0,
    reg_alpha: float = 0.0,
    hist_method: str = "auto",
    max_abs_leaf: Optional[float] = None,
    pack_bits: int = 0,
    n_shard_blocks: int = 0,
    mtries_rate: Optional[float] = None,
    key=None,
    compact_cap: int = 0,
    axis_name: Optional[str] = None,
    monotone: Optional[torch.Tensor] = None,
):
    """Build one tree; returns (Tree, final leaf heap index (N,), gain per
    feature (F,), cover (T,) — Σ row weights per heap node), and with
    ``compact_cap`` a fifth element: the overflow count (0-d int32 tensor).

    ``mtries_rate`` samples each feature per node and level with that
    probability (DRF's per-split column sampling), drawing from ``key`` (an
    `ops.prng` key) as the reference does: one `split` per level.

    ``compact_cap`` > 0 runs the levels wider than the cap in active-node
    compaction: at most ``compact_cap`` live nodes sit in compact slots
    (slot CAP is the trash slot of dead rows), so a level's histogram is
    (CAP + 1, F, B, 3) whatever its depth. If the live nodes ever exceed
    the cap the overflow count is nonzero and the tree is not the exact
    one: the caller must rebuild it densely (`shared_tree`'s fit loop does).

    With ``axis_name`` (a pod fit) the rows are this rank's canonical
    slice and ``n_shard_blocks`` its own block count: every histogram pass
    and the leaf totals fold every rank's block partials in rank order
    (`ordered_axis_fold`), so every rank searches the same histograms and
    grows the same tree with no broadcast.

    ``monotone`` ((F,) f32 in {-1, 0, 1}) constrains the tree's values to
    rise (+1) or fall (−1) with each constrained feature; it needs dense
    levels (``compact_cap=0``)."""
    if compact_cap and monotone is not None:
        raise ValueError("compact_cap requires monotone=None")
    dev = g.device
    F = codes.shape[1]
    N = (packing.packed_nrows(codes.shape[0], pack_bits) if pack_bits
         else codes.shape[0])
    T = heap_size(max_depth)
    heap = Heap(max_depth, dev)
    feat_a, bin_a, thr_a = heap.feat, heap.bin, heap.thr
    split_a, value_a, cover_a = heap.split, heap.value, heap.cover
    rule = LevelRule(feat_mask, edges, nbins, min_rows, min_split_improvement,
                     reg_lambda, reg_alpha, max_abs_leaf, monotone)
    newton, totals, search = rule.newton, rule.totals, rule.search

    idx = torch.zeros(N, dtype=torch.int64, device=dev)   # level-local node
    active = torch.ones(1, dtype=torch.bool, device=dev)
    # the widened codes every level's histogram pass reads, in the layout of
    # the resolved method's kernel: built once per tree, a tree-lifetime
    # transient (the resident matrix stays packed)
    method = resolve_method(hist_method, dev)
    codes_w = widen(codes, pack_bits, method)
    rate = (torch.tensor(mtries_rate, dtype=torch.float32, device=dev)
            if mtries_rate is not None else None)
    if rate is not None and key is None:
        key = prng.PRNGKey(0)
    d_switch = compact_switch_depth(max_depth, compact_cap)
    # per-row frozen leaf (absolute heap node): compaction stops flowing
    # the rows of decided leaves left, so the leaf is tracked per row
    row_leaf = (torch.zeros(N, dtype=torch.int64, device=dev)
                if d_switch < max_depth else None)

    def hist_pass(node_id, wts, n_nodes):
        return build_histograms(
            codes, node_id, g, h, wts, n_nodes, nbins, method=method,
            pack_bits=pack_bits, n_shard_blocks=n_shard_blocks,
            codes_w=codes_w, axis_name=axis_name)

    hist_prev = None
    for d in range(min(d_switch, max_depth)):
        L = 2 ** d
        if d == 0:
            hist = hist_pass(idx, w, L)
        else:
            # sibling subtraction: only LEFT children are accumulated
            is_left = (idx % 2 == 0)
            hist_left = hist_pass(idx // 2, w * is_left.to(w.dtype), L // 2)
            hist_right = hist_prev - hist_left
            hist = torch.stack([hist_left, hist_right], dim=1).reshape(
                (L,) + tuple(hist_left.shape[1:]))
        hist_prev = hist

        keep = None
        if rate is not None:
            key, keep = _keep_mask(key, L, F, rate)
        do_split, bf, bb = rule.dense_level(heap, d, hist, active, keep)
        if row_leaf is not None:
            rs = do_split[idx]
        idx = partition(codes, idx, bf, bb, do_split, pack_bits)
        if row_leaf is not None:
            row_leaf = torch.where(rs, (2 ** (d + 1) - 1) + idx, row_leaf)
        active = torch.repeat_interleave(do_split, 2)

    def finish(leaf):
        return (heap.tree(), leaf, rule.gain_per_feature, cover_a[:T])

    if d_switch >= max_depth:
        # final level: leaf values from exact per-cell totals
        Lf = 2 ** max_depth
        tot = _leaf_totals(idx, torch.stack([w, g * w, h * w]), Lf,
                           n_shard_blocks, axis_name)
        rule.leaf_level(heap, max_depth, tot)
        out = finish(idx + Lf - 1)
        if compact_cap:
            return out + (torch.zeros((), dtype=torch.int32, device=dev),)
        return out

    # ---- compact phase: levels d_switch..max_depth with <= CAP live slots
    CAP = compact_cap
    M = CAP // 2
    if 2 * M != CAP:
        raise ValueError("compact_cap must be even (slot pairs)")
    L_t = 2 ** d_switch
    act_i = active.to(torch.int32)
    overflow = (act_i.sum() > CAP).to(torch.int32)
    sid_nodes = torch.where(active, torch.clamp(torch.cumsum(act_i, 0) - 1, max=CAP),
                            CAP).to(torch.int64)                  # (L_t,)
    row_slot = sid_nodes[idx]                                     # (N,)
    slot_node = torch.full((CAP + 1,), -1, dtype=torch.int64, device=dev)
    slot_node[sid_nodes] = torch.where(
        active, torch.arange(L_t, device=dev), -1)
    # transition histogram: one fresh pass in slot space (no subtraction
    # across the dense/compact boundary)
    slot_hist = hist_pass(row_slot, w * (row_slot < CAP).to(w.dtype), CAP + 1)
    slot_iota = torch.arange(CAP + 1, device=dev)

    for d in range(d_switch, max_depth):
        base = 2 ** d - 1
        valid = (slot_node >= 0) & (slot_iota < CAP)
        wsum, gsum, hsum = totals(slot_hist)
        abs_node = torch.where(valid, base + slot_node, T)        # T: spare
        zero_f = torch.zeros_like(wsum)
        value_a[abs_node] = torch.where(valid, newton(gsum, hsum), zero_f)
        cover_a[abs_node] = torch.where(valid, wsum, zero_f)

        # split search over live slots (the dense level's math)
        keep = None
        if rate is not None:
            key, keep = _keep_mask(key, CAP + 1, F, rate)
        do, bf, bb, bthr = search(slot_hist, valid, keep, gsum, hsum, wsum)
        vd = valid & do
        zero_i = torch.zeros_like(bf)
        feat_a[abs_node] = torch.where(vd, bf, zero_i)
        bin_a[abs_node] = torch.where(vd, bb, zero_i)
        thr_a[abs_node] = torch.where(vd, bthr, torch.zeros_like(bthr))
        split_a[abs_node] = vd

        # partition rows
        do = vd
        rs_do = do[row_slot]
        go_right = (_row_code(codes, bf[row_slot], pack_bits) > bb[row_slot]) & rs_do
        gr = go_right.to(torch.int64)
        child_local = 2 * slot_node[row_slot] + gr
        row_leaf = torch.where(rs_do, (2 ** (d + 1) - 1) + child_local, row_leaf)

        # child slot assignment: split parents ranked, children interleaved
        do_i = do.to(torch.int32)
        rank = torch.clamp(torch.cumsum(do_i, 0) - 1, max=M - 1).to(torch.int64)
        overflow = overflow + (do_i.sum() > M).to(torch.int32)
        new_row_slot = torch.where(rs_do, 2 * rank[row_slot] + gr, CAP)
        tgt = torch.where(do, rank, M)                            # (CAP+1,)
        par_slot = torch.full((M + 1,), CAP, dtype=torch.int64, device=dev)
        par_slot[tgt] = torch.where(do, slot_iota, CAP)
        par_slot_c = torch.clamp(par_slot, max=CAP)
        par_node = torch.where(par_slot < CAP, slot_node[par_slot_c], -1)  # (M+1,)
        kids = torch.stack([2 * par_node, 2 * par_node + 1], dim=1).reshape(
            2 * (M + 1))
        kids = torch.where(kids < 0, -1, kids)
        new_slot_node = torch.cat(
            [kids[:CAP], torch.full((1,), -1, dtype=torch.int64, device=dev)])

        # child histograms: LEFT from one masked pass in parent-slot space,
        # RIGHT by parent minus left (sibling subtraction)
        hl = hist_pass(row_slot, w * ((~go_right) & rs_do).to(w.dtype), CAP + 1)
        hl_p = hl[par_slot_c]
        pair = torch.stack([hl_p, slot_hist[par_slot_c] - hl_p], dim=1).reshape(
            (2 * (M + 1),) + tuple(hl.shape[1:]))
        slot_hist = torch.cat([pair[:CAP], torch.zeros_like(hl[:1])])
        slot_node = new_slot_node
        row_slot = new_row_slot

    # final level: exact per-slot totals (dead rows sit in the trash slot)
    basef = 2 ** max_depth - 1
    valid = (slot_node >= 0) & (slot_iota < CAP)
    tot = _leaf_totals(row_slot, torch.stack([w, g * w, h * w]), CAP + 1,
                       n_shard_blocks, axis_name)
    abs_node = torch.where(valid, basef + slot_node, T)
    zero_f = torch.zeros_like(tot[:, 0])
    value_a[abs_node] = torch.where(valid, newton(tot[:, 1], tot[:, 2]), zero_f)
    cover_a[abs_node] = torch.where(valid, tot[:, 0], zero_f)
    return finish(row_leaf) + (overflow,)


def lossguide_slots(max_depth: int, max_leaves: int) -> int:
    """The frontier size S of `build_tree_lossguide`: at most S leaves, and
    at most S histogram passes a tree (the root's and one a split)."""
    full = 2 ** max_depth
    return max(2, min(max_leaves if max_leaves > 0 else full, full))


def build_tree_lossguide(
    codes: torch.Tensor,       # (N, F) uint8/int16 codes, or packed words
    g: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    feat_mask: torch.Tensor,   # (F,) per-tree column mask
    edges: torch.Tensor,       # (F, nbins-2)
    max_depth: int,
    nbins: int,
    max_leaves: int,
    min_rows: float = 1.0,
    min_split_improvement: float = 0.0,
    reg_lambda: float = 1.0,
    reg_alpha: float = 0.0,
    hist_method: str = "auto",
    max_abs_leaf: Optional[float] = None,
    pack_bits: int = 0,
):
    """Leaf-wise (best-first) growth, xgboost's `grow_policy=lossguide`
    (port of the reference's `build_tree_lossguide`).

    The frontier holds S = `lossguide_slots` leaf slots, each with its
    node's histogram and its best split. Each round splits the slot of the
    largest gain (the first on ties): the split goes into the heap, its
    rows move, the LEFT child's histogram is one masked L = 1 pass over
    all rows and the right child's is the parent's minus it (f32), and
    both children's best splits are searched (`_fused_level_best`, the
    split search of `build_tree`); a child at the depth cap cannot split.
    The reference runs all S − 1 rounds; once the best gain is not above
    max(min_split_improvement, 1e-10) no later round changes the tree, so
    this stops there. A NaN best gain (0/0 at reg_lambda = 0) splits
    nothing either, but only its slot is dropped: the other slots go on. Returns (Tree, final heap node per row, gain per
    feature, cover), as `build_tree` does without compaction."""
    dev = g.device
    F = codes.shape[1]
    N = (packing.packed_nrows(codes.shape[0], pack_bits) if pack_bits
         else codes.shape[0])
    T = heap_size(max_depth)
    S = lossguide_slots(max_depth, max_leaves)
    method = resolve_method(hist_method, dev)
    codes_w = widen(codes, pack_bits, method)
    zeros_n = torch.zeros(N, dtype=torch.int32, device=dev)
    node_ok = torch.ones(2, dtype=torch.bool, device=dev)
    thr = np.float32(max(np.float32(min_split_improvement), np.float32(1e-10)))

    def hist_pass(wts):
        return build_histograms(codes, zeros_n, g, h, wts, 1, nbins,
                                method=method, pack_bits=pack_bits,
                                codes_w=codes_w)

    def search(hist):
        """Best (gain, feature, bin) and the totals of each node of hist."""
        wsum, gsum, hsum = (hist[..., c].sum(dim=2)[:, 0] for c in range(3))
        bg, bf, bb = _fused_level_best(hist, node_ok[:hist.shape[0]],
                                       feat_mask, None, nbins, min_rows,
                                       reg_lambda, reg_alpha, gsum, hsum, wsum)
        return bg, bf, bb, wsum, gsum, hsum

    def newton(gs, hs):
        v = -_tl1(gs, reg_alpha) / (hs + reg_lambda + 1e-12)
        if max_abs_leaf is not None:
            v = torch.clamp(v, -max_abs_leaf, max_abs_leaf)
        return v.to(torch.float32)

    def row_code(f: int) -> torch.Tensor:
        if method != "pallas":
            return codes_w[f].to(torch.int32)       # feature-major: one row
        return codes_w[:, f].to(torch.int32)

    feat_a = torch.zeros(T, dtype=torch.int32, device=dev)
    bin_a = torch.zeros(T, dtype=torch.int32, device=dev)
    thr_a = torch.zeros(T, dtype=torch.float32, device=dev)
    split_a = torch.zeros(T, dtype=torch.bool, device=dev)
    value_a = torch.zeros(T, dtype=torch.float32, device=dev)
    cover_a = torch.zeros(T, dtype=torch.float32, device=dev)
    gain_pf = torch.zeros(F, dtype=torch.float32, device=dev)
    pad_edges = torch.cat(
        [edges.to(torch.float32),
         torch.full((F, 1), _INF, dtype=torch.float32, device=dev)], dim=1)

    hist0 = hist_pass(w)
    bg0, bf0, bb0, ws0, gs0, hs0 = search(hist0)
    value_a[0] = newton(gs0, hs0)[0]
    cover_a[0] = ws0[0]
    slot_hist = torch.zeros((S,) + tuple(hist0.shape[1:]), dtype=hist0.dtype,
                            device=dev)
    slot_hist[0] = hist0[0]
    slot_gain = torch.full((S,), -_INF, dtype=torch.float32, device=dev)
    slot_gain[0] = bg0[0]          # the root can split (max_depth >= 1)
    slot_feat = torch.zeros(S, dtype=torch.int32, device=dev)
    slot_feat[0] = bf0[0]
    slot_bin = torch.zeros(S, dtype=torch.int32, device=dev)
    slot_bin[0] = bb0[0]
    slot_node = [0] + [-1] * (S - 1)
    row_node = torch.zeros(N, dtype=torch.int64, device=dev)
    row_slot = torch.zeros(N, dtype=torch.int32, device=dev)

    for t in range(S - 1):
        s_star = int(_nan_first_argmax(slot_gain[None, :])[0])
        gain, bf, bb = (slot_gain[s_star].item(), int(slot_feat[s_star]),
                        int(slot_bin[s_star]))
        if np.isnan(gain):
            # NaN counts as the maximum but does not split (the reference's
            # `do` is False): the slot is dropped and the round is spent
            slot_gain[s_star], slot_feat[s_star], slot_bin[s_star] = -_INF, 0, 0
            continue
        if not np.float32(gain) > thr:
            break                  # no slot can split: nothing changes
        node = slot_node[s_star]
        left, right = 2 * node + 1, 2 * node + 2
        new_slot = t + 1
        feat_a[node] = bf
        bin_a[node] = bb
        thr_a[node] = pad_edges[bf, min(bb, nbins - 2)]
        split_a[node] = True

        in_node = row_slot == s_star
        go_right = in_node & (row_code(bf) > bb)
        row_node = torch.where(go_right, right,
                               torch.where(in_node, left, row_node))
        row_slot = torch.where(go_right, new_slot, row_slot).to(torch.int32)

        # left child: one masked histogram pass; right = parent − left
        hist_l = hist_pass(w * (in_node & ~go_right).to(w.dtype))[0]
        hist_r = slot_hist[s_star] - hist_l
        slot_hist[s_star] = hist_l
        slot_hist[new_slot] = hist_r
        slot_node[s_star], slot_node[new_slot] = left, right

        cg, cbf, cbb, cws, cgs, chs = search(torch.stack([hist_l, hist_r]))
        cval = newton(cgs, chs)
        value_a[left], value_a[right] = cval[0], cval[1]
        cover_a[left], cover_a[right] = cws[0], cws[1]
        # children at the depth cap cannot split further
        depth = (left + 1).bit_length() - 1
        if depth >= max_depth:
            cg = torch.full_like(cg, -_INF)
        slot_gain[s_star], slot_gain[new_slot] = cg[0], cg[1]
        slot_feat[s_star], slot_feat[new_slot] = cbf[0], cbf[1]
        slot_bin[s_star], slot_bin[new_slot] = cbb[0], cbb[1]
        gain_pf[bf] += np.float32(gain)

    return (Tree(feat_a, bin_a, thr_a, split_a, value_a), row_node, gain_pf,
            cover_a)


def predict_codes(tree: Tree, codes: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Leaf value per row, traversing on binned (N, F) uint8 or int16
    codes (`packing.device_codes`)."""
    node = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
    for _ in range(max_depth):
        f, b, s = tree.feat[node], tree.bin[node], tree.is_split[node]
        c = codes.gather(1, f.to(torch.int64)[:, None])[:, 0].to(torch.int32)
        node = torch.where(s, 2 * node + 1 + ((c > b) & s).to(torch.int64), node)
    return tree.value[node]


def predict_codes_packed(tree: Tree, packed: torch.Tensor, bits: int,
                         max_depth: int) -> torch.Tensor:
    """Leaf value per row, traversing straight on the `ops.packing` words;
    with bits=0 `packed` is a full-width code matrix (`predict_codes`)."""
    if not bits:
        return predict_codes(tree, packed, max_depth)
    n = packing.packed_nrows(packed.shape[0], bits)
    node = torch.zeros(n, dtype=torch.int64, device=packed.device)
    for _ in range(max_depth):
        f, b, s = tree.feat[node], tree.bin[node], tree.is_split[node]
        c = packing.packed_row_values(packed, f, bits)
        node = torch.where(s, 2 * node + 1 + ((c > b) & s).to(torch.int64), node)
    return tree.value[node]


def forest_leaves(forest: Tree, X: torch.Tensor, max_depth: int,
                  visit=None) -> torch.Tensor:
    """(ntrees, N) int64: the node each row's walk ends on in each tree of a
    stacked forest ((ntrees, T) fields) on raw features X (N, F), one gather
    round per level for all trees at once. NaN and x > thr go right, as in
    training (the NA bin is last); a node that is not split holds the row;
    feature indices are clamped into [0, F), as the reference's
    `take(..., mode="clip")`. X is f32 for scoring; on f64 X the f32
    thresholds are widened, the routing of TreeSHAP and leaf assignment.
    `visit(split, feature, goes_right)`, each (ntrees, N), is called once
    per level where given."""
    nt = forest.feat.shape[0]
    N, F = X.shape
    node = torch.zeros((nt, N), dtype=torch.int64, device=X.device)
    rows = torch.arange(N, device=X.device)[None, :]
    for _ in range(max_depth):
        f = forest.feat.gather(1, node).clamp(0, max(F - 1, 0)).to(torch.int64)
        t = forest.thr.gather(1, node)
        s = forest.is_split.gather(1, node)
        x = X[rows, f]
        right = torch.isnan(x) | (x > t)
        if visit is not None:
            visit(s, f, right)
        node = torch.where(s, 2 * node + 1 + (right & s).to(torch.int64), node)
    return node


def monotone_violations(forest: Tree, monotone) -> int:
    """Constrained splits whose subtrees break their order, over every tree
    of a stacked forest: a split on a +1 feature (`monotone` per feature,
    in {-1, 0, 1}) whose left subtree can score above its right, or on a
    −1 feature below it. A subtree's scores are the values of its nodes
    where a walk stops (nodes that do not split). A fit with monotone
    constraints has none, which makes each tree, and so the forest's sum,
    monotone in every constrained feature."""
    feat, split = forest.feat.cpu().numpy(), forest.is_split.cpu().numpy()
    value = forest.value.cpu().numpy()
    mono = np.asarray(monotone)
    inner = (feat.shape[1] - 1) // 2
    bad = 0
    for t in range(feat.shape[0]):
        lo, hi = value[t].copy(), value[t].copy()
        for i in range(inner - 1, -1, -1):
            if split[t, i]:
                lo[i] = min(lo[2 * i + 1], lo[2 * i + 2])
                hi[i] = max(hi[2 * i + 1], hi[2 * i + 2])
        for i in np.nonzero(split[t, :inner])[0]:
            c = mono[feat[t, i]]
            if (c > 0 and hi[2 * i + 1] > lo[2 * i + 2]) or \
                    (c < 0 and lo[2 * i + 1] < hi[2 * i + 2]):
                bad += 1
    return bad


def predict_raw(tree: Tree, X: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Leaf value per row on raw features X (N, F) f32: (N,) for one tree
    ((T,) fields), (ntrees, N) for a stacked forest. The walk of
    `forest_leaves` and a value gather; the reference's `predict_raw`."""
    if tree.feat.dim() == 1:
        return predict_raw(Tree(*[f[None] for f in tree]), X, max_depth)[0]
    return tree.value.gather(1, forest_leaves(tree, X, max_depth))


def predict_forest_raw(forest: Tree, X: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Σ over a stacked forest of leaf values on raw features (N, F): the
    walk of `forest_leaves`, its per-tree values summed at once."""
    return forest.value.gather(1, forest_leaves(forest, X, max_depth)).sum(dim=0)


def predict_forest_ordered(forest: Tree, X: torch.Tensor,
                           max_depth: int) -> torch.Tensor:
    """`predict_forest_raw`'s per-tree leaf values, added in tree order in
    f32 from 0.0 (one add per tree): the order the forest kernels
    (`ops/score_cuda.py`) add in, so on the card they equal it bit for
    bit."""
    leaf = forest.value.gather(1, forest_leaves(forest, X, max_depth))
    acc = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for t in range(leaf.shape[0]):
        acc = acc + leaf[t]
    return acc
