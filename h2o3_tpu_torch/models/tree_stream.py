"""Streamed tree step — the out-of-core GBM/DRF tree.

Port of `h2o3_tpu/models/tree_stream.py`. When the packed code matrix
does not fit the device budget, the fit keeps it in a `BlockStore` (host
row blocks, a bounded device set) and builds each tree from per-block
passes instead of one pass over a resident matrix. Only the code matrix
streams: margins, gradients, weights and each block's node ids stay on
the device.

Each level walks the blocks in order. A block visit at level d applies
level d-1's partition to the block's rows and accumulates level d's
sibling-left histogram partial (`ops.histogram.run_block_kernel`: B1 on
feature-major codes, or B2 on row-major codes under
``hist_method="pallas"``), so a tree reads (depth + 1)·S blocks. Before
block b's kernel runs, the upload of block b + 1 is started
(`BlockStore.prefetch`, a side CUDA stream on the card). The partials
fold left to right (`ordered_axis_fold`), the right siblings are the
parent's histogram less the left, and the level is decided by the
in-core tree's own pieces (`tree.LevelRule`, `tree.partition`, the
`ops.prng` key chain of the mtries column sample); the last visit of each
block applies the last partition and sums the block's exact leaf totals
(`tree._fixed_totals`), folded in block order. So with sampling off a
streamed fit equals the in-core fit of the blocks lane that shares its
block count S bit for bit (``H2O3_TREE_SHARD=1``,
``H2O3_TREE_SHARD_BLOCKS=S``): forest, varimp, scoring history, the
early-stop tree count and predictions. It does not equal the unblocked
fit: B1's fixed-point scale is per pass, so each block's partial is its
own rounding.

Gradient-based one-side sampling (GOSS, ``goss=True``, GBM with one margin
only): from ``goss_start_tree`` on, a tree keeps the top ``goss_top_rate``
of the rows by |g| (an exact count, `np.argpartition`) and a
``goss_other_rate`` draw of the rest, amplified by (1 - a) / b, gathers
them from the host blocks into one compact packed sample, builds the tree
on it (S = 1), and then streams every block once for the full-row margin
update. It is not bit-comparable with the unsampled fit.

The reference's host-histogram lane (``host_hist_direct``) waits for the
``host`` histogram method (ROADMAP queue A, item 3): a streamed fit that
asks for it raises. The reference's QoS yield points and supervisor
pulses between block visits wait for ROADMAP queue A, items 9 and 11.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import packing, prng
from ..ops.histogram import (DISPATCH, ordered_axis_fold, resolve_method,
                             run_block_kernel)
from . import tree as treelib


class _ResidentBlocks:
    """The provider surface of `BlockStore` over blocks already on the
    device (GOSS's compact sample)."""

    def __init__(self, dev_blocks: List[torch.Tensor]):
        self._dev = dev_blocks

    def get(self, b: int) -> torch.Tensor:
        return self._dev[b]

    def prefetch(self, b: int) -> None:
        pass


class StreamedTreeStep:
    """Builds one class tree of a fit over a `BlockStore`: the streamed
    counterpart of `tree.build_tree` plus the scale and leaf-value lines
    of the fit loop (`shared_tree._fit`), which calls it in their place.
    The loop keeps the rest of the iteration (row and column samples, key
    chain, gradients, margin and out-of-bag updates, scoring)."""

    def __init__(self, store, *, npad: int, max_depth: int, nbins: int,
                 hist_method: str, min_rows: float,
                 min_split_improvement: float, reg_lambda: float,
                 reg_alpha: float, max_abs_leaf: Optional[float],
                 mtries_rate: Optional[float] = None, seed: int = 0,
                 goss: Optional[Dict] = None):
        if store.n_blocks <= 0 or npad % store.n_blocks:
            raise ValueError("streamed step needs an aligned block grid")
        if hist_method == "host":
            raise NotImplementedError(
                "the streamed host-histogram lane waits for the 'host' "
                "histogram method (ROADMAP queue A, item 3)")
        self.store = store
        self.S = int(store.n_blocks)
        self.rows = npad // self.S
        self.max_depth = int(max_depth)
        self.nbins = int(nbins)
        self.pack_bits = int(store.pack_bits)
        self.hist_method = hist_method
        self.rule_args = (nbins, min_rows, min_split_improvement, reg_lambda,
                          reg_alpha, max_abs_leaf)
        self.mtries_rate = mtries_rate
        self.seed = int(seed)
        self.goss = goss
        if goss:
            a, b = goss["top_rate"], goss["other_rate"]
            frac = min(a + b * 1.25 + 0.02, 1.0)
            cap = int(npad * frac) + 8
            self.goss_cap = min(npad, ((cap + 7) // 8) * 8)

    # -- the streamed build_tree (dense depth-wise levels) -----------------

    def _build_streamed(self, provider, S: int, rows: int, g, h, wt, fm,
                        edges, key):
        """(Tree, leaf heap index per row, gain per feature, cover) over
        the S blocks of `provider`, each `rows` rows."""
        dev = g.device
        D, nbins, bits = self.max_depth, self.nbins, self.pack_bits
        F = edges.shape[0]
        rule = treelib.LevelRule(fm, edges, *self.rule_args)
        heap = treelib.Heap(D, dev)
        method = resolve_method(self.hist_method, dev)
        rate = (torch.tensor(self.mtries_rate, dtype=torch.float32,
                             device=dev)
                if self.mtries_rate is not None else None)
        if rate is not None and key is None:
            key = prng.PRNGKey(0)
        active = torch.ones(1, dtype=torch.bool, device=dev)
        idx_blocks = [torch.zeros(rows, dtype=torch.int64, device=dev)
                      for _ in range(S)]
        dec = None
        hist_prev = None
        for d in range(D):
            L = 2 ** d
            DISPATCH[method] += 1
            parts = []
            for b in range(S):
                codes_b = provider.get(b)
                # block b + 1's upload runs while block b's kernel does
                provider.prefetch((b + 1) % S)
                r = slice(b * rows, (b + 1) * rows)
                w_eff = wt[r]
                if d:
                    idx_b = treelib.partition(codes_b, idx_blocks[b], *dec,
                                              bits)
                    idx_blocks[b] = idx_b
                    w_eff = w_eff * (idx_b % 2 == 0).to(w_eff.dtype)
                    node = idx_b // 2
                else:
                    node = idx_blocks[b]
                vals = torch.stack([w_eff, g[r] * w_eff,
                                    h[r] * w_eff]).to(torch.float32)
                parts.append(run_block_kernel(method, codes_b, node, vals,
                                              max(L // 2, 1), nbins, bits))
            merged = ordered_axis_fold(torch.stack(parts))
            if d:
                # sibling subtraction: right = parent − left
                hist = torch.stack([merged, hist_prev - merged], dim=1).reshape(
                    (L,) + tuple(merged.shape[1:]))
            else:
                hist = merged
            hist_prev = hist
            keep = None
            if rate is not None:
                key, keep = treelib._keep_mask(key, L, F, rate)
            do_split, bf, bb = rule.dense_level(heap, d, hist, active, keep)
            active = torch.repeat_interleave(do_split, 2)
            dec = (bf, bb, do_split)
        # the last visit: the last level's partition and exact leaf totals
        Lf = 2 ** D
        tots = []
        for b in range(S):
            codes_b = provider.get(b)
            provider.prefetch((b + 1) % S)
            r = slice(b * rows, (b + 1) * rows)
            idx_b = treelib.partition(codes_b, idx_blocks[b], *dec, bits)
            idx_blocks[b] = idx_b
            w_b = wt[r]
            tots.append(treelib._fixed_totals(
                idx_b, torch.stack([w_b, g[r] * w_b, h[r] * w_b]), Lf))
        rule.leaf_level(heap, D, ordered_axis_fold(torch.stack(tots)))
        leaf_idx = torch.cat(idx_blocks) + (Lf - 1)
        return (heap.tree(), leaf_idx, rule.gain_per_feature,
                heap.cover[:heap.T])

    # -- GOSS: gradient-based sampling -------------------------------------

    def _goss_active(self, m: int) -> bool:
        return self.goss is not None and m >= self.goss["start_tree"]

    def _gather_codes(self, sel: np.ndarray, F: int) -> np.ndarray:
        """The selected rows gathered from the host blocks into a compact
        full-width matrix (one block unpacked at a time)."""
        out = np.zeros((self.goss_cap, F), np.uint8)
        rows, bits = self.rows, self.pack_bits
        blk = sel // rows
        pos = 0
        for b in np.unique(blk):
            rb = sel[blk == b] - b * rows
            # a restoring fetch: GOSS on the disk tier reads each block the
            # sample touches once, here
            hb = self.store.fetch_host(int(b))
            dense = packing.unpack_host(hb, bits) if bits else hb
            out[pos:pos + len(rb)] = dense[rb]
            pos += len(rb)
        return out

    def _goss_tree(self, g, h, w_a, fm, edges, key, m: int, scale):
        """One GOSS tree: built on the compact top-|g| + amplified-rest
        sample, then every block streamed once for the full-row leaf
        values. Returns (scaled tree, full-row leaf values, gains,
        cover)."""
        dev = g.device
        bits = self.pack_bits
        a, brate = self.goss["top_rate"], self.goss["other_rate"]
        amp = np.float32((1.0 - a) / brate)
        w_host = w_a.cpu().numpy().astype(np.float32)
        w_np = w_host > 0
        absg = np.where(w_np, np.abs(g.cpu().numpy().astype(np.float32)),
                        -1.0)
        n_real = max(int(w_np.sum()), 1)
        n_top = max(int(a * n_real), 1)
        # exactly n_top rows: a `>= threshold` mask over-selects on tied |g|
        # (sign-shaped gradients tie on every row) and the cap trim would
        # then keep an index-biased subset
        top = np.zeros(absg.shape[0], bool)
        top[np.argpartition(absg, -n_top)[-n_top:]] = True
        rng = np.random.default_rng((self.seed + 7919 * (m + 1))
                                    & 0x7FFFFFFF)
        rest = (~top) & w_np & (rng.random(absg.shape[0])
                                < brate / max(1.0 - a, 1e-9))
        weight = np.where(top, np.float32(1.0),
                          np.where(rest, amp, np.float32(0.0))
                          ).astype(np.float32)
        sel = np.nonzero(weight > 0)[0]
        if len(sel) > self.goss_cap:
            sel = sel[:self.goss_cap]    # deterministic slack trim
        cap = self.goss_cap
        codes_sel = self._gather_codes(sel, edges.shape[0])
        packed_sel = packing.pack_host(codes_sel, bits) if bits else codes_sel
        sample = torch.from_numpy(packed_sel).to(dev)
        self.store.account_external_bytes(int(packed_sel.nbytes))
        sel_pad = np.zeros(cap, np.int64)
        sel_pad[:len(sel)] = sel
        sel_d = torch.from_numpy(sel_pad).to(dev)
        w_sel = np.zeros(cap, np.float32)
        w_sel[:len(sel)] = w_host[sel] * weight[sel]
        tr, _, gains, cover = self._build_streamed(
            _ResidentBlocks([sample]), 1, cap, g[sel_d],
            h[sel_d], torch.from_numpy(w_sel).to(dev), fm, edges, key)
        tr = tr._replace(value=tr.value * scale)
        vals = []
        for b in range(self.S):
            codes_b = self.store.get(b)
            self.store.prefetch((b + 1) % self.S)
            vals.append(treelib.predict_codes_packed(tr, codes_b, bits,
                                                     self.max_depth))
        return tr, torch.cat(vals), gains, cover

    # -- the step ----------------------------------------------------------

    def __call__(self, g, h, wt, fm, edges, key, m: int, scale):
        """One class tree of iteration m: (tree with its values scaled,
        the leaf value of every row, gain per feature, cover). `wt` are
        the row weights after row sampling (GOSS keeps sample_rate 1, so
        they are the fit's weights); `scale` is the learning-rate factor
        (a 0-d f32 tensor)."""
        if self._goss_active(int(m)):
            return self._goss_tree(g, h, wt, fm, edges, key, int(m), scale)
        tr, leaf_idx, gains, cover = self._build_streamed(
            self.store, self.S, self.rows, g, h, wt, fm, edges, key)
        tr = tr._replace(value=tr.value * scale)
        return tr, treelib.value_at(tr.value, leaf_idx), gains, cover
