"""Path-dependent TreeSHAP over heap forests — `predict_contributions`.

Port of `h2o3_tpu/models/tree_shap.py` and of the reference's native
kernel `h2o3_tpu/native/tree_shap.cpp::h2o3_tree_shap` (host C++, OpenMP
over rows). Reference parity: `h2o-genmodel/.../algos/tree/TreeSHAP.java`
(the EXTEND/UNWIND recursion of Lundberg et al., "Consistent
Individualized Feature Attribution for Tree Ensembles") behind
`Model.scoreContributions`.

Trees are the perfect-depth heaps of `tree.py` (node i internal iff
``is_split``, children 2i+1 / 2i+2); ``cover`` holds the Σ of training row
weights per node. A row goes right iff ``x > thr`` or ``x`` is NaN, with
the f64 feature compared against the f32 threshold widened to f64, as the
reference's TreeSHAP and leaf assignment route (scoring routes f32 rows).

`compute_contributions` is the entry: the hand-written CUDA kernel
(`ops/shap_cuda.py`, `csrc/tree_shap.cu`) for tensors on a CUDA device,
`tree_shap_plain` for tensors on the CPU. The two do the same f64
operations in the same order, so on the card they agree bit for bit:

* each tree's nodes are visited depth first, the left child before the
  right (the reference visits the row's hot child first, an order that
  differs per row; the two orders differ only in the rounding of φ);
* each (row, tree) φ is summed from 0.0, and the trees are added in tree
  order from 0.0;
* the bias term (each tree's cover-weighted expectation, the reference
  numpy's `_expected_value` formula) is computed where the forest lies
  and summed in tree order on the host (`forest_bias`); a model keeps it
  per forest and scale and passes it in.

The path's structure is the same for every row: its features, its zero
fractions and which element a repeated feature unwinds. Only the one
fractions (0 or 1) and the permutation weights differ per row, so
`tree_shap_plain` recurses over the nodes once with (N,)-shaped tensors for
them. Where the reference branches on a row's one fraction, both branches
are computed and the row's is taken.

The kernel does not recurse. `build_shap_plan` computes the row-independent
part once per forest: every reachable node below the root in the DFS's
order (preorder, left child first) as the step that enters it (its
parent's feature and threshold, the side, the unwind position and level of
a repeated feature, the child's zero fraction), grouped by the leaf they
lead to. A thread rebuilds each leaf's weights along its root path, step
by step, with the same operations as the DFS: the weights at a leaf are
the result of one fixed sequence of EXTEND and UNWIND steps, so sharing
prefixes between leaves, as the DFS does and the kernel does for
consecutive leaves, changes no bit.
`tree_shap_replay_plain` is that algorithm in torch, the tests' proof that
the plan reproduces `tree_shap_plain` bit for bit.

`shapley_bruteforce` is the exponential Shapley oracle of the tests, a
copy of the reference's.
"""

from __future__ import annotations

from itertools import combinations
from math import factorial
from typing import NamedTuple

import numpy as np
import torch

from .tree import Tree

# path plans built (`build_shap_plan` calls)
plan_builds = 0


def heap_depth(n_nodes: int) -> int:
    """Depth D of a heap of 2^(D+1) − 1 nodes."""
    d = int(n_nodes + 1).bit_length() - 2
    if n_nodes < 1 or (1 << (d + 1)) - 1 != n_nodes:
        raise ValueError(f"{n_nodes} nodes is not a perfect heap")
    return d


def tree_expectations(is_split: torch.Tensor, value: torch.Tensor,
                      cover: torch.Tensor) -> torch.Tensor:
    """(ntrees,) f64 on the fields' device: each tree's expectation, the
    reference numpy's `_expected_value` (cover[l]/cn·ev(l) +
    cover[r]/cn·ev(r) at a split node of positive cover, the node's own
    value elsewhere), bottom-up over levels for all trees at once. Each
    operation is its own correctly rounded f64 kernel, so the card and the
    CPU give the same bits."""
    issp = torch.as_tensor(is_split).bool()
    value, cover = torch.as_tensor(value), torch.as_tensor(cover)
    D = heap_depth(issp.shape[1])
    lo = 2 ** D - 1
    ev = value[:, lo:].to(torch.float64)
    for lvl in range(D - 1, -1, -1):
        lo, hi = 2 ** lvl - 1, 2 ** (lvl + 1) - 1
        cn = cover[:, lo:hi].to(torch.float64)
        ch = cover[:, hi:2 * hi + 1].to(torch.float64)
        mix = ch[:, 0::2] / cn * ev[:, 0::2] + ch[:, 1::2] / cn * ev[:, 1::2]
        own = value[:, lo:hi].to(torch.float64)
        ev = torch.where(issp[:, lo:hi] & (cn > 0), mix, own)
    return ev[:, 0]


def forest_bias(forest: Tree, covers: torch.Tensor, scale: float) -> float:
    """Σ over the trees, in tree order from 0.0, of expectation · scale.
    The expectations are computed where the forest lies; only the
    (ntrees,) vector comes to the host."""
    bias = 0.0
    for e in tree_expectations(forest.is_split, forest.value,
                               covers).cpu().tolist():
        bias += e * scale
    return bias


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b with b a number: divided as a tensor, since CUDA's division by
    a host scalar multiplies by its reciprocal, which rounds otherwise."""
    if isinstance(b, torch.Tensor):
        return a / b
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


class _HostTree(NamedTuple):
    feat: np.ndarray      # int64, clamped into [0, F)
    thr: np.ndarray       # f64 (widened f32)
    is_split: np.ndarray  # bool
    value: np.ndarray     # f64 (widened f32)
    cover: np.ndarray     # f64 (widened f32)


def _extend(W, pz: float, po: torch.Tensor):
    """EXTEND by one element: the (len+1, N) weights from the (len, N) ones
    (None for the empty path). Element k is ((pz·w_k)·(len−k))/(len+1)
    plus ((po·w_{k−1})·k)/(len+1), added in that order, as the reference's
    in-place loop leaves it; the new last element is its initial weight
    plus the second term."""
    if W is None:
        return torch.ones((1, po.shape[0]), dtype=torch.float64,
                          device=po.device)
    n = W.shape[0]
    dev = W.device
    ka = torch.arange(n, 0, -1, dtype=torch.float64, device=dev)[:, None]
    kb = torch.arange(1, n + 1, dtype=torch.float64, device=dev)[:, None]
    a = _div((pz * W) * ka, n + 1.0)
    b = _div((po[None, :] * W) * kb, n + 1.0)
    return torch.cat([a[:1], a[1:] + b[:-1], torch.zeros_like(b[-1:]) + b[-1:]])


def _unwind(W, one: torch.Tensor, zero: float):
    """UNWIND element i in place of its weights: the recomputed weights keep
    their positions (the caller drops i's feature, zero and one fractions);
    returns the (len−1, N) weights."""
    n = W.shape[0]
    l = n - 1
    nxt = W[l]
    out = W.clone()
    for j in range(l - 1, -1, -1):
        tmp = _div(nxt * (l + 1.0), (j + 1.0) * one)
        w0 = _div(W[j] * (l + 1.0), zero * (l - j))
        out[j] = torch.where(one != 0, tmp, w0)
        nxt = W[j] - _div((tmp * zero) * float(l - j), l + 1.0)
    return out[:l]


def _unwound_sums(W, ones: torch.Tensor, zeros: torch.Tensor):
    """(I, N): for each path element i ≥ 1 at once (their one fractions
    (I, N), zero fractions (I, 1)), the Σ of path weights with i unwound."""
    l = W.shape[0] - 1
    nxt = W[l].expand_as(ones)
    tot1 = torch.zeros_like(ones)
    tot0 = torch.zeros_like(ones)
    for j in range(l - 1, -1, -1):
        tmp = _div(nxt * (l + 1.0), (j + 1.0) * ones)
        tot1 = tot1 + tmp
        nxt = W[j] - _div((tmp * zeros) * float(l - j), l + 1.0)
        tot0 = tot0 + _div(W[j] * (l + 1.0), zeros * float(l - j))
    return torch.where(ones != 0, tot1, tot0)


def _tree_phi(tr: _HostTree, X: torch.Tensor, scale: float,
              depth: int) -> torch.Tensor:
    """(N, F) f64: one tree's φ for every row, summed from 0.0 in the order
    of its leaves, left subtree first."""
    N, F = X.shape
    phi = torch.zeros((N, F), dtype=torch.float64, device=X.device)
    one_row = torch.ones(N, dtype=torch.float64, device=X.device)
    zero_row = torch.zeros(N, dtype=torch.float64, device=X.device)

    def visit(node, level, W, d, z, o, pz, po, pi):
        W = _extend(W, pz, po)
        d, z, o = d + [pi], z + [pz], o + [po]
        if not tr.is_split[node] or level == depth:
            if len(d) > 1:
                v = float(tr.value[node]) * scale
                ones = torch.stack(o[1:])
                zeros = torch.tensor(z[1:], dtype=torch.float64,
                                     device=X.device)[:, None]
                us = _unwound_sums(W, ones, zeros)
                c = (us * (ones - zeros)) * v
                idx = torch.tensor(d[1:], dtype=torch.int64, device=X.device)
                phi[:, idx] = phi[:, idx] + c.T
            return
        f = int(tr.feat[node])
        x = X[:, f]
        right = torch.isnan(x) | (x > float(tr.thr[node]))
        cn = float(tr.cover[node])
        denom = cn if cn > 0.0 else 1.0
        iz, io = 1.0, one_row
        for i in range(1, len(d)):
            if d[i] == f:
                iz, io = z[i], o[i]
                W = _unwind(W, io, iz)
                d, z, o = d[:i] + d[i + 1:], z[:i] + z[i + 1:], o[:i] + o[i + 1:]
                break
        left, rgt = 2 * node + 1, 2 * node + 2
        visit(left, level + 1, W, d, z, o,
              (iz * float(tr.cover[left])) / denom,
              torch.where(right, zero_row, io), f)
        visit(rgt, level + 1, W, d, z, o,
              (iz * float(tr.cover[rgt])) / denom,
              torch.where(right, io, zero_row), f)

    visit(0, 0, None, [], [], [], 1.0, one_row, -1)
    return phi


def tree_shap_plain(forest: Tree, covers: torch.Tensor, X: torch.Tensor,
                    scale: float, bias: float = None) -> torch.Tensor:
    """(N, F+1) f64 contributions of one stacked forest ((ntrees, T)
    fields) on f64 rows X (N, F): per-feature φ · scale in columns 0..F−1,
    the bias term (`forest_bias`, or `bias` where given) in column F. Runs
    on X's device; the forest's structure is read to the host once."""
    if X.dtype != torch.float64:
        raise TypeError(f"tree_shap_plain takes f64 rows, not {X.dtype}")
    N, F = X.shape
    nt, T = forest.feat.shape
    depth = heap_depth(T)
    if bias is None:
        bias = forest_bias(forest, covers, scale)
    feat = forest.feat.cpu().numpy().astype(np.int64).clip(0, max(F - 1, 0))
    thr = forest.thr.cpu().numpy().astype(np.float64)
    issp = forest.is_split.cpu().numpy().astype(bool)
    val = forest.value.cpu().numpy().astype(np.float64)
    cov = covers.cpu().numpy().astype(np.float64)
    acc = torch.zeros((N, F), dtype=torch.float64, device=X.device)
    for t in range(nt):
        acc = acc + _tree_phi(_HostTree(feat[t], thr[t], issp[t], val[t],
                                        cov[t]), X, float(scale), depth)
    out = torch.empty((N, F + 1), dtype=torch.float64, device=X.device)
    out[:, :F] = acc
    out[:, F] = bias
    return out


class ShapPlan(NamedTuple):
    """The row-independent part of a stacked forest's TreeSHAP for rows of
    `n_feat` features, on the forest's device (`build_shap_plan`).

    Steps are the reachable nodes below the roots in the DFS's order (tree
    by tree, preorder, left child first); step s is what enters its node
    from the parent split: `step_feat` (int32, the parent's feature clamped
    into [0, n_feat)), `step_thr` (f32, its threshold), `step_right` (bool,
    the node is the right child), `step_pos` (int8, the path position the
    parent's split unwinds, −1 for none), `step_ulev` (int8, the level of
    the step that put that element on the path, −1 for none) and
    `step_zin` (f64, the node's zero fraction, (iz·cover[node]) / den as
    the DFS computes it).

    Leaves are the nodes the DFS ends at (not split, or at the heap's last
    level), in its order: tree t's are [tree_leaf[t], tree_leaf[t+1]).
    Leaf l's root path has `leaf_level[l]` steps, one per level 1..level;
    the last leaf_step[l+1] − leaf_step[l] of them are steps
    [leaf_step[l], leaf_step[l+1]) (the nodes first entered on the way to
    l), the others are the previous leaf's at the same levels, which lie
    above the two leaves' common ancestor. `leaf_value` is the leaf's f32
    value. A tree whose root is a leaf has no steps and no leaves."""
    tree_leaf: torch.Tensor
    leaf_step: torch.Tensor
    leaf_level: torch.Tensor
    leaf_value: torch.Tensor
    step_feat: torch.Tensor
    step_thr: torch.Tensor
    step_right: torch.Tensor
    step_pos: torch.Tensor
    step_ulev: torch.Tensor
    step_zin: torch.Tensor
    n_feat: int
    depth: int

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self
                   if isinstance(t, torch.Tensor))


def build_shap_plan(forest: Tree, covers: torch.Tensor,
                    n_feat: int) -> ShapPlan:
    """The `ShapPlan` of a stacked forest ((ntrees, T) heaps, f32 covers)
    for rows of `n_feat` features, built with torch ops where the forest
    lies: level by level over the reachable split nodes of all trees at
    once, each carrying its path's features, zero fractions and levels;
    then one sort into the DFS's order. Each zero fraction is computed as
    the DFS computes it (iz · cover, then / den, each a correctly rounded
    f64 operation), so the two agree bit for bit."""
    global plan_builds
    plan_builds += 1
    dev = forest.feat.device
    nt, T = forest.feat.shape
    depth = heap_depth(T)
    issp = forest.is_split.bool()
    i64 = dict(dtype=torch.int64, device=dev)
    last = max(n_feat - 1, 0)
    # the fields are read at the reachable nodes only, then widened
    cov = lambda t, n: covers[t, n].to(torch.float64)  # noqa: E731
    # the current level's reachable nodes: tree, heap index, and the path
    # by position (position 0 is the root's element, feature −1; padding
    # has feature −2, zero fraction 0, level −1)
    tree = torch.arange(nt, **i64)
    node = torch.zeros(nt, **i64)
    pf = torch.full((nt, 1), -1, **i64)
    pz = torch.ones((nt, 1), dtype=torch.float64, device=dev)
    pl = torch.zeros((nt, 1), **i64)
    plen = torch.ones(nt, **i64)
    recs = []
    for lvl in range(depth):
        sp = issp[tree, node]
        tree, node, pf, pz, pl, plen = (a[sp] for a in
                                        (tree, node, pf, pz, pl, plen))
        if tree.numel() == 0:
            break
        f = forest.feat[tree, node].to(torch.int64).clamp(0, last)
        cn = cov(tree, node)
        den = torch.where(cn > 0, cn, torch.ones_like(cn))
        width = lvl + 1
        cols = torch.arange(width, **i64)
        match = (pf == f[:, None]) & (cols >= 1)
        has = match.any(dim=1)
        pos = torch.where(has, match.to(torch.int64).argmax(dim=1),
                          torch.full_like(f, -1))
        pc = pos.clamp(min=0)[:, None]
        iz = torch.where(has, pz.gather(1, pc)[:, 0], torch.ones_like(cn))
        ulev = torch.where(has, pl.gather(1, pc)[:, 0], torch.full_like(f, -1))
        # the path without the unwound element, one column wider
        src = cols[None, :] + (has[:, None] & (cols[None, :] >= pos[:, None]))
        keep = src < width
        src = src.clamp(max=width - 1)
        pad = lambda a, fill: torch.cat(  # noqa: E731
            [torch.where(keep, a.gather(1, src), torch.full_like(a, fill)),
             torch.full_like(a[:, :1], fill)], dim=1)
        pf, pz, pl = pad(pf, -2), pad(pz, 0.0), pad(pl, -1)
        plen = plen - has.to(torch.int64)
        # the two children, left then right
        side = torch.arange(2, **i64).repeat(tree.numel())
        two = lambda a: a.repeat_interleave(2, dim=0)  # noqa: E731
        tree, f, den, iz, pos, ulev, plen, pf, pz, pl, par = (
            two(a) for a in (tree, f, den, iz, pos, ulev, plen, pf, pz, pl,
                             node))
        node = 2 * par + 1 + side
        zin = (iz * cov(tree, node)) / den
        at = plen[:, None]
        pf = pf.scatter(1, at, f[:, None])
        pz = pz.scatter(1, at, zin[:, None])
        pl = pl.scatter(1, at, torch.full_like(at, lvl + 1))
        plen = plen + 1
        recs.append((tree, node, torch.full_like(tree, lvl + 1), f,
                     forest.thr[tree, par], side.bool(), pos, ulev, zin))
    if recs:
        (s_tree, s_node, s_lvl, s_f, s_thr, s_right, s_pos, s_ulev,
         s_zin) = (torch.cat(c) for c in zip(*recs))
    else:
        e = torch.zeros(0, **i64)
        s_tree = s_node = s_lvl = s_f = s_pos = s_ulev = e
        s_thr = torch.zeros(0, dtype=torch.float32, device=dev)
        s_right = torch.zeros(0, dtype=torch.bool, device=dev)
        s_zin = torch.zeros(0, dtype=torch.float64, device=dev)
    # preorder: a node's root path as bits (right = 1) left-aligned to the
    # heap's depth, ancestors before descendants
    bits = (s_node + 1 - (1 << s_lvl)) << (depth - s_lvl)
    key = ((s_tree << depth) + bits) * 32 + s_lvl
    order = torch.argsort(key)
    s_tree, s_node, s_lvl, s_f, s_thr, s_right, s_pos, s_ulev, s_zin = (
        a[order] for a in (s_tree, s_node, s_lvl, s_f, s_thr, s_right, s_pos,
                           s_ulev, s_zin))
    is_leaf = ~issp[s_tree, s_node] | (s_lvl == depth)
    at = torch.nonzero(is_leaf)[:, 0]
    zero = torch.zeros(1, **i64)
    per_tree = torch.bincount(s_tree[at], minlength=nt)
    return ShapPlan(
        tree_leaf=torch.cat([zero, per_tree.cumsum(0)]),
        leaf_step=torch.cat([zero, at + 1]),
        leaf_level=s_lvl[at].to(torch.int32),
        leaf_value=forest.value[s_tree[at], s_node[at]].to(torch.float32),
        step_feat=s_f.to(torch.int32), step_thr=s_thr.to(torch.float32),
        step_right=s_right, step_pos=s_pos.to(torch.int8),
        step_ulev=s_ulev.to(torch.int8), step_zin=s_zin,
        n_feat=int(n_feat), depth=depth)


def tree_shap_replay_plain(plan: ShapPlan, X: torch.Tensor, scale: float,
                           bias: float) -> torch.Tensor:
    """(N, F+1) f64 contributions from a `ShapPlan`: the kernel's
    algorithm in torch, vectorised over rows. For each leaf of each tree
    in order: the row's side at the leaf's new steps, then the weights
    rebuilt from the root (at each step the one fraction, UNWIND where the
    plan says, EXTEND), then the leaf's contributions added into the tree's
    φ; the trees' φ added in tree order from 0.0. Equal bit for bit to
    `tree_shap_plain` on the plan's forest. (The kernel resumes a leaf from
    the weights at its common ancestor with the previous leaf, where it
    kept them: the values this replay reaches there.)"""
    N, F = X.shape
    if F != plan.n_feat:
        raise ValueError(f"the plan is for {plan.n_feat} features, X has {F}")
    h = {k: (v.cpu().tolist() if isinstance(v, torch.Tensor) else v)
         for k, v in plan._asdict().items()}
    one_row = torch.ones(N, dtype=torch.float64, device=X.device)
    zero_row = torch.zeros(N, dtype=torch.float64, device=X.device)
    acc = torch.zeros((N, F), dtype=torch.float64, device=X.device)
    nt = len(h["tree_leaf"]) - 1
    for t in range(nt):
        phi = torch.zeros((N, F), dtype=torch.float64, device=X.device)
        slot = [None] * (plan.depth + 1)   # per level: (feat, ulev, zin)
        takes = [None] * (plan.depth + 1)  # per level: the row takes its side
        for leaf in range(h["tree_leaf"][t], h["tree_leaf"][t + 1]):
            k = h["leaf_level"][leaf]
            s0, s1 = h["leaf_step"][leaf], h["leaf_step"][leaf + 1]
            for j, s in zip(range(k - (s1 - s0) + 1, k + 1), range(s0, s1)):
                f = h["step_feat"][s]
                x = X[:, f]
                right = torch.isnan(x) | (x > float(h["step_thr"][s]))
                takes[j] = right == bool(h["step_right"][s])
                slot[j] = (f, h["step_ulev"][s], h["step_zin"][s])
            W = _extend(None, 1.0, one_row)
            ones, alive = {}, []
            for j in range(1, k + 1):
                f, ulev, z = slot[j]
                io = one_row
                if ulev >= 0:
                    io = ones[ulev]
                    W = _unwind(W, io, slot[ulev][2])
                    alive.remove(ulev)
                ones[j] = torch.where(takes[j], io, zero_row)
                W = _extend(W, z, ones[j])
                alive.append(j)
            if alive:
                v = float(h["leaf_value"][leaf]) * scale
                o = torch.stack([ones[j] for j in alive])
                zeros = torch.tensor([slot[j][2] for j in alive],
                                     dtype=torch.float64,
                                     device=X.device)[:, None]
                c = (_unwound_sums(W, o, zeros) * (o - zeros)) * v
                idx = torch.tensor([slot[j][0] for j in alive],
                                   dtype=torch.int64, device=X.device)
                phi[:, idx] = phi[:, idx] + c.T
        acc = acc + phi
    out = torch.empty((N, F + 1), dtype=torch.float64, device=X.device)
    out[:, :F] = acc
    out[:, F] = bias
    return out


def compute_contributions(forest: Tree, covers: torch.Tensor, X: torch.Tensor,
                          scale: float, f0: float, bias: float = None,
                          plan: ShapPlan = None) -> torch.Tensor:
    """The contributions entry shared by the model and the MOJO scorer:
    (N, F+1) f64 with f0·scale folded into the bias term (`forest_bias`,
    or `bias` where the caller keeps it). The CUDA kernel for X on a CUDA
    device (`shap_cuda.tree_shap` over `plan`, or a plan it builds; a
    failed build or launch raises `hist_cuda.KernelError`),
    `tree_shap_plain` for X on the CPU."""
    if tuple(covers.shape) != tuple(forest.feat.shape):
        raise ValueError(
            f"covers shape {tuple(covers.shape)} does not match forest "
            f"{tuple(forest.feat.shape)} (model continued from a "
            "pre-TreeSHAP checkpoint?); retrain to enable "
            "predict_contributions")
    scale = float(scale)
    if bias is None:
        bias = forest_bias(forest, covers, scale)
    if X.device.type == "cpu":
        out = tree_shap_plain(forest, covers, X, scale, bias)
    else:
        from ..ops import shap_cuda

        out = shap_cuda.tree_shap(forest, covers, X, scale, bias, plan=plan)
    out[:, -1] += float(f0) * scale
    return out


# ---------------------------------------------------------------------------
# brute-force Shapley oracle (tests only) — exponential in F
# ---------------------------------------------------------------------------

def _cond_expectation(feat, thr, is_split, value, cover, x, known):
    """EXPVALUE(x, S): walk splits on known features, average on unknown."""

    def go(node):
        if not is_split[node]:
            return value[node]
        f = feat[node]
        l, r = 2 * node + 1, 2 * node + 2
        if f in known:
            xv = x[f]
            return go(r) if (np.isnan(xv) or xv > thr[node]) else go(l)
        cn = cover[node]
        if cn <= 0:
            return value[node]
        return cover[l] / cn * go(l) + cover[r] / cn * go(r)

    return go(0)


def shapley_bruteforce(forest, covers, x: np.ndarray) -> np.ndarray:
    """Exact path-dependent Shapley values for one row (tests)."""
    feat = np.asarray(forest.feat, np.int64)
    thr = np.asarray(forest.thr, np.float64)
    issp = np.asarray(forest.is_split, bool)
    val = np.asarray(forest.value, np.float64)
    cov = np.asarray(covers, np.float64)
    F = x.shape[0]
    phi = np.zeros(F + 1)
    for t in range(feat.shape[0]):
        args = (feat[t], thr[t], issp[t], val[t], cov[t], x)
        for i in range(F):
            rest = [j for j in range(F) if j != i]
            for k in range(F):
                for S in combinations(rest, k):
                    wgt = factorial(k) * factorial(F - k - 1) / factorial(F)
                    with_i = _cond_expectation(*args, set(S) | {i})
                    without = _cond_expectation(*args, set(S))
                    phi[i] += wgt * (with_i - without)
        phi[F] += _cond_expectation(*args, set())
    return phi
