"""Host collectives and the canonical row layout — the port of
`h2o3_tpu/parallel/distdata.py`.

Reference parity: `water/fvec/Vec`'s home-node chunk layout + `MRTask`'s
implicit "compute where the data lives". Each rank holds the rows it
ingested (its ingest shard, contiguous in the global row order and in rank
order); host-side reductions that the reference ran as MRTask reduces
(global means, min/max, weighted sums, quantiles) run here as gathers on
the cloud's gloo group (`mesh.Cloud.host_group`). f64 travels as raw
bytes, so global sums and ranges stay exact.

Torch has no global array. Where the reference assembles a global
row-sharded `jax.Array`, the port keeps this rank's slice:
`global_row_array`, `replicated_array` and `sharded_full` give this rank's
rows, or the replicated value, as a tensor on the rank's device, and
`local_shard` / `to_local` are the identity on such tensors (a host
array of them).

Row balancing: the quota layout pads every rank's rows to the agreed
per-rank quota with ZERO-WEIGHT rows. The canonical layout below (pod
training) instead keeps every real row contiguous in global ingest order
with all pad at the global tail, each rank owning an equal slice.

`global_quantiles` finishes the reference's refinement with an exact
step: the order statistics it interpolates are the global column's own
values, so its result is `np.quantile` of the global column bit for bit
(a pod's QuantilesGlobal edges equal the one-process fit's).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import mesh

# dtypes the gloo all-gather moves as tensors; the rest (f64 included)
# travel as bytes
_TENSOR_DTYPES = (np.float32, np.int32, np.int64, np.uint8)


def multiprocess() -> bool:
    return mesh.cloud().size > 1


def _rank() -> int:
    return mesh.cloud().self_idx


def _all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    import torch.distributed as dist

    c = mesh.cloud()
    bufs = [torch.empty_like(t) for _ in range(c.size)]
    dist.all_gather(bufs, t.contiguous(), group=c.host_group)
    return bufs


def allgather_bytes(payload: bytes) -> "list[bytes]":
    """Variable-length byte blobs from every rank, in rank order: the
    lengths first, then padded uint8 tensors."""
    if not multiprocess():
        return [payload]
    lens = torch.cat(_all_gather(torch.tensor([len(payload)],
                                              dtype=torch.int64))).numpy()
    maxlen = int(max(lens.max(), 1))
    buf = np.zeros(maxlen, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    out = _all_gather(torch.from_numpy(buf))
    return [out[r].numpy()[: lens[r]].tobytes() for r in range(len(lens))]


def allgather_host(arr: np.ndarray) -> np.ndarray:
    """(nproc, *arr.shape) stack of every rank's host array. f64 (and any
    type gloo does not gather as a tensor) travels as raw bytes."""
    a = np.ascontiguousarray(arr)
    if not multiprocess():
        return a[None]
    if a.dtype.type not in _TENSOR_DTYPES:
        blobs = allgather_bytes(a.tobytes())
        return np.stack([np.frombuffer(b, a.dtype).reshape(a.shape)
                         for b in blobs])
    return torch.stack(_all_gather(torch.from_numpy(a))).numpy()


def global_sum(arr: np.ndarray) -> np.ndarray:
    return allgather_host(np.asarray(arr)).sum(axis=0)


def allgather_rows(local: np.ndarray) -> np.ndarray:
    """Rank-order concatenation of every rank's local rows — the GLOBAL
    row order (ingest shards are contiguous and assigned in rank order).
    Ranks may hold different row counts; byte transport keeps dtypes
    exact."""
    a = np.ascontiguousarray(local)
    if not multiprocess():
        return a
    blobs = allgather_bytes(a.tobytes())
    trail = a.shape[1:]
    return np.concatenate([
        np.frombuffer(b, a.dtype).reshape((-1,) + trail) for b in blobs])


def allgather_rows_padded(local: np.ndarray, quota: int,
                          counts: np.ndarray) -> np.ndarray:
    """Global row-order concat with ONE fixed-size gather: each rank pads
    its rows to `quota`, gathers (nproc, quota, ...) and trims per the
    known per-rank `counts`. Float64 inputs are rejected, as in the
    reference (use `allgather_rows` for exact f64)."""
    a = np.ascontiguousarray(local)
    if a.dtype == np.float64:
        raise TypeError("allgather_rows_padded is f32/int transport; "
                        "use allgather_rows for exact f64")
    if not multiprocess():
        return a
    pad = quota - a.shape[0]
    if pad > 0:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    out = allgather_host(a)                      # (nproc, quota, ...)
    return np.concatenate([out[r, : int(counts[r])]
                           for r in range(len(counts))])


def row_counts(n_local: int) -> np.ndarray:
    """Per-rank local row counts in rank order (one gather)."""
    return allgather_host(np.asarray([n_local], np.int64)).reshape(-1)


def row_offset(n_local: int) -> int:
    """This rank's first-row index in the global row order."""
    if not multiprocess():
        return 0
    return int(row_counts(n_local)[: _rank()].sum())


def global_any(flag: bool) -> bool:
    """True iff ANY rank votes True (one gather; one rank = identity).
    The transport for control-flow consensus — every rank MUST take the
    same branch or the next collective deadlocks (clock and early-stop
    votes)."""
    if not multiprocess():
        return bool(flag)
    votes = allgather_host(
        np.asarray([1.0 if flag else 0.0], np.float32)).reshape(-1)
    return bool(votes.max() >= 0.5)


def global_all(flag: bool) -> bool:
    """True iff EVERY rank votes True (one gather)."""
    if not multiprocess():
        return bool(flag)
    votes = allgather_host(
        np.asarray([1.0 if flag else 0.0], np.float32)).reshape(-1)
    return bool(votes.min() >= 0.5)


def global_minmax(local_min: np.ndarray, local_max: np.ndarray):
    """Per-column global (min, max) from per-rank locals (NaN-safe: a rank
    with no finite values contributes ±inf)."""
    mins = allgather_host(np.asarray(local_min, np.float64))
    maxs = allgather_host(np.asarray(local_max, np.float64))
    return np.min(mins, axis=0), np.max(maxs, axis=0)


def local_quota(n_local: int, row_multiple: int = 8) -> int:
    """The per-rank padded row count every rank agrees on: the max local
    count, rounded up to `row_multiple` (one device a rank)."""
    counts = allgather_host(np.asarray([n_local], np.int32)).reshape(-1)
    return mesh.pad_to_multiple(int(counts.max()), max(row_multiple, 1))


def _device(cloud) -> torch.device:
    from .. import device as devlib

    return devlib.resolve(None)


def global_row_array(local: np.ndarray, quota: int, cloud=None, fill=0):
    """This rank's rows padded to `quota`, as a tensor on the rank's
    device (the reference assembles the global row-sharded array of
    nproc·quota rows; torch keeps the rank's slice)."""
    pad = quota - local.shape[0]
    if pad:
        fill_block = np.full((pad,) + local.shape[1:], fill, local.dtype)
        local = np.concatenate([local, fill_block])
    return torch.from_numpy(np.ascontiguousarray(local)).to(_device(cloud))


def replicated_array(host_value, cloud=None):
    """Host value (identical on every rank) → a tensor on the rank's
    device."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(host_value))).to(_device(cloud))


def sharded_full(shape, value, dtype, cloud=None):
    """This rank's slice (shape[0] / nproc rows) of a row-sharded
    constant, made on the device."""
    c = cloud if cloud is not None else mesh.cloud()
    rows = int(shape[0]) // max(c.size, 1)
    return torch.full((rows,) + tuple(shape[1:]), value, dtype=dtype,
                      device=_device(c))


def _refine(vs: List[np.ndarray], ranks: List[np.ndarray], iters: int,
            nb: int):
    """The reference's iterative histogram refinement, over several columns
    at once (one gather an iteration for all of them): `vs` are the sorted
    local values of each column, `ranks` the order statistics tracked in
    each. Per column: (lo, hi) per tracked rank, or None where the column
    has no finite value anywhere. Each column's arithmetic is the
    reference's single-column one."""
    glo, ghi = global_minmax(
        np.asarray([v[0] if v.size else np.inf for v in vs]),
        np.asarray([v[-1] if v.size else -np.inf for v in vs]))
    lo = [np.full(len(r), glo[c]) for c, r in enumerate(ranks)]
    hi = [np.full(len(r), ghi[c]) for c, r in enumerate(ranks)]
    # global count of values < lo[m]
    below = [np.zeros(len(r), np.int64) for r in ranks]
    live = [c for c in range(len(vs))
            if np.isfinite(glo[c]) and ghi[c] > glo[c]]
    for _ in range(iters):
        counts = []
        for c in live:
            # counts[m, b] = #local values in bin b of interval m
            # (right-closed last bin, matching np.histogram)
            edges = lo[c][:, None] + (hi[c] - lo[c])[:, None] * (
                np.arange(nb + 1)[None, :] / nb)
            idx = np.searchsorted(vs[c], edges)           # (M, nb+1)
            idx[:, -1] = np.searchsorted(vs[c], edges[:, -1], side="right")
            counts.append(np.diff(idx, axis=1).astype(np.float64))
        # exact: integer-valued
        flat = global_sum(np.concatenate([x.ravel() for x in counts])
                          if counts else np.zeros(0))
        off = 0
        for c, cnt in zip(live, counts):
            gc = flat[off: off + cnt.size].reshape(cnt.shape)
            off += cnt.size
            cum = below[c][:, None] + np.cumsum(gc, axis=1)   # (M, nb)
            # bin containing rank k: first bin with cum > k
            b = (cum <= ranks[c][:, None]).sum(axis=1)
            b = np.minimum(b, nb - 1)
            prev = np.where(b > 0, np.take_along_axis(cum, np.maximum(
                b - 1, 0)[:, None], axis=1)[:, 0], below[c])
            below[c] = np.where(b > 0, prev.astype(np.int64), below[c])
            width = (hi[c] - lo[c]) / nb
            lo[c] = lo[c] + b * width
            hi[c] = lo[c] + width
    return [(lo[c], hi[c]) if np.isfinite(glo[c]) else None
            for c in range(len(vs))]


def global_order_stats(values: np.ndarray, ranks: Sequence[int],
                       iters: int = 4, nb: int = 512) -> np.ndarray:
    """Exact-to-f32-ulp global order statistics x_(k) (0-based, global sort
    order) of a column whose rows are scattered across ranks — the
    `hex/quantile/Quantile.java` iterative-histogram-refinement design as a
    host collective: each iteration histograms the local shard into `nb`
    uniform bins per tracked rank interval, sums the counts globally (exact
    integers, so the refinement path does not depend on the rank count)
    and shrinks each interval to the bin holding its rank. The midpoint of
    the final interval is returned. `values` must be this rank's finite
    values (NaNs pre-dropped)."""
    v = np.sort(np.asarray(values, np.float64))
    ranks = np.asarray(ranks, np.int64)
    (got,) = _refine([v], [ranks], iters, nb)
    if got is None:
        return np.full(len(ranks), np.nan)
    lo, hi = got
    return (lo + hi) / 2


def _exact_order_stats(vs: List[np.ndarray], ranks: List[np.ndarray],
                       los: List[np.ndarray]) -> List[np.ndarray]:
    """The global order statistics x_(k) themselves, per column, from
    intervals whose lower ends `los` sit at or below them: count the global
    values below each lo exactly, then each rank sends the distinct values
    (with counts) among its first `need + 1` values at or above lo, where
    `need` is how many global values ≥ lo precede x_(k). Every value up to
    x_(k) is in some rank's list, so the merged list holds it. Two gathers
    for all columns."""
    sizes = [len(r) for r in ranks]
    below = np.split(global_sum(np.concatenate([
        np.searchsorted(v, lo, side="left").astype(np.int64)
        for v, lo in zip(vs, los)])), np.cumsum(sizes)[:-1])
    parts, need = [], []
    for v, r, lo, bl in zip(vs, ranks, los, below):
        # an interval that rounding moved past its statistic restarts from
        # the bottom of the column (exact, only costlier)
        lo = np.where(bl > r, -np.inf, lo)
        nd = r - np.where(bl > r, 0, bl)
        need.append(nd)
        for m in range(len(r)):
            i0 = int(np.searchsorted(v, lo[m], side="left"))
            u, c = np.unique(v[i0: i0 + int(nd[m]) + 1], return_counts=True)
            parts.append(np.stack([u, c.astype(np.float64)]))
    lens = np.asarray([p.shape[1] for p in parts], np.int64)
    M = len(parts)
    blobs = allgather_bytes(lens.tobytes()
                            + b"".join(p.tobytes() for p in parts))
    merged: List[List[np.ndarray]] = [[] for _ in range(M)]
    for blob in blobs:
        ls = np.frombuffer(blob[: 8 * M], np.int64)
        off = 8 * M
        for m in range(M):
            nbytes = 16 * int(ls[m])
            merged[m].append(np.frombuffer(
                blob[off: off + nbytes], np.float64).reshape(2, -1))
            off += nbytes
    out = np.empty(M)
    flat_need = np.concatenate(need) if need else np.zeros(0, np.int64)
    for m in range(M):
        allv = np.concatenate(merged[m], axis=1)
        u, inv = np.unique(allv[0], return_inverse=True)
        cum = np.cumsum(np.bincount(inv, weights=allv[1]))
        out[m] = u[int(np.searchsorted(cum, flat_need[m], side="right"))]
    return np.split(out, np.cumsum(sizes)[:-1])


def global_quantiles(values: np.ndarray, probs: Sequence[float],
                     n_global: Optional[int] = None) -> np.ndarray:
    """`np.quantile` (linear interpolation) over the global multiset of a
    scattered column, bit for bit (`global_quantiles_columns` of one
    column). Deterministic across cloud sizes."""
    return global_quantiles_columns(
        [values], probs, None if n_global is None else [n_global])[0]


def global_quantiles_columns(columns: Sequence[np.ndarray],
                             probs: Sequence[float],
                             n_global: Optional[Sequence[int]] = None
                             ) -> List[np.ndarray]:
    """`global_quantiles` of several columns in the same few gathers: the
    refinement narrows each needed order statistic, `_exact_order_stats`
    resolves it to the column's own value, and `np.quantile` runs on a
    length-n sorted stand-in that holds those values at their global
    positions (around ⌊q·(n−1)⌋, one either side, so numpy's own index
    arithmetic reads them)."""
    vs = []
    for values in columns:
        v = np.sort(np.asarray(values, np.float64))
        vs.append(v[np.isfinite(v)])
    if n_global is None:
        n_global = global_sum(np.asarray([v.size for v in vs], np.int64))
    t = np.asarray(probs, np.float64)
    ks = [np.unique(np.clip(np.concatenate([k - 1, k, k + 1, k + 2]), 0,
                            max(int(n) - 1, 0)))
          for n in n_global
          for k in [np.floor(t * (int(n) - 1)).astype(np.int64)]]
    live = [c for c, n in enumerate(n_global) if int(n) > 0]
    out = [np.full(len(probs), np.nan) for _ in columns]
    if not live:
        return out
    got = _refine([vs[c] for c in live], [ks[c] for c in live], 4, 512)
    # one interval width of margin below each: the refinement's ends are
    # rounded, the statistic must not fall under them
    xs = _exact_order_stats([vs[c] for c in live], [ks[c] for c in live],
                            [lo - (hi - lo) for lo, hi in got])
    for c, x in zip(live, xs):
        n = int(n_global[c])
        stand_in = np.empty(n)
        starts = np.concatenate([[0], ks[c][1:]])
        stops = np.concatenate([ks[c][1:], [n]])
        for val, a, b in zip(x, starts, stops):
            stand_in[a:b] = val
        out[c] = np.quantile(stand_in, probs)
    return out


# -- canonical row layout (pod training) -------------------------------------
#
# The quota layout above pads every rank's tail, so pad rows INTERLEAVE with
# real rows at rank boundaries in the global order. A padded block then holds
# a different subset of real rows than the same block of a single-process
# fit, and the f32 blocked fold — deterministic per layout — cannot be
# bit-identical across cloud sizes. The canonical layout fixes the geometry
# instead of the algorithm: all real rows stay contiguous in global ingest
# order, ALL pad sits at the global tail, and each rank owns an equal
# `npad // nproc` slice. Ingest already lands each rank near its canonical
# slice, so the exchange moves only the misaligned boundary spans (exact
# byte transport), never the bulk.


def canonical_counts(counts: np.ndarray, npad: int) -> np.ndarray:
    """Per-rank REAL-row counts under the canonical equal split: rank r owns
    canonical rows [r·shard, (r+1)·shard) of [real rows | tail pad]."""
    counts = np.asarray(counts, np.int64)
    nproc = len(counts)
    if npad % nproc:
        raise ValueError(f"npad {npad} not divisible by nproc {nproc}")
    shard = npad // nproc
    n_global = int(counts.sum())
    starts = np.minimum(np.arange(nproc, dtype=np.int64) * shard, n_global)
    stops = np.minimum((np.arange(nproc, dtype=np.int64) + 1) * shard,
                       n_global)
    return stops - starts


def export_spans(src_counts: np.ndarray, dst_counts: np.ndarray,
                 rank: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Pure routing math: the (global_start, length) head and tail spans of
    `rank`'s source rows that fall OUTSIDE its destination range when the
    global row concatenation is re-split from `src_counts` to
    `dst_counts`. Both count vectors must sum to the same global total."""
    src = np.asarray(src_counts, np.int64)
    dst = np.asarray(dst_counts, np.int64)
    soff = int(src[:rank].sum())
    sn = int(src[rank])
    doff = int(dst[:rank].sum())
    dn = int(dst[rank])
    head_stop = min(soff + sn, doff)
    head = (soff, max(head_stop - soff, 0))
    tail_start = max(soff, doff + dn)
    tail = (tail_start, max(soff + sn - tail_start, 0))
    return head, tail


def exchange_rows(local: np.ndarray, src_counts: np.ndarray,
                  dst_counts: np.ndarray) -> np.ndarray:
    """Re-split the conceptual global row concatenation from `src_counts`
    to `dst_counts`: each rank exports only the rows outside its own
    destination range (one small gather of the boundary spans, exact byte
    transport) and assembles its destination slice from the local overlap
    plus imports. O(misalignment) traffic, not O(n)."""
    a = np.ascontiguousarray(local)
    src = np.asarray(src_counts, np.int64)
    dst = np.asarray(dst_counts, np.int64)
    if int(src.sum()) != int(dst.sum()):
        raise ValueError(f"count mismatch: {src.sum()} != {dst.sum()}")
    if not multiprocess():
        return a
    r = _rank()
    soff, sn = int(src[:r].sum()), int(src[r])
    doff, dn = int(dst[:r].sum()), int(dst[r])
    if a.shape[0] != sn:
        raise ValueError(f"rank {r} holds {a.shape[0]} rows, counts say {sn}")
    (hs, hl), (ts, tl) = export_spans(src, dst, r)
    header = np.asarray([hs, hl, ts, tl], np.int64).tobytes()
    payload = (header + a[hs - soff: hs - soff + hl].tobytes()
               + a[ts - soff: ts - soff + tl].tobytes())
    blobs = allgather_bytes(payload)
    trail = a.shape[1:]
    rowbytes = int(a.dtype.itemsize * int(np.prod(trail, dtype=np.int64)))
    out = np.empty((dn,) + trail, a.dtype)
    ov_lo, ov_hi = max(soff, doff), min(soff + sn, doff + dn)
    if ov_hi > ov_lo:
        out[ov_lo - doff: ov_hi - doff] = a[ov_lo - soff: ov_hi - soff]
    covered = max(ov_hi - ov_lo, 0)
    for blob in blobs:
        ghs, ghl, gts, gtl = np.frombuffer(blob[:32], np.int64)
        off = 32
        for gstart, glen in ((int(ghs), int(ghl)), (int(gts), int(gtl))):
            span = blob[off: off + glen * rowbytes]
            off += glen * rowbytes
            lo, hi = max(gstart, doff), min(gstart + glen, doff + dn)
            if hi > lo:
                rows = np.frombuffer(span, a.dtype).reshape((glen,) + trail)
                out[lo - doff: hi - doff] = rows[lo - gstart: hi - gstart]
                covered += hi - lo
    if covered != dn:
        raise RuntimeError(
            f"rank {r}: canonical exchange covered {covered}/{dn} rows")
    return out


def to_canonical(local: np.ndarray, npad: int,
                 counts: Optional[np.ndarray] = None, fill=0) -> np.ndarray:
    """This rank's canonical slice (npad // nproc rows) of the global padded
    layout [all real rows in ingest order | tail pad]. One rank: the local
    rows padded to npad — the exact layout a one-device fit builds, which
    is what makes the pod blocked fold bit-identical to it."""
    a = np.ascontiguousarray(local)
    if not multiprocess():
        pad = npad - a.shape[0]
        if pad:
            a = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
        return a
    if counts is None:
        counts = row_counts(a.shape[0])
    out = exchange_rows(a, counts, canonical_counts(counts, npad))
    shard = npad // len(counts)
    pad = shard - out.shape[0]
    if pad:
        out = np.concatenate(
            [out, np.full((pad,) + out.shape[1:], fill, out.dtype)])
    return out


def from_canonical(local_padded: np.ndarray, npad: int,
                   counts: np.ndarray) -> np.ndarray:
    """Inverse of `to_canonical`: this rank's INGEST rows recovered from its
    canonical-layout slice (metric read-back — training margins, OOB sums —
    must pair with the local frame's response rows)."""
    counts = np.asarray(counts, np.int64)
    if not multiprocess():
        return np.ascontiguousarray(local_padded[: int(counts.sum())])
    canon = canonical_counts(counts, npad)
    return exchange_rows(
        np.ascontiguousarray(local_padded[: int(canon[_rank()])]), canon,
        counts)


def local_shard(garr) -> np.ndarray:
    """This rank's rows of a row-sharded array: the port's tensors already
    hold only them (the identity, on the host)."""
    return to_local(garr)


def to_local(a) -> np.ndarray:
    """Host view of `a` — the one rule for bringing possibly-sharded
    values to the host in metric and scoring code."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
