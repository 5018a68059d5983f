"""Per-(node, feature, bin) gradient histograms — the hot loop of the tree
engine. Port of `h2o3_tpu/ops/histogram.py::build_histograms`.

Methods keep the reference's names:

* ``segment`` — one `index_add_` per feature (`hist_cuda.hist_plain`), the
  sequential f32 fold of the reference's `_hist_segment`. The CPU default,
  and the parity oracle.
* ``pallas_factored`` — the reference's TPU default (`hist_pallas.py`
  B1). Here it is the hand-written CUDA kernel of `csrc/hist.cu` on
  feature-major codes, launched through `hist_cuda.hist_build`. The
  ``auto`` default on ``cuda``.
* ``pallas`` — `hist_pallas.py` B2, asked for by name
  (``hist_method="pallas"``). Here it is the row-major CUDA kernel of
  `csrc/hist.cu`, launched through `hist_cuda.hist_build_rows`; on the CPU
  its plain twin `hist_cuda.hist_plain_rows`.

``onehot`` and ``host`` (ROADMAP queue A, item 3) are not ported yet and
raise. Both kernels take uint8 codes (up to 256 bins) and int16 codes (up
to 1024 bins, the fit's 16-bit codes), and every level width (B1 splits
the nodes into slices where one feature's (L, B, 3) histogram outgrows
shared memory, B2 buckets the rows by node and keeps small groups of
nodes in shared memory), so nothing gives way to ``segment`` on the card. B1 sums in fixed point, so
its histograms are the same bits from run to run and equal
`hist_cuda.hist_plain_fixed`; against ``segment``'s f32 sums they agree
within rtol 1e-5. B2 sums in f32.

Every call counts its resolved method in `DISPATCH`, the stand-in for the
reference's `_record_selection` registry counters.

``n_shard_blocks`` (the blocked reduction: S equal contiguous row blocks,
each one kernel pass, their partials folded in block order by
`ordered_axis_fold`) is the in-core half of the out-of-core contract: the
blocks lane (``H2O3_TREE_SHARD=1``) sets it, and the streamed step
(`models/tree_stream.py`) runs the same per-block passes through
`run_block_kernel` on blocks it uploads one at a time, so the two fold the
same partials and agree bit for bit. B1's fixed-point scale is set per
pass from that pass's rows (`hist_cuda.fixed_shifts`), so a block's
partial carries its own rounding: a blocked fit equals a blocked fit of
the same S, not the unblocked one.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from ..parallel import mesh
from . import hist_cuda, packing

# resolved histogram method -> dispatches
DISPATCH: Counter = Counter()

_NOT_PORTED = {
    "onehot": "ROADMAP queue A, item 3 (the XLA one-hot matmul path)",
    "host": "ROADMAP queue A, item 3 (host-side accumulate)",
}


def resolve_method(method: str, device: torch.device) -> str:
    """The ONE auto-dispatch rule: the histogram method a pass runs."""
    if method == "auto":
        method = "pallas_factored" if device.type == "cuda" else "segment"
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"histogram method {method!r} is not ported: {_NOT_PORTED[method]}")
    if method not in ("segment", "pallas_factored", "pallas"):
        raise ValueError(f"unknown histogram method {method!r}")
    return method


def feature_major(codes: torch.Tensor, pack_bits: int = 0) -> torch.Tensor:
    """(F, N) contiguous codes from the (packed) (N, F) matrix — the
    widened transient `segment` and `pallas_factored` read: uint8, or int16
    past 256 bins (`packing.device_codes`), which pass through as they are."""
    if pack_bits:
        codes = packing.unpack_device(codes, pack_bits)
    return codes.t().contiguous()


def row_major(codes: torch.Tensor, pack_bits: int = 0) -> torch.Tensor:
    """(N, F) contiguous codes from the (packed) (N, F) matrix — the
    widened transient `pallas` (B2) reads; uint8 or int16 as
    `feature_major`'s."""
    if pack_bits:
        codes = packing.unpack_device(codes, pack_bits)
    return codes.contiguous()


def widen(codes: torch.Tensor, pack_bits: int, method: str) -> torch.Tensor:
    """The widened codes in the layout `method`'s kernel reads.
    `tree.build_tree` calls this once per tree and hands it to every
    level's pass. Packed words unpack to uint8; unpacked uint8 and int16
    codes keep their type."""
    if method == "pallas":
        return row_major(codes, pack_bits)
    return feature_major(codes, pack_bits)


def ordered_axis_fold(parts: torch.Tensor,
                      axis_name: Optional[str] = None) -> torch.Tensor:
    """Sum of per-block partials folded left to right (a fixed order).
    With `axis_name` the (local_blocks, ...) stack is first gathered from
    every rank into the global block order (`mesh.gather_blocks`)."""
    if axis_name is not None:
        parts = mesh.gather_blocks(parts)
    acc = parts[0]
    for i in range(1, parts.shape[0]):
        acc = acc + parts[i]
    return acc


def _run_kernel(method: str, codes_w, node, vals, n_nodes: int, nbins: int):
    if method == "segment":
        return hist_cuda.hist_plain(codes_w, node, vals, n_nodes, nbins)
    if method == "pallas":
        return hist_cuda.hist_build_rows(codes_w, node, vals, n_nodes, nbins)
    return hist_cuda.hist_build(codes_w, node, vals, n_nodes, nbins)


def run_block_kernel(method: str, codes: torch.Tensor, node_id: torch.Tensor,
                     vals: torch.Tensor, n_nodes: int, nbins: int,
                     pack_bits: int = 0) -> torch.Tensor:
    """One resolved method over one contiguous row block: B1
    (`hist_cuda.hist_build`) or B2 (`hist_cuda.hist_build_rows`) on the
    card, `segment` or the rows plain twin on the CPU. `codes` is the
    block's own (packed) (rows, F) matrix, widened here into one contiguous
    tensor of the method's layout; `vals` is its (3, rows) {w, g·w, h·w}.
    The partial equals the same block's partial of `build_histograms` with
    ``n_shard_blocks``, which is what makes a streamed fit bit-identical to
    the in-core blocks-lane fit."""
    return _run_kernel(method, widen(codes, pack_bits, method),
                       node_id.to(torch.int32).contiguous(),
                       vals.contiguous(), n_nodes, nbins)


def build_histograms(
    codes: Optional[torch.Tensor],
    node_id: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    n_nodes: int,
    nbins: int,
    method: str = "auto",
    pack_bits: int = 0,
    n_shard_blocks: int = 0,
    codes_w: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """Histogram of {Σw, Σg·w, Σh·w} per (tree node, feature, bin), shape
    (n_nodes, F, nbins, 3). Rows with w == 0 contribute nothing.

    `codes` is the (N, F) code matrix, or with ``pack_bits`` in {4, 5, 6}
    the `ops.packing` word matrix; `codes_w` is its widened form in the
    method's layout (`widen`) when the caller already holds it.

    ``n_shard_blocks`` > 0 splits the rows into that many equal contiguous
    blocks, runs the same kernel on each and folds the partials in block
    order (`ordered_axis_fold`); with `axis_name` those are this rank's
    blocks, and the fold runs over every rank's."""
    vals = torch.stack([w, g * w, h * w]).to(torch.float32)   # (3, N)
    method = resolve_method(method, vals.device)
    DISPATCH[method] += 1
    if codes_w is None:
        codes_w = widen(codes, pack_bits, method)
    node = node_id.to(torch.int32).contiguous()
    if n_shard_blocks > 0:
        n = node.shape[0]
        if n % n_shard_blocks:
            raise ValueError(
                f"{n} rows do not divide into {n_shard_blocks} shard blocks")
        rows = n // n_shard_blocks

        def block(b):
            r = slice(b * rows, (b + 1) * rows)
            return codes_w[r] if method == "pallas" else codes_w[:, r].contiguous()

        parts = [_run_kernel(method, block(b), node[b * rows:(b + 1) * rows],
                             vals[:, b * rows:(b + 1) * rows].contiguous(),
                             n_nodes, nbins)
                 for b in range(n_shard_blocks)]
        return ordered_axis_fold(torch.stack(parts), axis_name)
    if axis_name is not None:
        raise ValueError("a pod histogram needs n_shard_blocks > 0")
    return _run_kernel(method, codes_w, node, vals, n_nodes, nbins)
