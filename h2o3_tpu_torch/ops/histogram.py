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
raise. Both kernels take every level width (B1 splits the nodes into
slices where one feature's (L, B, 3) histogram outgrows shared memory, B2
buckets the rows by node and keeps small groups of nodes in shared memory),
so nothing gives way to ``segment`` on the card. B1 sums in fixed point, so
its histograms are the same bits from run to run and equal
`hist_cuda.hist_plain_fixed`; against ``segment``'s f32 sums they agree
within rtol 1e-5. B2 sums in f32.

Every call counts its resolved method in `DISPATCH`, the stand-in for the
reference's `_record_selection` registry counters.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

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
    """(F, N) uint8 contiguous codes from the (packed) (N, F) matrix — the
    widened transient `segment` and `pallas_factored` read."""
    if pack_bits:
        codes = packing.unpack_device(codes, pack_bits)
    return codes.t().contiguous()


def row_major(codes: torch.Tensor, pack_bits: int = 0) -> torch.Tensor:
    """(N, F) uint8 contiguous codes from the (packed) (N, F) matrix — the
    widened transient `pallas` (B2) reads."""
    if pack_bits:
        codes = packing.unpack_device(codes, pack_bits)
    return codes.contiguous()


def widen(codes: torch.Tensor, pack_bits: int, method: str) -> torch.Tensor:
    """The widened codes in the layout `method`'s kernel reads.
    `tree.build_tree` calls this once per tree and hands it to every
    level's pass."""
    if method == "pallas":
        return row_major(codes, pack_bits)
    return feature_major(codes, pack_bits)


def ordered_axis_fold(parts: torch.Tensor) -> torch.Tensor:
    """Sum of per-block partials folded left to right (a fixed order)."""
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
) -> torch.Tensor:
    """Histogram of {Σw, Σg·w, Σh·w} per (tree node, feature, bin), shape
    (n_nodes, F, nbins, 3). Rows with w == 0 contribute nothing.

    `codes` is the (N, F) code matrix, or with ``pack_bits`` in {4, 5, 6}
    the `ops.packing` word matrix; `codes_w` is its widened form in the
    method's layout (`widen`) when the caller already holds it.

    ``n_shard_blocks`` > 0 splits the rows into that many equal contiguous
    blocks, runs the same kernel on each and folds the partials in block
    order (`ordered_axis_fold`)."""
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
        return ordered_axis_fold(torch.stack(parts))
    return _run_kernel(method, codes_w, node, vals, n_nodes, nbins)
