"""Weighted quantiles by iterative histogram refinement, on one device.

Port of `h2o3_tpu/ops/quantiles.py::distributed_quantiles` (reference
parity: `hex/quantile/Quantile.java`: a fixed-width value histogram over
[min, max], the bin holding the target weight found from the cumulative
counts, then the same inside that bin, so k rounds resolve the range to
1/nbins^k). Everything runs in f32 on the tensors' device, as the
reference does.

What is the reference's arithmetic, kept here:

* `span = max(hi − lo, 1e-300)`: the Python float is a weak type beside
  f32 and rounds to 0, so a constant column (or a bracket finer than the
  f32 spacing) has span 0 and `(x − lo) / span` is NaN or ±inf. XLA casts
  NaN to 0 and saturates the infinities before the clip; torch's cast of
  NaN is not defined the same way on every device, so the bins are
  clamped in f32 with NaN sent to 0 first. The quantile of a constant
  column is then the constant.
* `new_lo = lo + k·span` is rounded once (`fma_f32`): XLA on the CPU
  contracts it into a fused multiply-add.
* `argmax(cum >= target)` is 0 where no bin reaches the target.

With unit weights every count is an exact integer, so the card and the
CPU give the same bits. The cross-device collectives of the reference's
`axis_name` (psum/pmin/pmax over row shards) are ROADMAP queue A, item 9.
"""

from __future__ import annotations

from typing import Sequence

import torch

_ITEM9 = "ROADMAP queue A, item 9 (multi-device lanes)"
_BIG = 3.4e38


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a + b·c for f32 tensors, rounded once to f32, as a fused
    multiply-add rounds it. The product is exact in f64 (24-bit
    significands); the f64 sum is rounded once more to f32, which differs
    from one rounding only where the f64 sum lands exactly halfway between
    two f32 values: there the sum's exact remainder (TwoSum) picks the
    side."""
    a64, p64 = a.double(), b.double() * c.double()
    s = a64 + p64
    bb = s - a64
    err = (a64 - (s - bb)) + (p64 - bb)             # s + err == a + b·c
    r = s.float()
    back = r.double()
    toward = torch.where(s > back, torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    nb = torch.nextafter(r, toward)
    mid = (back + nb.double()) * 0.5
    lean = torch.where(s > back, err > 0, err < 0)
    return torch.where((s == mid) & lean, nb, r)


def distributed_quantiles(x: torch.Tensor, w: torch.Tensor,
                          probs: Sequence[float], nbins: int = 1024,
                          iters: int = 3, process_group=None) -> torch.Tensor:
    """Weighted quantiles of `x` (N,) f32 (NaN = NA, ignored) under the
    weights `w` (N,) f32 (0 masks a row): a (len(probs),) f32 tensor on
    x's device. Accuracy: range / nbins^iters per quantile."""
    if process_group is not None:
        raise NotImplementedError(
            f"distributed_quantiles over a process group is not ported "
            f"({_ITEM9}); pass the rows of one device")
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    dev = x.device
    valid = ~torch.isnan(x) & (w > 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    xz = torch.where(valid, x, zero)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    gmin = torch.where(valid, x, big).min()
    gmax = torch.where(valid, x, -big).max()
    wv = torch.where(valid, w, zero)
    wtot = wv.sum()
    nb = torch.tensor(float(nbins), dtype=torch.float32, device=dev)

    def hist(lo, hi):
        span = torch.clamp(hi - lo, min=0.0)
        t = (xz - lo) / span * nb
        b = torch.clamp(torch.nan_to_num(t, nan=0.0), 0.0, nbins - 1).to(
            torch.int64)
        inside = valid & (xz >= lo) & (xz <= hi)
        h = torch.zeros(nbins, dtype=torch.float32, device=dev).index_add_(
            0, b, torch.where(inside, w, zero))
        below = torch.where(valid & (xz < lo), w, zero).sum()
        return h, below

    out = []
    for p in probs:
        target = torch.tensor(float(p), dtype=torch.float32, device=dev) * wtot
        lo, hi = gmin, gmax
        for _ in range(iters):
            h, below = hist(lo, hi)
            cum = torch.cumsum(h, 0) + below
            # first bin whose cumulative weight reaches the target (0 if none)
            k = (cum >= target).to(torch.int32).argmax()
            span = torch.clamp(hi - lo, min=0.0) / nb
            new_lo = fma_f32(lo, k.to(torch.float32), span)
            hi = new_lo + span
            lo = new_lo
        out.append((lo + hi) * 0.5)
    return torch.stack(out)
