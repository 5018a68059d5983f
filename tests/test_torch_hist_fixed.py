"""B1's fixed-point rule on the CPU: `hist_cuda.hist_plain_fixed`, the exact
twin in plain PyTorch of the CUDA kernel (which `test_torch_cuda.py` holds
to it bit for bit on the card), against the reference's `segment` oracle
and an f64 sum, and at the scale rule's edges."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from h2o3_tpu.ops import histogram as ref_hist
from h2o3_tpu.ops import packing as ref_packing
from h2o3_tpu_torch.ops import hist_cuda, histogram, packing

B = 21


def _inputs(seed, N, F, L, w_one=0.9):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B, (N, F)).astype(np.uint8)
    node = rng.integers(0, L, N).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    w = (rng.random(N) < w_one).astype(np.float32)
    return codes, node, g, h, w


def _fixed(codes_nf, node, vals, L):
    """hist_plain_fixed on (N, F) numpy codes."""
    return hist_cuda.hist_plain_fixed(
        torch.from_numpy(np.ascontiguousarray(codes_nf.T)),
        torch.from_numpy(node), torch.from_numpy(vals), L, B)


def _f64(codes_nf, node, vals, L):
    N, F = codes_nf.shape
    out = np.zeros((F, L * B, 3))
    for f in range(F):
        np.add.at(out[f], node.astype(np.int64) * B + codes_nf[:, f], vals.T)
    return out.reshape(F, L, B, 3).transpose(1, 0, 2, 3)


@pytest.mark.parametrize("pack_bits", [0, 5])
@pytest.mark.parametrize("L", [1, 4, 16])
def test_fixed_matches_segment(pack_bits, L):
    """The reference's `segment` histogram (f32) and the fixed-point twin on
    the same (packed) codes; quantization to 2^-(s+1) per row and f32
    rounding, so rtol 1e-5 / atol 1e-5 of the largest entry."""
    codes, node, g, h, w = _inputs(100 + L + pack_bits, 4096, 7, L)
    c = ref_packing.pack_host(codes, pack_bits) if pack_bits else codes
    ref = np.asarray(ref_hist.build_histograms(
        jnp.asarray(c), jnp.asarray(node), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(w), L, B, method="segment", pack_bits=pack_bits))
    cfm = histogram.feature_major(torch.from_numpy(
        packing.pack_host(codes, pack_bits) if pack_bits else codes), pack_bits)
    vals = torch.from_numpy(np.stack([w, g * w, h * w]))
    got = hist_cuda.hist_plain_fixed(cfm, torch.from_numpy(node), vals, L, B)
    assert got.shape == (L, 7, B, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("L,sibling", [(1, False), (1, True), (4, True),
                                       (256, True)])
def test_fixed_no_farther_from_f64_than_f32(L, sibling):
    """At 200k rows (bins of ~10^4 rows, and of ~20 at L = 256) the
    fixed-point sums lie no farther from an f64 sum of the same inputs than
    `hist_plain`'s f32 sums do, in each channel: the signed g·w one, the
    all-positive h·w one, and the weights (exact in both)."""
    codes, node, g, h, w = _inputs(7 + L, 200_000, 4, L,
                                   0.5 if sibling else 1.0)
    vals = np.stack([w, g * w, h * w])
    f64 = _f64(codes, node, vals, L)
    fixed = _fixed(codes, node, vals, L).numpy()
    plain = hist_cuda.hist_plain(
        torch.from_numpy(np.ascontiguousarray(codes.T)), torch.from_numpy(node),
        torch.from_numpy(vals), L, B).numpy()
    err_fixed = np.abs(fixed - f64).reshape(-1, 3).max(axis=0)
    err_plain = np.abs(plain - f64).reshape(-1, 3).max(axis=0)
    assert err_fixed[0] == err_plain[0] == 0
    assert (err_fixed <= err_plain).all(), (err_fixed, err_plain)


def test_fixed_is_order_free():
    """A permutation of the rows leaves every bit of the output as it was
    (integer sums); f32 sums differ in their last bits."""
    codes, node, g, h, w = _inputs(3, 50_000, 5, 4)
    vals = np.stack([w, g * w, h * w])
    perm = np.random.default_rng(0).permutation(len(node))
    a = _fixed(codes, node, vals, 4)
    b = _fixed(codes[perm], node[perm], vals[:, perm], 4)
    assert torch.equal(a, b)


def test_fixed_counts_are_exact():
    """0/1 weights give the exact count of rows per (node, feature, bin)."""
    codes, node, g, h, w = _inputs(4, 30_000, 3, 8, 0.7)
    got = _fixed(codes, node, np.stack([w, g * w, h * w]), 8).numpy()
    for f in range(3):
        cnt = np.bincount(node.astype(np.int64) * B + codes[:, f],
                          weights=w, minlength=8 * B).reshape(8, B)
        assert np.array_equal(got[:, f, :, 0], cnt)


def test_fixed_shift_rule():
    """s_c = fix_top(N) - floor(log2 max|v_c|): 0 for zeros, None (NaN out)
    for a NaN or an inf, exact at powers of two, and the tiny and denormal
    maxima take the same rule; T = FIX_TOP up to 2^26 rows, then one less
    per doubling."""
    def shifts(*cols):
        return hist_cuda.fixed_shifts(torch.tensor(cols, dtype=torch.float32))
    top = hist_cuda.FIX_TOP
    assert shifts([0.0, 0.0], [-0.0, 0.0], [0.0, 0.0]) == [0, 0, 0]
    assert shifts([4.0, 1.0], [-3.99, 0.5], [1e-30, 0.0]) == [
        top - 2, top - 1, top + 100]
    assert shifts([1e-40, 0.0], [np.nan, 1.0], [1.0, np.inf]) == [
        top + 133, None, None]
    assert hist_cuda.fixed_shifts(torch.zeros((3, 0))) == [0, 0, 0]
    assert [hist_cuda.fix_top(n) for n in (0, 1, 2, 2 ** 26, 2 ** 26 + 1,
                                           2 ** 27, 2 ** 31 - 1)] == [
        top, top, top, top, top - 1, top - 1, top - 5]


def test_fixed_extremes():
    """All-zero values give zeros; a maximum of exactly 2^k and dyadic
    values sum exactly; a tiny maximum keeps its relative precision; a NaN
    or an inf makes its channel NaN and leaves the others as they were."""
    codes, node, g, h, w = _inputs(5, 20_000, 3, 2)
    zero = np.zeros((3, 20_000), np.float32)
    assert torch.equal(_fixed(codes, node, zero, 2), torch.zeros((2, 3, B, 3)))

    rng = np.random.default_rng(6)
    dyadic = (rng.integers(-16, 17, (3, 20_000)) / 4).astype(np.float32)
    dyadic[1, 7] = 4.0                           # the maximum, exactly 2^2
    got = _fixed(codes, node, dyadic, 2).numpy()
    assert np.array_equal(got, _f64(codes, node, dyadic, 2).astype(np.float32))

    tiny = np.stack([w, g * w * 1e-30, h * w]).astype(np.float32)
    got = _fixed(codes, node, tiny, 2).numpy()
    ref = _f64(codes, node, tiny, 2)
    assert np.abs(got[..., 1]).max() > 0
    np.testing.assert_allclose(got[..., 1], ref[..., 1], rtol=1e-5,
                               atol=1e-5 * np.abs(ref[..., 1]).max())

    vals = np.stack([w, g * w, h * w])
    clean = _fixed(codes, node, vals, 2).numpy()
    for c, bad in ((1, np.nan), (2, np.inf), (1, -np.inf)):
        broken = vals.copy()
        broken[c, 11] = bad
        got = _fixed(codes, node, broken, 2).numpy()
        assert np.isnan(got[..., c]).all()
        others = [k for k in range(3) if k != c]
        assert np.array_equal(got[..., others], clean[..., others])


def test_fixed_block_at_the_maximum_does_not_overflow():
    """The bounds the kernel rests on: a value at the top of its binade
    quantizes to nearly 2^(FIX_TOP + 1), and R_MAX of them in one bin keep
    both int32 halves (hi = q >> LO_BITS, lo = q mod 2^LO_BITS) within 2^30;
    N of them keep the int64 sum within 2^62 at every N. The twin returns
    their exact sum rounded to f32 once."""
    R, lo_bits = hist_cuda.R_MAX, hist_cuda.LO_BITS
    m = np.float32(1 - 2 ** -24)                  # the top of [1/2, 1)
    s = hist_cuda.fixed_shifts(torch.tensor([[m], [m], [m]]))[0]
    q = round(float(m) * 2.0 ** s)
    assert q < 2 ** (hist_cuda.FIX_TOP + 1) and q == float(m) * 2.0 ** s
    for v in (q, -q, 2 ** (hist_cuda.FIX_TOP + 1), -2 ** (hist_cuda.FIX_TOP + 1)):
        hi, lo = v >> lo_bits, v & ((1 << lo_bits) - 1)
        assert hi * 2 ** lo_bits + lo == v and 0 <= lo
        assert R * abs(hi) <= 2 ** 30 and R * lo < 2 ** 30
    for n in (1, 10 ** 6, 2 ** 26, 2 ** 26 + 1, 2 ** 31 - 1):
        assert n * 2 ** (hist_cuda.fix_top(n) + 1) <= 2 ** 62
    codes = np.zeros((R, 2), np.uint8)
    node = np.zeros(R, np.int32)
    vals = np.full((3, R), m, np.float32)
    vals[2] = -m
    got = _fixed(codes, node, vals, 1).numpy()
    want = np.float32(R * float(m))
    assert np.array_equal(got[0, :, 0], np.full((2, 3), [want, want, -want],
                                                np.float32))
