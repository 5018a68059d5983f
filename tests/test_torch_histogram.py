"""Histogram parity: the port's plain path and `build_histograms` against the
reference's `segment` oracle (the f32 sequential fold), and against the
two TPU kernel bodies themselves run through `pl.pallas_call` in interpret
mode with the wrappers' BlockSpecs restated here. The CUDA kernel is held
against its plain version on the card in `test_torch_cuda.py`."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from h2o3_tpu.ops import hist_pallas as ref_pallas
from h2o3_tpu.ops import histogram as ref_hist
from h2o3_tpu.ops import packing as ref_packing
from h2o3_tpu_torch.ops import hist_cuda, histogram, packing

B = 21


def _inputs(seed, N, F, L, nbins=B):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, nbins, (N, F)).astype(np.uint8)
    node = rng.integers(0, L, N).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    h = rng.random(N).astype(np.float32)
    w = (rng.random(N) > 0.1).astype(np.float32)
    return codes, node, g, h, w


def _ref_segment(codes, node, g, h, w, L, nbins=B, pack_bits=0, blocks=0):
    c = ref_packing.pack_host(codes, pack_bits) if pack_bits else codes
    return np.asarray(ref_hist.build_histograms(
        jnp.asarray(c), jnp.asarray(node), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(w), L, nbins, method="segment", pack_bits=pack_bits,
        n_shard_blocks=blocks))


@pytest.mark.parametrize("pack_bits", [0, 5])
@pytest.mark.parametrize("blocks", [0, 4])
@pytest.mark.parametrize("L", [1, 4])
def test_build_histograms_matches_segment(pack_bits, blocks, L):
    codes, node, g, h, w = _inputs(pack_bits + 10 * L + blocks, 2048, 7, L)
    ref = _ref_segment(codes, node, g, h, w, L, pack_bits=pack_bits, blocks=blocks)
    c = packing.pack_host(codes, pack_bits) if pack_bits else codes
    got = histogram.build_histograms(
        torch.from_numpy(c), torch.from_numpy(node), torch.from_numpy(g),
        torch.from_numpy(h), torch.from_numpy(w), L, B, pack_bits=pack_bits,
        n_shard_blocks=blocks)
    assert got.shape == (L, 7, B, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("bits,nbins", [(4, 16), (6, 33)])
def test_build_histograms_packed_widths(bits, nbins):
    codes, node, g, h, w = _inputs(bits, 1024, 5, 2, nbins)
    ref = _ref_segment(codes, node, g, h, w, 2, nbins, pack_bits=bits)
    got = histogram.build_histograms(
        torch.from_numpy(packing.pack_host(codes, bits)), torch.from_numpy(node),
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(w), 2, nbins,
        pack_bits=bits)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("L", [1, 2, 8])
def test_hist_plain_and_wrapper_match_segment(L):
    """`hist_plain` on the kernel's own inputs (feature-major codes), and
    the kernel wrapper on CPU tensors (which takes the plain path)."""
    codes, node, g, h, w = _inputs(30 + L, 3000, 6, L)
    ref = _ref_segment(codes, node, g, h, w, L)
    vals = torch.from_numpy(np.stack([w, g * w, h * w]))
    cfm = torch.from_numpy(np.ascontiguousarray(codes.T))
    nd = torch.from_numpy(node)
    plain = hist_cuda.hist_plain(cfm, nd, vals, L, B)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=1e-6, atol=1e-5)
    before = hist_cuda.launches
    wrapped = hist_cuda.hist_build(cfm, nd, vals, L, B)
    assert hist_cuda.launches == before          # no launch off the card
    assert torch.equal(wrapped, plain)


def _pallas_b1(codes, node, vals, L, nbins, R):
    """B1 (`build_histograms_pallas_factored`'s kernel) in interpret mode,
    BlockSpecs as at hist_pallas.py:129-140."""
    N, F = codes.shape
    FB = ref_pallas._FB
    out = pl.pallas_call(
        functools.partial(ref_pallas._hist_kernel_factored, L=L, B=nbins),
        out_shape=jax.ShapeDtypeStruct((F // FB, 3 * L, FB * nbins), jnp.float32),
        grid=(N // R, F // FB),
        in_specs=[
            pl.BlockSpec((FB, R), lambda i, f: (f, i)),
            pl.BlockSpec((1, R), lambda i, f: (0, i)),
            pl.BlockSpec((3, R), lambda i, f: (0, i)),
        ],
        out_specs=pl.BlockSpec((1, 3 * L, FB * nbins), lambda i, f: (f, 0, 0)),
        scratch_shapes=[pltpu.VMEM((3 * L, R), jnp.float32)],
        interpret=True,
    )(jnp.asarray(codes.T.astype(np.float32)), jnp.asarray(node)[None, :],
      jnp.asarray(vals))
    out = out.reshape(F // FB, 3 * L, FB, nbins).transpose(0, 2, 1, 3)
    return np.asarray(out.reshape(F, 3, L, nbins).transpose(2, 0, 3, 1))


def _pallas_b2(codes, node, vals, L, nbins, R):
    """B2 (`build_histograms_pallas`'s kernel) in interpret mode, BlockSpecs
    as at hist_pallas.py:199-209."""
    N, F = codes.shape
    LB = L * nbins
    out = pl.pallas_call(
        functools.partial(ref_pallas._hist_kernel, F=F, LB=LB),
        out_shape=jax.ShapeDtypeStruct((F, 3, LB), jnp.float32),
        grid=(N // R,),
        in_specs=[
            pl.BlockSpec((F, R), lambda i: (0, i)),
            pl.BlockSpec((1, R), lambda i: (0, i)),
            pl.BlockSpec((3, R), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((F, 3, LB), lambda i: (0, 0, 0)),
        interpret=True,
    )(jnp.asarray(codes.astype(np.int32).T), jnp.asarray(node * nbins)[None, :],
      jnp.asarray(vals))
    return np.asarray(out.reshape(F, 3, L, nbins).transpose(2, 0, 3, 1))


@pytest.mark.parametrize("body", ["B1_factored", "B2_fused"])
@pytest.mark.parametrize("L", [1, 4])
def test_port_matches_pallas_kernel_bodies(body, L):
    """The TPU kernels round their operands to bf16, so the tolerance is
    2e-3 of the histogram's largest entry."""
    N, F, R = 2048, 16, 512
    codes, node, g, h, w = _inputs(40 + L, N, F, L)
    vals = np.stack([w, g * w, h * w]).astype(np.float32)
    tpu = (_pallas_b1 if body == "B1_factored" else _pallas_b2)(
        codes, node, vals, L, B, R)
    got = hist_cuda.hist_plain(torch.from_numpy(np.ascontiguousarray(codes.T)),
                               torch.from_numpy(node), torch.from_numpy(vals),
                               L, B).numpy()
    scale = np.abs(got).max()
    assert np.abs(got - tpu).max() <= 2e-3 * scale


def test_resolve_method_and_dispatch_counter():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert histogram.resolve_method("auto", cpu) == "segment"
    assert histogram.resolve_method("auto", cuda) == "pallas_factored"
    assert histogram.resolve_method("segment", cuda) == "segment"
    assert histogram.resolve_method("pallas", cuda) == "pallas"
    assert histogram.resolve_method("pallas", cpu) == "pallas"
    for m in ("onehot", "host"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            histogram.resolve_method(m, cuda)
    with pytest.raises(ValueError):
        histogram.resolve_method("bogus", cpu)
    codes, node, g, h, w = _inputs(5, 256, 3, 2)
    histogram.DISPATCH.clear()
    for m in ("auto", "segment", "pallas_factored", "pallas"):
        histogram.build_histograms(
            torch.from_numpy(codes), torch.from_numpy(node), torch.from_numpy(g),
            torch.from_numpy(h), torch.from_numpy(w), 2, B, method=m)
    assert histogram.DISPATCH == {"segment": 2, "pallas_factored": 1,
                                  "pallas": 1}


@pytest.mark.parametrize("L,N,fb,n_rb,slices", [
    (1, 200_000, 28, 196, 1),                  # blocks of 1024 rows
    (1, 10 ** 6, 28, 264, 1),                  # two blocks per SM
    (2, 10 ** 6, 28, 264, 1), (4, 10 ** 6, 28, 264, 1),
    (8, 10 ** 6, 14, 132, 1),                  # 28 = 14 + 14
    (16, 10 ** 6, 10, 88, 1),                  # 28 = 10 + 10 + 8
    (1024, 10 ** 6, 1, 4, 3),                  # node slices, whole window
])
def test_feats_per_block_rule(L, N, fb, n_rb, slices):
    """B1's launch plan at the GBM path's widths (F = 28, B = 21, 132
    SMs): every feature where two blocks fit an SM, else balanced feature
    blocks, else node slices; two blocks per SM, never of fewer than
    MIN_ROWS_PER_BLOCK rows; tiles that fill the shared memory left; node
    slices in one block of twice the threads per SM and the whole
    window."""
    F, nb = 28, 21
    p = hist_cuda.block_plan(L, nb, F, N)
    assert (p.feats_per_block, p.grid[0], p.grid[2]) == (fb, n_rb, slices)
    if slices == 1:
        assert p.threads == hist_cuda.THREADS
        assert p.smem <= hist_cuda.SMEM_PAIR
    else:
        assert p.threads == 2 * hist_cuda.THREADS
        assert hist_cuda.SMEM_PAIR < p.smem <= hist_cuda.SMEM_MAX
    assert p.grid[0] * p.grid[1] * p.grid[2] >= min(2 * 132, N // 1024)
    assert p.grid[0] * p.rows_per_block >= N > (p.grid[0] - 1) * p.rows_per_block
    assert p.rows_per_block % 16 == 0 and p.tile_rows % 16 == 0
    assert hist_cuda.TILE_ROWS <= p.tile_rows <= hist_cuda.R_MAX
    assert slices * p.nodes_per_block >= L > (slices - 1) * p.nodes_per_block
    assert (slices > 1) == (L * nb * 24 > hist_cuda.SMEM_PAIR)


def test_block_plan_limits(monkeypatch):
    """Wide bins, small frames, a larger shared-memory budget, tiles beyond
    R_MAX, and the one raise: one node's histogram of one feature beyond
    shared memory."""
    plan = hist_cuda.block_plan
    p = plan(1024, 256, 28, 10 ** 6)
    assert p.feats_per_block == 1 and p.smem <= hist_cuda.SMEM_MAX
    assert p.grid[2] * p.nodes_per_block >= 1024 and p.threads == 1024
    p = plan(4000, 256, 2, 5000)            # 6 KB a node: 34 fit the window
    assert p.smem <= hist_cuda.SMEM_MAX and p.nodes_per_block == 34
    assert plan(16, 21, 28, 4000).grid == (4, 3, 1)
    assert plan(1, 21, 28, 0).grid == (1, 1, 1)
    monkeypatch.setattr(hist_cuda, "SMEM_PAIR", hist_cuda.SMEM_MAX)
    assert plan(16, 21, 28, 10 ** 6).feats_per_block == 14
    monkeypatch.setattr(hist_cuda, "TILE_ROWS", 2 * hist_cuda.R_MAX)
    with pytest.raises(ValueError):
        plan(1, 21, 28, 10 ** 6)
    monkeypatch.undo()
    with pytest.raises(ValueError):
        plan(1, 20_000, 1, 10)                # one node does not fit


@pytest.mark.parametrize("L", [1, 4, 33])
def test_hist_plain_rows_and_wrapper_match_segment(L):
    """`hist_plain_rows` on the B2 kernel's own inputs (row-major codes),
    and the B2 wrapper on CPU tensors (which takes the plain path)."""
    codes, node, g, h, w = _inputs(60 + L, 3000, 6, L)
    ref = _ref_segment(codes, node, g, h, w, L)
    vals = torch.from_numpy(np.stack([w, g * w, h * w]))
    rows, nd = torch.from_numpy(codes), torch.from_numpy(node)
    plain = hist_cuda.hist_plain_rows(rows, nd, vals, L, B)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=1e-6, atol=1e-5)
    # the same index_add_ fold as the feature-major twin: the same bits
    assert torch.equal(plain, hist_cuda.hist_plain(
        torch.from_numpy(np.ascontiguousarray(codes.T)), nd, vals, L, B))
    before = hist_cuda.launches_rows
    wrapped = hist_cuda.hist_build_rows(rows, nd, vals, L, B)
    assert hist_cuda.launches_rows == before     # no launch off the card
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("L", [1, 4])
def test_hist_plain_rows_matches_b2_body(L):
    """B2's kernel body in interpret mode against its port's plain twin;
    bf16 operands in the TPU kernel, so 2e-3 of the largest entry."""
    N, F, R = 2048, 16, 512
    codes, node, g, h, w = _inputs(70 + L, N, F, L)
    vals = np.stack([w, g * w, h * w]).astype(np.float32)
    tpu = _pallas_b2(codes, node, vals, L, B, R)
    got = hist_cuda.hist_plain_rows(torch.from_numpy(codes), torch.from_numpy(node),
                                    torch.from_numpy(vals), L, B).numpy()
    assert np.abs(got - tpu).max() <= 2e-3 * np.abs(got).max()


@pytest.mark.parametrize("pack_bits", [0, 5])
@pytest.mark.parametrize("blocks", [0, 4])
def test_build_histograms_pallas_method_matches_segment(pack_bits, blocks):
    """"pallas" widens the (packed) codes row-major and, on the CPU, runs
    `hist_plain_rows`: the reference's `segment` result."""
    codes, node, g, h, w = _inputs(80 + pack_bits + blocks, 2048, 7, 8)
    ref = _ref_segment(codes, node, g, h, w, 8, pack_bits=pack_bits,
                       blocks=blocks)
    c = packing.pack_host(codes, pack_bits) if pack_bits else codes
    assert histogram.widen(torch.from_numpy(c), pack_bits, "pallas").shape == (2048, 7)
    got = histogram.build_histograms(
        torch.from_numpy(c), torch.from_numpy(node), torch.from_numpy(g),
        torch.from_numpy(h), torch.from_numpy(w), 8, B, method="pallas",
        pack_bits=pack_bits, n_shard_blocks=blocks)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("L,G", [(1, 1), (2, 2), (4, 4), (16, 8),
                                 (4097, 8), (2 ** 17, 8)])
def test_rows_plan_rule(L, G):
    """B2's launch plan at the DRF path's widths (N = 1M, F = 28, B = 21):
    groups of min(8, L) nodes with every feature, chunks of 512 rows; the
    grid's chunk slots bound every way of filling the groups; the scratch
    parts are 16-byte aligned and in order."""
    N, F, nb = 10 ** 6, 28, 21
    plan = hist_cuda.rows_plan(L, nb, F, N)
    assert (plan.group_nodes, plan.feats_per_block) == (G, F)
    assert plan.chunk_rows == hist_cuda.CHUNK_ROWS == 512
    n_groups = -(-L // G)
    assert plan.grid == (n_groups + -(-N // 512), 1)
    assert plan.smem == 4 * ((G + 4) // 4 * 4) + G * F * nb * 12
    assert plan.smem <= hist_cuda.SMEM_MAX
    tile = hist_cuda.SCAN_TILE
    assert (plan.node_tiles - 1) * tile < L + 1 <= plan.node_tiles * tile
    assert ((plan.group_tiles - 1) * tile < n_groups + 1
            <= plan.group_tiles * tile)
    sizes = (4 * tile * plan.node_tiles, 4 * tile * plan.group_tiles,
             4 * plan.grid[0], 4 * N, 16 * N)
    assert plan.scratch[0] == 0
    ends = plan.scratch[1:] + (plan.scratch_bytes,)
    for at, end, size in zip(plan.scratch, ends, sizes):
        assert at % 16 == 0 and end - at >= size
    # chunks needed by any node law: uniform, geometric, all in one node
    rng = np.random.default_rng(L)
    for per_node in (np.bincount(rng.integers(0, L, N), minlength=L),
                     np.bincount(np.minimum(rng.geometric(0.01, N), L) - 1,
                                 minlength=L),
                     np.eye(1, L, L // 2, dtype=np.int64)[0] * N):
        per_group = np.add.reduceat(per_node, np.arange(0, L, G))
        chunks = np.maximum(1, -(-per_group // plan.chunk_rows))
        assert chunks.sum() <= plan.grid[0]


def test_rows_plan_limits(monkeypatch):
    """Other sizes, groups cut to what fits, a node that does not fit with
    all its features, and the one raise: one node's histogram of one
    feature beyond shared memory."""
    plan = hist_cuda.rows_plan
    monkeypatch.setattr(hist_cuda, "GROUP_NODES", 64)
    assert plan(2 ** 17, 21, 28, 10 ** 6).group_nodes == 32
    assert plan(5, 21, 28, 10 ** 6).group_nodes == 5
    monkeypatch.setattr(hist_cuda, "GROUP_NODES", 4)
    monkeypatch.setattr(hist_cuda, "CHUNK_ROWS", 2048)
    p = plan(100, 21, 28, 10 ** 6)
    assert (p.group_nodes, p.chunk_rows, p.grid) == (4, 2048, (25 + 489, 1))
    monkeypatch.undo()
    assert plan(64, 256, 28, 10 ** 6).group_nodes == 2     # 86 KB per node
    p = plan(4, 256, 1000, 5000)            # 3 MB per node: features split
    assert (p.group_nodes, p.feats_per_block) == (1, 75)
    assert p.grid == (4 + 10, 14) and p.smem <= hist_cuda.SMEM_MAX
    assert plan(1, 21, 28, 0).grid == (1, 1)
    with pytest.raises(ValueError):
        plan(1, 20_000, 1, 10)              # one node does not fit
