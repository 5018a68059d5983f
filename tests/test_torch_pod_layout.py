"""The port's pod layout math and tree shard plan against the reference's,
in one process (no spawned rank):

- `canonical_counts`, `export_spans`, `exchange_rows` and
  `to_canonical`/`from_canonical` of `h2o3_tpu_torch.parallel.distdata`
  on the cases of `tests/test_pod_layout.py`: the counts and spans equal
  the reference's, and the exchange, run rank by rank with the gather
  replaced by the payloads every simulated rank produced, re-splits the
  global rows exactly as the reference's routing oracle does;
- `shared_tree._shard_plan` against the reference's for 1, 2, 4 and 8
  ranks under the default, the blocks lane, another block count and the
  escape hatches; where the reference falls back to its psum lane the
  port raises naming item 9;
- the counter offset of `ops.prng`: a rank's slice of a draw equals the
  same rows of the whole draw and of `jax.random`'s, bit for bit;
- `global_quantiles` on one rank equals `np.quantile`, and
  `global_order_stats` the reference's;
- the launcher's rendezvous from a torch launcher's environment, its
  one-rank cloud and its two hooks' raises; `device.resolve` on a rank.
"""

import numpy as np
import pytest
import torch

import jax

from h2o3_tpu.models import shared_tree as ref_st
from h2o3_tpu.parallel import distdata as ref_dd
from h2o3_tpu_torch.models import shared_tree as port_st
from h2o3_tpu_torch.ops import prng
from h2o3_tpu_torch.parallel import distdata as dd

from test_pod_layout import _simulate_resplit

COUNT_CASES = [([5, 5], 16), ([7, 3], 16), ([0, 10], 16), ([10, 0], 16),
               ([3, 3, 3, 3], 16), ([1, 2, 3, 4], 24), ([13, 1, 1, 1], 16),
               ([499_993, 500_007], 1_000_064), ([1667, 1666, 1667], 5184)]
SPLIT_CASES = [[5, 5], [7, 3], [0, 10], [16, 0], [4, 4, 4, 4], [1, 7, 2, 6],
               [13, 1, 1, 1], [0, 0, 8, 8]]


def _check_canonical_counts(counts, npad):
    got = dd.canonical_counts(np.asarray(counts), npad)
    np.testing.assert_array_equal(
        got, ref_dd.canonical_counts(np.asarray(counts), npad))
    # a grid the ranks do not divide
    with pytest.raises(ValueError):
        dd.canonical_counts(np.asarray(counts), npad + 1)


class _Ranks:
    """The port's `exchange_rows` run as each of len(src) ranks in turn:
    a first pass records every rank's payload, a second hands each rank
    all of them as the gather would."""

    def __init__(self, monkeypatch, nproc):
        self.mp, self.nproc = monkeypatch, nproc

    def run(self, fn, locals_):
        payloads = [None] * self.nproc

        class _Sent(Exception):
            pass

        self.mp.setattr(dd, "multiprocess", lambda: True)
        for r in range(self.nproc):
            self.mp.setattr(dd, "_rank", lambda r=r: r)

            def capture(p, r=r):
                payloads[r] = p
                raise _Sent

            self.mp.setattr(dd, "allgather_bytes", capture)
            with pytest.raises(_Sent):
                fn(locals_[r])
        out = []
        self.mp.setattr(dd, "allgather_bytes", lambda p: list(payloads))
        for r in range(self.nproc):
            self.mp.setattr(dd, "_rank", lambda r=r: r)
            out.append(fn(locals_[r]))
        return out


def _shards(glob, counts):
    offs = np.concatenate([[0], np.cumsum(counts)])
    return [glob[offs[r]:offs[r + 1]] for r in range(len(counts))]


def _check_exchange(monkeypatch, src):
    src = np.asarray(src, np.int64)
    npad = 16 if len(src) == 2 else 32
    dst = dd.canonical_counts(src, npad)
    for r in range(len(src)):
        assert dd.export_spans(src, dst, r) == ref_dd.export_spans(src, dst, r)
    oracle = _simulate_resplit(src, dst)
    n = int(src.sum())
    glob = np.arange(n * 3, dtype=np.float64).reshape(n, 3)
    got = _Ranks(monkeypatch, len(src)).run(
        lambda a: dd.exchange_rows(a, src, dst), _shards(glob, src))
    for r in range(len(src)):
        np.testing.assert_array_equal(got[r], glob[oracle[r]])
    # to_canonical pads each slice to npad / nproc at the global tail, and
    # from_canonical brings every rank its ingest rows back
    canon = _Ranks(monkeypatch, len(src)).run(
        lambda a: dd.to_canonical(a, npad, counts=src, fill=-1.0),
        _shards(glob, src))
    whole = np.concatenate(canon)
    assert whole.shape == (npad, 3)
    np.testing.assert_array_equal(whole[:n], glob)
    assert (whole[n:] == -1.0).all()
    back = _Ranks(monkeypatch, len(src)).run(
        lambda a: dd.from_canonical(a, npad, src), canon)
    for r, part in enumerate(_shards(glob, src)):
        np.testing.assert_array_equal(back[r], part)


def _check_one_rank_identities():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    for mod in (dd, ref_dd):
        np.testing.assert_array_equal(
            mod.exchange_rows(a, np.asarray([6]), np.asarray([6])), a)
        with pytest.raises(ValueError):
            mod.exchange_rows(a, np.asarray([6]), np.asarray([5]))
    v = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(dd.to_canonical(v, 16, fill=-1),
                                  ref_dd.to_canonical(v, 16, fill=-1))
    c = dd.to_canonical(v, 16, fill=-1)
    np.testing.assert_array_equal(dd.from_canonical(c, 16, np.asarray([10])),
                                  ref_dd.from_canonical(c, 16,
                                                        np.asarray([10])))


# -- the shard plan ------------------------------------------------------------

PLAN_ENVS = {
    "default": {},
    "blocks": {"H2O3_TREE_SHARD": "1"},
    "blocks6": {"H2O3_TREE_SHARD": "1", "H2O3_TREE_SHARD_BLOCKS": "6"},
    "shard0": {"H2O3_TREE_SHARD": "0"},
    "legacy": {"H2O3_TREE_LEGACY": "1"},
    "lossguide": {"grow_policy": "lossguide"},
}


def _check_shard_plan(monkeypatch, case, ndev):
    for k in ("H2O3_TREE_SHARD", "H2O3_TREE_SHARD_BLOCKS",
              "H2O3_TREE_LEGACY"):
        monkeypatch.delenv(k, raising=False)
    tp = {}
    for k, v in PLAN_ENVS[case].items():
        if k.startswith("H2O3_"):
            monkeypatch.setenv(k, v)
        else:
            tp[k] = v
    multiproc = ndev > 1
    want = ref_st._shard_plan(ndev, multiproc, tp)
    if want[0] == "mesh_psum":
        with pytest.raises(NotImplementedError, match="item 9"):
            port_st._shard_plan(tp, ndev, multiproc)
        return
    got = port_st._shard_plan(tp, ndev, multiproc)
    assert got == want
    if got[0] == "mesh":
        # every rank holds whole blocks, and S is shared with the blocks
        # lane of the same base count
        assert got[1] % ndev == 0


# -- draws at an offset --------------------------------------------------------

def _key(k):
    return tuple(int(v) for v in np.asarray(k))


DRAW_CASES = [((4096,), 2), ((1000,), 4), ((5184,), 3), ((96, 7), 4)]


def _check_draw_slices(shape, ranks):
    k = jax.random.fold_in(jax.random.PRNGKey(13), 5)
    whole = prng.uniform(_key(k), shape)
    ref = np.asarray(jax.random.uniform(k, shape))
    bits = prng.random_bits(_key(k), shape)
    bern = prng.bernoulli(_key(k), 0.632, shape)
    rows = shape[0] // ranks
    per_row = int(np.prod(shape[1:], dtype=np.int64))
    for r in range(ranks):
        sl = slice(r * rows, (r + 1) * rows)
        sub = (rows,) + tuple(shape[1:])
        off = r * rows * per_row
        got = prng.uniform(_key(k), sub, offset=off)
        assert torch.equal(got, whole[sl])
        assert np.array_equal(got.numpy().view(np.uint32),
                              ref[sl].view(np.uint32))
        assert torch.equal(prng.random_bits(_key(k), sub, offset=off),
                           bits[sl])
        assert torch.equal(prng.bernoulli(_key(k), 0.632, sub, offset=off),
                           bern[sl])
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(k, 0.632, shape)), bern.numpy())


def _check_one_rank_quantiles():
    rng = np.random.default_rng(3)
    for v in (rng.normal(size=5001).astype(np.float32).astype(np.float64),
              np.repeat(rng.normal(size=40), 50),
              np.full(17, 2.5)):
        qs = np.linspace(0, 1, 21)[1:-1]
        np.testing.assert_array_equal(dd.global_quantiles(v, qs),
                                      np.quantile(v, qs))


def _check_one_rank_order_stats():
    rng = np.random.default_rng(4)
    v = rng.normal(size=3001)
    ks = [0, 7, 1500, 2999, 3000]
    np.testing.assert_array_equal(dd.global_order_stats(v, ks),
                                  ref_dd.global_order_stats(v, ks))
    many = dd.global_quantiles_columns([v, v[:100], np.zeros(0)], [0.25, 0.5])
    np.testing.assert_array_equal(many[0], np.quantile(v, [0.25, 0.5]))
    np.testing.assert_array_equal(many[1], np.quantile(v[:100], [0.25, 0.5]))
    assert np.isnan(many[2]).all()


def _check_launcher(monkeypatch):
    from h2o3_tpu_torch import device as devlib
    from h2o3_tpu_torch.parallel import launcher, mesh

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "H2O3_FLEET_AGGREGATOR", "H2O3_FLEET_SELF_URL",
              "H2O3_FENCE_DEADLINE_S"):
        monkeypatch.delenv(k, raising=False)
    assert launcher._env_rendezvous() is None
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert launcher._env_rendezvous() == ("10.0.0.1:29500", 4, 2)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert launcher._env_rendezvous() is None
    assert mesh._init_method("h:1") == "tcp://h:1"
    assert mesh._init_method("file:///x/y") == "file:///x/y"
    mesh.reset()
    try:
        facts = launcher.initialize_multihost()
        assert (facts["process_count"], facts["process_index"]) == (1, 0)
        assert not mesh.must_serialize_training()
        assert mesh.gather_blocks(torch.ones(2, 3)).shape == (2, 3)
        # a one-rank cloud runs no watcher, so the deadline is no error
        monkeypatch.setenv("H2O3_FENCE_DEADLINE_S", "30")
        launcher.initialize_multihost()
        monkeypatch.setenv("H2O3_FLEET_AGGREGATOR", "http://agg:54321")
        monkeypatch.setenv("H2O3_FLEET_SELF_URL", "http://me:54321")
        with pytest.raises(NotImplementedError, match="item 11"):
            launcher.initialize_multihost()
    finally:
        mesh.reset()
    # a rank's card stands for "cuda"; without a card it still raises
    prev = devlib.rank_device()
    try:
        devlib.set_rank_device("cuda:0")
        assert devlib.resolve("cpu").type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                devlib.resolve("cuda")
    finally:
        devlib.set_rank_device(prev)


def _check_one_rank_collectives():
    """On a one-rank cloud every host collective is the identity (the
    reference's single-process answers), and the torch stand-ins for the
    reference's global arrays are this rank's rows on its device."""
    from h2o3_tpu_torch.parallel import mesh

    mesh.reset()
    try:
        a = np.arange(10, dtype=np.float32).reshape(5, 2)
        assert not dd.multiprocess()
        np.testing.assert_array_equal(dd.allgather_host(a), a[None])
        assert dd.allgather_bytes(b"xy") == [b"xy"]
        np.testing.assert_array_equal(dd.allgather_rows(a), a)
        np.testing.assert_array_equal(
            dd.allgather_rows_padded(a, 8, np.asarray([5])), a)
        np.testing.assert_array_equal(dd.global_sum(a), a)
        assert dd.row_offset(5) == 0 and list(dd.row_counts(5)) == [5]
        assert dd.global_any(True) and not dd.global_all(False)
        lo, hi = dd.global_minmax(np.asarray([1.0]), np.asarray([2.0]))
        assert (lo[0], hi[0]) == (1.0, 2.0)
        assert dd.local_quota(5) == 8
        with pytest.raises(TypeError):
            dd.allgather_rows_padded(a.astype(np.float64), 8, [5])
        from h2o3_tpu_torch import device as devlib

        prev = devlib.default_device()
        devlib.set_device("cpu")
        try:
            g = dd.global_row_array(a, 8, fill=-1)
            assert g.shape == (8, 2) and (g[5:] == -1).all()
            np.testing.assert_array_equal(dd.to_local(g)[:5], a)
            assert dd.sharded_full((8, 3), 2.0, torch.float32).shape == (8, 3)
            assert dd.replicated_array(a).shape == (5, 2)
        finally:
            devlib.set_device(prev)
    finally:
        mesh.reset()


# Two test ids in all: a new file with few ids sits at the end of xdist's
# loadfile queue (files ordered by test count), so the suite's other files
# keep the order and the workers they run in.

def test_layout_and_shard_plan_equal_the_reference():
    for counts, npad in COUNT_CASES:
        _check_canonical_counts(counts, npad)
    for src in SPLIT_CASES:
        with pytest.MonkeyPatch.context() as mp:
            _check_exchange(mp, src)
    _check_one_rank_identities()
    for case in PLAN_ENVS:
        for ndev in (1, 2, 4, 8):
            with pytest.MonkeyPatch.context() as mp:
                _check_shard_plan(mp, case, ndev)


def test_draws_quantiles_launcher_and_collectives():
    for shape, ranks in DRAW_CASES:
        _check_draw_slices(shape, ranks)
    _check_one_rank_quantiles()
    _check_one_rank_order_stats()
    with pytest.MonkeyPatch.context() as mp:
        _check_launcher(mp)
    _check_one_rank_collectives()
