"""`ops.prng` against `jax.random` (threefry2x32, partitionable layout): the
keys of the fit loop's chain and the uniform draws of every shape the tree
path asks for must be bit-equal, since a row or column sample that differs
in one bit can change a forest."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jprng

from h2o3_tpu_torch.ops import prng


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 42, 1234, 2 ** 31 - 1])
def test_key_chain_matches_jax(seed):
    """PRNGKey → fold_in(m) → fold_in(0) → split(3) → fold_in(k): the
    fit loop's per-tree chain (reference `shared_tree.py:702-725`, `:777`)."""
    k, p = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _key(k) == p
    for m in (0, 1, 49, 2 ** 32 - 1):
        km, pm = jax.random.fold_in(k, m), prng.fold_in(p, m)
        assert _key(km) == pm
        ks = jax.random.split(jax.random.fold_in(km, 0), 3)
        ps = prng.split(prng.fold_in(pm, 0), 3)
        assert [_key(x) for x in ks] == ps
        assert _key(jax.random.fold_in(ks[2], 0)) == prng.fold_in(ps[2], 0)
    # the per-level `key, sub = split(key)` of build_tree
    assert [_key(x) for x in jax.random.split(k)] == prng.split(p)


@pytest.mark.parametrize("shape", [(2000,), (1_000_007,), (28,), (6,),
                                   (16, 28), (2048, 28), (4097, 28), (65, 9)])
def test_uniform_bit_equal(shape):
    """(npad,) row masks, (F,) column masks, (L, F) and (CAP+1, F) keep
    masks."""
    k = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    ref = np.asarray(jax.random.uniform(k, shape))
    got = prng.uniform(_key(k), shape).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_uniform_is_prefix_stable():
    """A draw depends on its flat index only: the first n of a longer vector
    are the draws of n (why the port's padding need not match the
    reference's bucketed row count)."""
    key = prng.PRNGKey(11)
    assert np.array_equal(prng.uniform(key, (1000,))[:800].numpy(),
                          prng.uniform(key, (800,)).numpy())


def test_random_bits_and_hash_match_jax():
    k = jax.random.PRNGKey(5)
    ref = np.asarray(jax.random.bits(k, (3, 5)))
    got = prng.random_bits(_key(k), (3, 5)).numpy().astype(np.uint32)
    assert np.array_equal(ref, got)
    x0 = np.arange(10, dtype=np.uint32)
    x1 = x0 * np.uint32(2654435761)
    r0, r1 = jprng.threefry2x32_p.bind(np.uint32(3), np.uint32(9), x0, x1)
    g0, g1 = prng.threefry2x32(3, 9, torch.from_numpy(x0.astype(np.int64)),
                               torch.from_numpy(x1.astype(np.int64)))
    assert np.array_equal(np.asarray(r0), g0.numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(r1), g1.numpy().astype(np.uint32))


def test_f32_rate_comparison_matches_reference():
    """`uniform < rate` with the rate rounded to f32 first, as the
    reference's f32 hyperparameter vector holds it."""
    k = jax.random.PRNGKey(3)
    rate = 5 / 28
    ref = np.asarray(jax.random.uniform(k, (4097, 28)) < jnp.float32(rate))
    got = (prng.uniform(_key(k), (4097, 28))
           < torch.tensor(np.float32(rate))).numpy()
    assert np.array_equal(ref, got)
    with pytest.raises(ValueError):
        prng.PRNGKey(-1)


@pytest.mark.parametrize("fan_in,out_dim", [(8, 32), (32, 64), (717, 200),
                                            (200, 400), (6, 3)])
def test_uniform_bounds_bit_equal(fan_in, out_dim):
    """DeepLearning's initial weights: `uniform(key, (fan_in, out_dim),
    float32, -limit, limit)` with the f32 limit sqrt(6 / (fan_in +
    out_dim)) (reference `deeplearning.py:67-80`); XLA's CPU fuses the
    scale and shift into one FMA, which `prng.uniform` rounds alike."""
    k = jax.random.fold_in(jax.random.PRNGKey(fan_in), out_dim)
    limit = jnp.sqrt(6.0 / (fan_in + out_dim))
    ref = np.asarray(jax.random.uniform(k, (fan_in, out_dim), jnp.float32,
                                        -limit, limit))
    lim = float(np.sqrt(np.float32(6.0 / (fan_in + out_dim))))
    got = prng.uniform(_key(k), (fan_in, out_dim), minval=-lim,
                       maxval=lim).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("p", [0.5, 1 - 0.1, 1 - 0.2, 1 - 0.3])
def test_bernoulli_bit_equal(p):
    """Dropout's keep masks, `bernoulli(key, 1 - ratio, shape)`: a Python
    float p is an f32 under 64-bit mode off (the reference's dtype), so the
    draw is `uniform < f32(p)`."""
    k = jax.random.fold_in(jax.random.PRNGKey(17), int(p * 100))
    assert jnp.asarray(p).dtype == jnp.float32
    for shape in ((128, 6), (32, 717), (64, 33)):
        ref = np.asarray(jax.random.bernoulli(k, p, shape))
        got = prng.bernoulli(_key(k), p, shape).numpy()
        assert np.array_equal(ref, got)


@pytest.mark.parametrize("n", [1, 600, 1625, 1626, 2000, 60000])
def test_permutation_bit_equal(n):
    """A DeepLearning chunk's row order, `permutation(key, n)`: one sort
    round up to n = 1625, two above (jax's `_shuffle`), each a stable sort
    by fresh 32-bit keys."""
    k = jax.random.fold_in(jax.random.PRNGKey(23), n)
    ref = np.asarray(jax.random.permutation(k, n))
    got = prng.permutation(_key(k), n).numpy()
    assert np.array_equal(ref, got)
