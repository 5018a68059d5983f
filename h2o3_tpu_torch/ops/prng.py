"""Threefry-2x32 random draws, bit-equal to the reference's `jax.random`.

The reference samples rows, columns and per-split features with
`jax.random` (threefry2x32 in its *partitionable* form): `PRNGKey`,
`fold_in`, `split` and `uniform`. This module computes the same bits in
PyTorch, so a forest trained here is the reference's forest:

* a key is a pair of uint32 words, held as a tuple of two Python ints. Key
  derivation (`PRNGKey`, `fold_in`, `split`) runs on the host: it is a
  handful of hashes, and a device round trip would cost more than it does;
* `uniform` hashes a 64-bit counter per element — its flat index, split
  into (high, low) words — and runs on the tensor's device in int64
  arithmetic masked to 32 bits, so the draws stay where they are used.
  Element i depends only on i, not on the shape's size: the first n draws
  of a longer vector are the draws of a vector of n. So `random_bits`,
  `uniform` and `bernoulli` take a counter `offset`: the draw of `shape`
  at offset o is the slice [o, o + prod(shape)) of the flat draw of any
  longer shape. A rank of a multi-process fit draws only its own rows of
  the global (npad, …) draw this way (offset row_start · K for a 2-D
  draw of K columns).

Layout as in `jax/_src/prng.py` (jax 0.9.0, `jax_threefry_partitionable`):
`split(key, n)[i] = threefry(key, (0, i))`; `fold_in(key, d) =
threefry(key, (0, d))`; `random_bits(key, shape)[i] = x0 ^ x1` of
`threefry(key, (i >> 32, i & 0xFFFFFFFF))`; `uniform` keeps the top 23
bits as the mantissa of a float in [1, 2) and subtracts 1; `bernoulli`
compares a uniform draw with p; `permutation` sorts by random bits, as
`jax.random.permutation` does.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import torch

Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under key (k0, k1). Words are Python ints or int64 tensors holding
    uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:  # noqa: N802 — the reference's name
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2^31)."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed must be in [0, 2^31), got {seed}")
    return (0, seed)


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)` for data in [0, 2^32)."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def split(key: Key, num: int = 2) -> List[Key]:
    """`jax.random.split(key, num)`, as a list of keys."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def random_bits(key: Key, shape: Sequence[int],
                device: Union[str, torch.device] = "cpu",
                offset: int = 0) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), `shape`, from
    flat counter `offset` on."""
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    return (x0 ^ x1).reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int],
            device: Union[str, torch.device] = "cpu",
            minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`: float32 in
    [minval, maxval). The bounds are rounded to f32, and the [0, 1) floats
    become `max(minval, floats * (maxval − minval) + minval)`. XLA on the
    CPU contracts that multiply-add into one FMA, a single rounding; here
    it is computed in f64, where the product and the sum are exact (at
    most 47 significant bits), and rounded once to f32, the same bits on
    every device. `offset` as `random_bits`'."""
    bits = random_bits(key, shape, device, offset)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    fma = (floats.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, fma)


def bernoulli(key: Key, p: float, shape: Sequence[int],
              device: Union[str, torch.device] = "cpu",
              offset: int = 0) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` for a Python float `p` (mode
    "low"): with 64-bit mode off `p` is an f32, so the draw is
    `uniform(key, shape) < f32(p)`. `offset` as `random_bits`'."""
    return uniform(key, shape, device, offset=offset) < torch.tensor(
        p, dtype=torch.float32, device=device)


def permutation(key: Key, n: int,
                device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """`jax.random.permutation(key, n)`: a shuffle of arange(n) (int64), by
    jax's `_shuffle`: ceil(3·ln n / ln(2^32 − 1)) rounds (one up to n =
    1625, two above), each drawing fresh 32-bit sort keys for the current
    order from `split(key)`'s second key and sorting stably by them."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device), stable=True)[1]
        x = x[order]
    return x
