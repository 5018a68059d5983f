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
  of a longer vector are the draws of a vector of n.

Layout as in `jax/_src/prng.py` (jax 0.9.0, `jax_threefry_partitionable`):
`split(key, n)[i] = threefry(key, (0, i))`; `fold_in(key, d) =
threefry(key, (0, d))`; `random_bits(key, shape)[i] = x0 ^ x1` of
`threefry(key, (i >> 32, i & 0xFFFFFFFF))`; `uniform` keeps the top 23
bits as the mantissa of a float in [1, 2) and subtracts 1.
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
                device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """32 random bits per element (int64 holding uint32), `shape`."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    return (x0 ^ x1).reshape(tuple(shape))


def uniform(key: Key, shape: Sequence[int],
            device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    bits = random_bits(key, shape, device)
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0
