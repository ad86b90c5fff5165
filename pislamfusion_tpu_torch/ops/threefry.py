"""The reference's random stream: JAX's threefry2x32 keys, in torch.

A `Key` is what `jax.random.PRNGKey(seed)` makes; `split` and `gumbel`
give the keys and the float32 noise that `jax.random.split(key)` and
`jax.random.gumbel(key, shape)` give (threefry2x32, partitionable bits,
the "low" Gumbel mode). A stage that draws from a `Key` makes the
reference's draws for the same seed, so that where a run's path turns on
its draws (a loop closure that one sample set accepts and another
rejects), both packages turn alike. The words are held in int64 tensors
and masked to 32 bits; the noise is made on the CPU.
"""
from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words x1, x2
    (int64 tensors holding uint32 values) under the key (k1, k2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M
    return x1, x2


class Key:
    """A threefry2x32 key: `Key(seed)` holds jax.random.PRNGKey(seed)'s
    words, for a seed in [0, 2**32)."""

    def __init__(self, seed: int = 0, words=None):
        if words is None and not 0 <= seed <= _M:
            raise ValueError(f"seed {seed} is not in [0, 2**32)")
        self.words = (tuple(int(w) for w in words) if words is not None
                      else (0, seed))

    def _hash(self, n: int):
        """The two hash words of the counters 0 .. n-1 (iota_2x32_shape's
        high words are 0 below 2**32)."""
        lo = torch.arange(n, dtype=torch.int64)
        return threefry2x32(*self.words, torch.zeros_like(lo), lo)

    def split(self, num: int = 2):
        """The `num` keys of jax.random.split(key, num)."""
        b1, b2 = self._hash(num)
        return tuple(Key(words=(b1[i], b2[i])) for i in range(num))

    def gumbel(self, shape) -> torch.Tensor:
        """jax.random.gumbel(key, shape): float32 on the CPU."""
        n = 1
        for s in shape:
            n *= int(s)
        b1, b2 = self._hash(n)
        bits = (b1 ^ b2) >> 9 | 0x3F800000          # a float in [1, 2)
        u = bits.to(torch.int32).view(torch.float32) - 1.0
        tiny = torch.finfo(torch.float32).tiny
        u = torch.clamp_min(u * (1.0 - tiny) + tiny, tiny)
        return -torch.log(-torch.log(u)).reshape(tuple(shape))
