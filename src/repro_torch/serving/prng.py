"""Threefry-2x32 counter-based PRNG: the port's counterpart of the
`jax.random` calls the serving engine and the synthetic data pipeline
make (`PRNGKey`, `fold_in`, `split`, `categorical`, `uniform`, `randint`),
bit for bit as jax runs them with its default `threefry2x32`
implementation and `jax_threefry_partitionable=True`.

Keys are (..., 2) int64 tensors holding uint32 values: torch cannot add
uint32 tensors, so every word is computed in int64 and masked to 32 bits.
This is plain tensor code and runs on whatever device the key lives on.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2); all int64 tensors of uint32 values, broadcastable."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` (32-bit jax) for a seed in [0, 2**32)."""
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key, data):
    """`jax.random.fold_in`, batched: key (..., 2), data (...) integers."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o1, o2], dim=-1)


def split(key, num: int = 2):
    """`jax.random.split`, batched: key (..., 2) -> (..., num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key, n: int):
    """32-bit words of `jax.random.bits(key, (n,))`, batched over key
    (..., 2) -> (..., n) int64."""
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          torch.zeros_like(lo), lo)
    return o1 ^ o2


def uniform(key, n: int, minval: float = _TINY):
    """float32 `jax.random.uniform(key, (n,), minval=minval, maxval=1)`
    for minval tiny (the draw under `gumbel`, the default) or 0: the top
    23 bits become the mantissa of a float in [1, 2), minus 1."""
    if minval not in (0.0, _TINY):
        raise ValueError(f"minval {minval}: only 0 and float32 tiny")
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    # (1 - minval) rounds to 1.0 in float32, so floats * 1 + minval
    return torch.clamp_min(floats + minval, minval)


def randint(key, n: int, minval: int, maxval: int):
    """int32 `jax.random.randint(key, (n,), minval, maxval)`, batched over
    key (..., 2) -> (..., n) int64: two 32-bit draws per value, reduced
    modulo the span with jax's uint32 wrap-around."""
    span = maxval - minval
    if not 0 < span <= _MASK:
        raise ValueError(f"randint span {span} outside (0, 2**32)")
    k = split(key)
    hi = random_bits(k[..., 0, :], n)
    lo = random_bits(k[..., 1, :], n)
    mult = ((2 ** 16 % span) ** 2 & _MASK) % span
    off = ((hi % span) * mult) & _MASK
    off = ((off + lo % span) & _MASK) % span
    return off + minval


def randint64(key, n: int, minval: int, maxval: int) -> list:
    """int64 `jax.random.randint(key, (n,), minval, maxval)` (jax with
    jax_enable_x64, where randint's default dtype is int64) for one key
    (2,): a list of Python ints.  Each value takes two 64-bit draws, each
    the two threefry output words of its counter joined (hi << 32 | lo),
    reduced modulo the span with jax's uint64 wrap-around; the reduction
    runs in Python integers on the host."""
    span = maxval - minval
    if not 0 < span < 2 ** 63:
        raise ValueError(f"randint64 span {span} outside (0, 2**63)")
    wrap = 2 ** 64
    lo_ix = torch.arange(n, dtype=torch.int64, device=key.device)
    words = []
    for k in split(key):
        o1, o2 = threefry2x32(k[0], k[1], torch.zeros_like(lo_ix), lo_ix)
        words.append([(a << 32) | b for a, b in zip(o1.tolist(),
                                                     o2.tolist())])
    mult = (2 ** 32 % span) ** 2 % wrap % span
    return [(hi % span * mult % wrap + lo % span) % wrap % span + minval
            for hi, lo in zip(*words)]


def categorical(key, logits):
    """`jax.random.categorical(key, logits)` over the last axis, batched:
    key (..., 2), logits (..., n) float32 -> (...) int64 (Gumbel-max)."""
    u = uniform(key, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1)
