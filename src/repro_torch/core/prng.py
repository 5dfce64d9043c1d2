"""Threefry-2x32 keys and draws, bit for bit as jax produces them.

The reference draws its randomized coresets with ``jax.random`` under
``jax_threefry_partitionable = True`` (the default of jax 0.9): a key
is two uint32 words, ``split`` and ``random_bits`` hash a 64-bit
counter — the flat index of each output — with the key, and ``gumbel``
(``mode="low"``) is ``−log(−log(uniform(tiny, 1)))``.  This module
spells the same functions out in torch, so the same key gives the same
bits on the CPU and on the card:

* uint32 words live in int64 tensors, every sum masked back to 32 bits
  (torch has no full uint32 arithmetic);
* a key, or a batch of keys, is a ``[..., 2]`` int64 tensor — the
  reference's ``key_data`` layout (:func:`wrap_key_data` takes the
  reference's uint32 words);
* the logs go through :func:`repro_torch.core.fp32.log`, XLA:CPU's
  float32 log, so the Gumbel draws equal the reference's bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import fp32

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)


def _rotl(v: torch.Tensor, d: int) -> torch.Tensor:
    return ((v << d) & MASK) | (v >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2)
    under key words (k1, k2); every argument an int64 tensor of uint32
    values, broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as its two words ``[2]`` (seed ≥ 0)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must lie in [0, 2^64), got {seed}")
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def wrap_key_data(words) -> torch.Tensor:
    """Keys from raw words ``[..., 2]`` (uint32 numpy or int64)."""
    if not torch.is_tensor(words):
        words = torch.from_numpy(np.asarray(words, dtype=np.int64))
    return words.to(torch.int64) & MASK


def _hash_counters(keys: torch.Tensor, idx: torch.Tensor):
    """Both output words for the flat counters ``idx`` (int64 [n]),
    under every key of ``keys`` [..., 2] → two [..., n] tensors."""
    k1 = keys[..., 0:1]
    k2 = keys[..., 1:2]
    return threefry2x32(k1, k2, idx >> 32, idx & MASK)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., 2]`` → ``[..., num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=keys.device)
    a, b = _hash_counters(keys, idx)
    return torch.stack([a, b], dim=-1)


def fold_in(keys: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a uint32 ``data`` word."""
    data = int(data) & MASK
    a, b = threefry2x32(keys[..., 0], keys[..., 1],
                        torch.zeros_like(keys[..., 0]),
                        torch.full_like(keys[..., 1], data))
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) of ``shape`` under every key of
    ``keys`` [..., 2] → int64 [..., *shape] of uint32 values; entry i
    hashes its flat index i."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=keys.device)
    a, b = _hash_counters(keys, idx)
    return (a ^ b).reshape(keys.shape[:-1] + shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) float32 from the top 23 bits (jax's mantissa
    trick: 1.m − 1)."""
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) under every key."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    floats = _unit_floats(random_bits(keys, shape))
    lo_t = torch.tensor(float(lo), dtype=torch.float32, device=keys.device)
    return torch.maximum(lo_t, floats * span + float(lo))


def gumbel(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel(mode="low")`` (float32) under every key:
    ``−log(−log(u))`` with u uniform on [tiny, 1)."""
    u = uniform(keys, shape, TINY, 1.0)
    return -fp32.log(-fp32.log(u))
