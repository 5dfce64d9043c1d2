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
  float32 log, so the Gumbel draws equal the reference's bit for bit;
* ``uniform``'s ``f·(hi − lo) + lo`` is one FMA, as XLA:CPU contracts
  it;
* :func:`normal` is ``√2 · erf_inv(uniform(nextafter(−1, 0), 1))``;
* :func:`truncated_normal` spells out jax's jitted
  ``_truncated_normal`` as XLA:CPU compiles it (its erf, log1p and
  erf_inv polynomials with their fused multiply-adds), drawn in slices
  of the counter range so a large leaf needs little scratch memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import fp32
from repro_torch.core.pinned import pinned_argmax

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2)
    under key words (k1, k2); every argument an int64 tensor of uint32
    values, broadcast together.  Returns the two output words.  The
    rounds update two buffers in place (no temporaries per step)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = torch.broadcast_tensors(x1 + ks[0], x2 + ks[1])
    a = a.contiguous() & MASK
    b = b.contiguous() & MASK
    t = torch.empty_like(b)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a += b
            a &= MASK
            torch.bitwise_left_shift(b, r, out=t)     # b ← rotl(b, r) ^ a
            t &= MASK
            b >>= 32 - r
            b |= t
            b ^= a
        a += ks[(i + 1) % 3]
        a &= MASK
        b += ks[(i + 2) % 3]
        b += i + 1
        b &= MASK
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
    under every key of ``keys`` [..., 2] → two [..., n] tensors (empty
    ones for keys on ``meta``: their words hold no value to hash)."""
    if keys.is_meta:
        words = torch.empty(keys.shape[:-1] + idx.shape, dtype=torch.int64,
                            device=keys.device)
        return words, words
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


def randint(keys: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``
    under every key: two 32-bit draws (from ``split(key)``) folded into
    [minval, maxval) with jax's uint32 modular arithmetic."""
    minval, maxval = int(minval), int(maxval)
    halves = split(keys, 2)
    hi = random_bits(halves[..., 0, :], shape)
    lo = random_bits(halves[..., 1, :], shape)
    span = 1 if maxval <= minval else maxval - minval
    mult = ((((1 << 16) % span) ** 2) & MASK) % span    # uint32 product
    off = (((hi % span) * mult) & MASK) + lo % span
    off = (off & MASK) % span
    return (minval + off).to(torch.int32)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Uniform [0, 1) float32 from the top 23 bits (jax's mantissa
    trick: 1.m − 1)."""
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0


def _uniform_from_bits(bits: torch.Tensor, minval: float,
                       maxval: float) -> torch.Tensor:
    """``max(lo, f·(hi − lo) + lo)`` in float32 for the unit floats f of
    ``bits``; XLA:CPU contracts the product and the sum into one FMA
    (the same value when the span is 1)."""
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    f = _unit_floats(bits)
    v = f * span + lo if span == 1.0 else fp32.fma(f, span, lo)
    return torch.clamp(v, min=lo)


def _no_draw(keys: torch.Tensor, shape) -> torch.Tensor:
    """A draw's float32 result without its values, for keys on
    ``meta``: what ``jax.eval_shape`` of a draw gives."""
    return torch.empty(keys.shape[:-1] + tuple(int(s) for s in shape),
                       dtype=torch.float32, device=keys.device)


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` (float32) under every key (keys on
    ``meta`` draw nothing)."""
    if keys.is_meta:
        return _no_draw(keys, shape)
    return _uniform_from_bits(random_bits(keys, shape), minval, maxval)


# XLA folds ``x / sqrt(2)`` into ``x · f32(1/√2)``
_INV_SQRT2 = float(np.float32(1.0) / np.float32(math.sqrt(2.0)))
_SQRT2 = float(np.float32(math.sqrt(2.0)))
CHUNK = 1 << 24               # counters per slice of a large draw


def _f32_after(v: float, toward: float) -> float:
    return float(np.nextafter(np.float32(v), np.float32(toward)))


def truncated_normal(keys: torch.Tensor, lower: float, upper: float,
                     shape=(), chunk: int = CHUNK) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)``
    (float32) under every key of ``keys`` [..., 2].

    ``u = uniform(a, b)`` with ``a, b = erf(lower/√2), erf(upper/√2)``,
    then ``(u·P(u))·√2`` (``P`` = :func:`fp32.erf_inv_poly`) clipped to
    the open interval, all in XLA:CPU's float32 order.  The counters
    are hashed ``chunk`` at a time; the bits do not depend on the
    slicing.  Keys on ``meta`` draw nothing."""
    if keys.is_meta:
        return _no_draw(keys, shape)
    shape = tuple(int(s) for s in shape)
    bounds = torch.tensor([lower, upper], dtype=torch.float32)
    a, b = (float(v) for v in fp32.erf(bounds * _INV_SQRT2))
    lo_clip = _f32_after(lower, math.inf)
    hi_clip = _f32_after(upper, -math.inf)
    n = math.prod(shape)
    out = torch.empty(keys.shape[:-1] + (n,), dtype=torch.float32,
                      device=keys.device)
    for start in range(0, n, chunk):
        idx = torch.arange(start, min(n, start + chunk), dtype=torch.int64,
                           device=keys.device)
        h1, h2 = _hash_counters(keys, idx)
        u = _uniform_from_bits(h1 ^ h2, a, b)
        del h1, h2
        z = (u * fp32.erf_inv_poly(u)) * _SQRT2
        out[..., start:start + idx.numel()] = z.clamp(lo_clip, hi_clip)
    return out.reshape(keys.shape[:-1] + shape)


_NORMAL_LO = _f32_after(-1.0, 0.0)


def normal(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` (float32) under every key: ``√2 ·
    erf_inv(u)`` with u uniform on [nextafter(−1, 0), 1), as jax's
    jitted ``_normal_real`` computes it on XLA:CPU."""
    u = uniform(keys, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * fp32.erf_inv(u)


def gumbel(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel(mode="low")`` (float32) under every key:
    ``−log(−log(u))`` with u uniform on [tiny, 1)."""
    return gumbel_of_uniform(uniform(keys, shape, TINY, 1.0))


def gumbel_of_uniform(u: torch.Tensor) -> torch.Tensor:
    """``−log(−log(u))`` in XLA:CPU's float32."""
    return -fp32.log(-fp32.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor,
                shape=None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` (axis −1,
    ``replace=True``) under every key of ``keys`` [*K, 2]; ``logits``
    [*K, *batch, n] holds each key's logits (or broadcasts to them).
    As jax 0.9 draws it in its default ``mode="low"``: the first
    maximum of ``gumbel(key, (*shape, n)) + logits`` over the last
    axis, a NaN counting as the maximum (``jnp.argmax``).  Returns
    int64 [*K, *shape]; ``shape`` defaults to ``batch`` and must end
    in it.

    The float32 Gumbel values are XLA:CPU's (:func:`gumbel`), but only
    the entries that can win are computed that way: a float64 screen
    (within 1e-5 relative of the row's best, far above the few float32
    ULPs by which the two differ) picks the candidates, so a row of n
    categories costs n float64 logs and a handful of emulated ones."""
    lead = keys.shape[:-1]
    batch = tuple(logits.shape[len(lead):-1])
    shape = batch if shape is None else tuple(int(s) for s in shape)
    if shape[len(shape) - len(batch):] != batch:
        raise ValueError(f"shape {shape} does not end in the logits' "
                         f"batch shape {batch}")
    n = logits.shape[-1]
    prefix = len(shape) - len(batch)
    lg = logits.float()
    if lg.ndim == len(lead) + len(batch) + 1:
        lg = lg.reshape(lead + (1,) * prefix + batch + (n,))
    u = _uniform_from_bits(random_bits(keys, shape + (n,)), TINY, 1.0)
    lg = lg.expand(u.shape)
    with torch.no_grad():
        vd = -torch.log(-torch.log(u.double())) + lg.double()
        nan = torch.isnan(vd)
        finite = torch.isfinite(vd)
        best = torch.where(finite, vd, -math.inf).amax(-1, keepdim=True)
        scale = torch.where(finite, vd.abs(), 0.0).amax(-1, keepdim=True)
        top = torch.where(nan, -math.inf, vd).amax(-1, keepdim=True)
        cand = ((vd >= best - 1e-5 * (1.0 + scale)) | (vd == top)) & ~nan
    v = torch.full(u.shape, -math.inf, dtype=torch.float32, device=u.device)
    v[cand] = gumbel_of_uniform(u[cand]) + lg[cand]
    first_nan = pinned_argmax(nan, dim=-1)
    return torch.where(nan.any(-1), first_nan, pinned_argmax(v, dim=-1))