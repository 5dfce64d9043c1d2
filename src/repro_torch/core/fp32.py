"""Float32 arithmetic in the reference's rounding order.

The parity bar holds protocol outputs (coreset indices, ERM winners,
round bounds) bit-equal to the JAX reference, and those integers are
decided by float32 sums and transcendental functions.  Plain torch
reductions round differently: ``torch.cumsum`` on the CPU accumulates
in float64, on CUDA it runs a parallel scan, and ``torch.sum`` uses
yet another tree.  This module spells out, with elementwise IEEE
float32 operations only, the orders XLA:CPU uses, so the port gives
the reference's bits on the CPU and the same bits on the card:

* :func:`sum_` — a reduction over n > 32 elements becomes a
  reduce-window of 32 (the input zero-padded symmetrically to a
  multiple of 32), each window summed left to right, the window sums
  reduced again the same way; n ≤ 32 is summed left to right;
* :func:`cumsum` — a prefix sum becomes blocks of 16 (zero-padded at
  the end), each block scanned left to right, the block totals scanned
  recursively and added back;
* :func:`log` / :func:`log2` — XLA:CPU's Cephes float32 polynomial
  with its fused multiply-adds; ``log2(x)`` is ``log(x)·(1/ln 2)``;
* :func:`exp` / :func:`exp2` — the Cephes float32 exp with its fused
  multiply-adds and flush-to-zero; ``exp2(x)`` is ``exp(x·ln 2)``;
* :func:`tanh` / :func:`expm1` — XLA's rational tanh (Eigen's) and
  ``expm1`` built on it, as XLA:CPU lowers both;
  :data:`EXP2_NEG` tabulates ``exp2(-s)`` for s in [0, 126]: from s = 13
  on these are not exact powers of two, and the quantile coreset's
  levels are built from them.

Each order was established against jax 0.9.0 on the CPU;
tests/test_torch_core.py holds every function here to the reference
bit for bit.  Everything is elementwise IEEE arithmetic (float64 only
inside the exact FMA), so the CPU and the card give the same bits.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

_SUM_WINDOW = 32
_SCAN_BLOCK = 16


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0] + 0.0                # XLA's init value is +0.0
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def sum_(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA:CPU's order (see module doc)."""
    n = x.shape[-1]
    if n <= _SUM_WINDOW:
        return _seq_sum(x)
    pad = (-n) % _SUM_WINDOW
    xp = F.pad(x, (pad // 2, pad - pad // 2))
    return sum_(_seq_sum(xp.reshape(*x.shape[:-1], -1, _SUM_WINDOW)))


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    cols = [x[..., 0] + 0.0]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in XLA:CPU's order."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _seq_cumsum(x)
    lead = x.shape[:-1]
    nb = -(-n // _SCAN_BLOCK)
    xp = F.pad(x, (0, nb * _SCAN_BLOCK - n))
    w = _seq_cumsum(xp.reshape(*lead, nb, _SCAN_BLOCK))
    totals = cumsum(w[..., -1])
    excl = F.pad(totals[..., :-1], (1, 0))
    return (w + excl[..., None]).reshape(*lead, -1)[..., :n]


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """Correctly rounded float32 ``a·b + c`` from float64 parts
    (``b``/``c`` tensors or float32-exact Python floats).

    The float64 product of two float32 values is exact, and so is the
    float32 rounding of the float64 sum ``s`` unless ``s`` lands on a
    midpoint between two float32 neighbours (float64 rounding cannot
    cross one); there TwoSum's error term, the part of the exact sum
    that ``s`` dropped, breaks the tie: ``s`` moves one float64 step
    toward it, off the midpoint.  A ``meta`` tensor (no values) has no
    tie to break.
    """
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    cd = c.double() if torch.is_tensor(c) else c
    s = p + cd
    r = s.float()
    rd = r.double()
    nb = torch.nextafter(r, torch.where(s > rd, math.inf, -math.inf)
                         .to(r.dtype)).double()
    mid = s * 2.0 == rd + nb
    if r.is_meta or not bool(mid.any()):
        return r
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    fixed = torch.where(err != 0, torch.nextafter(s, toward), s).float()
    return torch.where(mid, fixed, r)


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (exact in float64,
    so torch applies it to float32 tensors unchanged on every device)."""
    return float(np.float32(v))


_LOG_P = [_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_MIN_NORM = _f32(1.17549435e-38)
_LN2 = _f32(math.log(2.0))
LN2 = _LN2                    # ln 2 rounded to float32
# XLA folds x / ln 2 into x · (1/ln 2), the reciprocal rounded to float32
_INV_LN2 = float(np.float32(1.0) / np.float32(_LN2))
INV_LN2 = _INV_LN2


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 natural log, for positive finite ``x``."""
    x = torch.clamp(x.float(), min=_MIN_NORM)
    bits = x.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 0x7F).float()
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < _SQRTHF
    e = e - small.float()
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = t * t
    x3 = x2 * t
    P = _LOG_P
    y = fma(t, P[0], P[1])
    y1 = fma(t, P[3], P[4])
    y2 = fma(t, P[6], P[7])
    y = fma(y, t, P[2])
    y1 = fma(y1, t, P[5])
    y2 = fma(y2, t, P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _LOG_Q1)
    t = t - x2 * 0.5
    t = t + y
    return t + e * _LOG_Q2


def log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` as XLA:CPU evaluates it: ``log(x)·(1/ln 2)``."""
    return log(x) * _INV_LN2


def num_rounds(rounds_factor: int, m: torch.Tensor, traced: bool):
    """``ceil(rounds_factor·log2 m)`` in float32, as the reference
    computes it on the host (``traced=False``: the product rounds after
    log2) or inside a jitted engine (``traced=True``: XLA folds the two
    constants into one factor first).  The two disagree for a few m
    (ROADMAP queue 3); the port reproduces each where its reference
    uses it.  ``m`` is a float32 tensor ≥ 2; returns int32."""
    if traced:
        r = log(m) * float(np.float32(rounds_factor) * np.float32(_INV_LN2))
    else:
        r = log2(m) * float(rounds_factor)
    return torch.ceil(r).to(torch.int32)


_EXP_P = [_f32(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1)]


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 exp (Cephes with fused multiply-adds, and
    flush-to-zero of subnormal results); exp(−inf) = 0."""
    x = x.float().clamp(-88.8, 88.8)
    n = torch.floor(fma(x, _f32(1.44269504088896341), 0.5))
    r = fma(n, -0.693359375, x)
    r = fma(n, _f32(2.12194440e-4), r)
    z = r * r
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = fma(y, r, p)
    y = fma(y, z, r) + 1.0
    # 2^n from its float64 exponent bits (|n| ≤ 128): exact everywhere
    scale = ((n.to(torch.int64) + 1023) << 52).view(torch.float64)
    out = (y.double() * scale).float()
    return torch.where(out < _MIN_NORM, torch.zeros_like(out), out)


def exp2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2`` as XLA:CPU lowers it: ``exp(x·ln 2)``."""
    return exp(x * _LN2)


# exp2(-s), s = 0 … 126: the quantile coreset's weights
EXP2_NEG = exp2(-torch.arange(127, dtype=torch.float32))


@functools.cache
def _exp2_neg_on(device: torch.device) -> torch.Tensor:
    return EXP2_NEG.to(device)


def exp2_neg(shift: torch.Tensor) -> torch.Tensor:
    """``jnp.exp2(-shift)`` for integer ``shift`` in [0, 126]."""
    return _exp2_neg_on(shift.device)[shift.long()]


# XLA:CPU's float32 erf: x clamped to ±3.7439213, then x·P(x²)/Q(x²)
# with every step of both polynomials an FMA (LLVM emits llvm.fma).
_ERF_CLAMP = _f32(3.7439212799072266)
_ERF_P = [_f32(v) for v in (
    0.00022905065270606428, 0.0034082909114658833, 0.050955694168806076,
    0.18520832061767578, 1.1283791065216064)]
_ERF_Q = [_f32(v) for v in (
    -1.1791603071742429e-07, 2.354796561121475e-05, 0.0010179625824093819,
    0.01407046988606453, 0.11098504811525345, 0.4974692463874817, 1.0)]


def erf(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 erf."""
    x = x.float().clamp(-_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    p = fma(x2, _ERF_P[0], _ERF_P[1])
    for c in _ERF_P[2:]:
        p = fma(p, x2, c)
    q = fma(x2, _ERF_Q[0], _ERF_Q[1])
    for c in _ERF_Q[2:]:
        q = fma(q, x2, c)
    return (x * p) / q


# XLA:CPU's float32 log1p: for |x| < √2 − 1 the rational
# x − x²/2 + x³·N(x)/D(x) (Horner steps contracted into FMAs), else
# log(1 + x).
_LOG1P_SMALL = _f32(0.4142135679721832)
_LOG1P_N = [_f32(v) for v in (
    4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
    29.91191864013672, 60.949668884277344, 57.11296463012695,
    20.039552688598633)]
_LOG1P_D = [_f32(v) for v in (
    15.062909126281738, 83.04756927490234, 221.7624053955078,
    309.0987243652344, 216.42788696289062, 60.11865997314453)]


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log1p, for x in (−1, ∞) (finite)."""
    x = x.float()
    x2 = x * x
    n = torch.full_like(x, _LOG1P_N[0])
    for c in _LOG1P_N[1:]:
        n = fma(n, x, c)
    d = torch.ones_like(x)
    for c in _LOG1P_D:
        d = fma(d, x, c)
    small = fma(x2, -0.5, (x * x2) * (n / d)) + x
    return torch.where(x.abs() < _LOG1P_SMALL, small, log(1.0 + x))


# Giles' single-precision erf_inv, as XLA lowers chlo.erf_inv:
# w = −log1p(−x²); t = w − 2.5 (w < 5) or √w − 3; x·P(t), every Horner
# step an FMA.
_ERFINV_LT = [_f32(v) for v in (
    2.810226362726098e-08, 3.432739390518691e-07, -3.523387704262859e-06,
    -4.391506536194356e-06, 0.00021858086984138936, -0.001253725029528141,
    -0.004177681636065245, 0.24664072692394257, 1.5014094114303589)]
_ERFINV_GE = [_f32(v) for v in (
    -0.0002002142573473975, 0.0001009505576803349, 0.0013493432197719812,
    -0.003673428436741233, 0.005739507731050253, -0.007622461300343275,
    0.00943887047469616, 1.0016740560531616, 2.832976818084717)]


def erf_inv_poly(x: torch.Tensor) -> torch.Tensor:
    """``P(t)`` of :func:`erf_inv` (so that ``erf_inv(x) = x·P``)."""
    x = x.float()
    lg = log1p(x * -x)
    lt = lg > -5.0
    # IEEE sqrt: via float64 (torch's float32 sqrt on the CPU can be off
    # by one ULP; the float64 root rounds to the correctly rounded one)
    root = torch.sqrt(-lg.double()).float()
    t = torch.where(lt, -2.5 - lg, root - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LT[i], _ERFINV_GE[i])

    p = fma(coef(0), t, coef(1))
    for i in range(2, 9):
        p = fma(t, p, coef(i))
    return p


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 erf_inv, for x in (−1, 1)."""
    return x.float() * erf_inv_poly(x)


# XLA's float32 tanh (Eigen's rational approximation): x clamped to
# ±7.9988117, x·N(x²)/D(x²) with every Horner step an FMA; |x| < 0.0004
# returns x.
_TANH_CLAMP = _f32(7.99881172180175781)
_TANH_N = [_f32(v) for v in (
    -2.76076847742355e-16, 2.00018790482477e-13, -8.60467152213735e-11,
    5.12229709037114e-08, 1.48572235717979e-05, 6.37261928875436e-04,
    4.89352455891786e-03)]
_TANH_D = [_f32(v) for v in (
    1.19825839466702e-06, 1.18534705686654e-04, 2.26843463243900e-03,
    4.89352518554385e-03)]


def tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 tanh."""
    x = x.float()
    c = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    c2 = c * c
    n = torch.full_like(x, _TANH_N[0])
    for v in _TANH_N[1:]:
        n = fma(c2, n, v)
    d = torch.full_like(x, _TANH_D[0])
    for v in _TANH_D[1:]:
        d = fma(c2, d, v)
    return torch.where(x.abs() < _f32(0.0004), x, (c * n) / d)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 expm1: ``exp(x) − 1`` for |x| > 1/2, else
    ``tanh(x/2)·(exp(x) + 1)``; x where x/2 is 0."""
    x = x.float()
    e = exp(x)
    half = x * 0.5
    out = torch.where(x.abs() > 0.5, e - 1.0, tanh(half) * (e + 1.0))
    return torch.where(half == 0, x, out)
