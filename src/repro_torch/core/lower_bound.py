"""Theorem 2.3, the complementing negative result — the port of
``repro.core.lower_bound``.

The Kane–Livni–Moran–Yehudayoff mapping turns a set-disjointness
instance (x, y ∈ {0,1}^r) into a 2-player sample for singletons,
F_a(x) = {(i, (−1)^{1−x_i})}, F_b(y) = {(i, (−1)^{1−y_i})}.  If x and y
are disjoint every classifier errs ≥ w(x)+w(y) times on it, otherwise
the best singleton errs w(x)+w(y)−2; so a learner with E_S(f) ≤ OPT
decides disjointness, which costs Ω(r) bits.  ``solve_disjointness``
runs the port's host loop (:func:`repro_torch.core.classify.learn`) on
the reduction, so benchmarks can check that the protocol solves the
hard instances with communication linear in OPT.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import classify, prng, weak
from repro_torch.core.types import BoostConfig
from repro_torch.device import resolve_device


def disj_to_sample(xbits: np.ndarray, ybits: np.ndarray, n: int,
                   device=None):
    """The 2-player sample ⟨F_a(x); F_b(y)⟩ over [n): x [2, r] int32
    points, y [2, r] int8 labels (only the points [0, r) appear).
    Tensors on ``device`` (``cuda`` unless the caller asks for the
    CPU)."""
    dev = resolve_device(device)
    r = xbits.shape[0]
    assert ybits.shape[0] == r and r <= n
    pts = np.arange(r, dtype=np.int32)
    sa = ((-1) ** (1 - xbits)).astype(np.int8)      # +1 iff x_i = 1
    sb = ((-1) ** (1 - ybits)).astype(np.int8)
    x = torch.from_numpy(np.stack([pts, pts])).to(dev)
    y = torch.from_numpy(np.stack([sa, sb])).to(dev)
    return x, y


@dataclasses.dataclass
class DisjOutcome:
    disjoint_decided: bool
    errors: int
    opt: int
    total_bits: int
    attempts: int


def solve_disjointness(xbits: np.ndarray, ybits: np.ndarray, n: int,
                       cfg: BoostConfig, seed: int = 0,
                       device=None) -> DisjOutcome:
    """The protocol π' from the proof of Theorem 2.3: learn the sample
    with keys from ``prng.key(seed)``, answer "disjoint" iff E_S(f) ≥
    w(x)+w(y)."""
    dev = resolve_device(device)
    r = int(xbits.shape[0])
    wx, wy = int(xbits.sum()), int(ybits.sum())       # published: 2·log r bits
    x, y = disj_to_sample(xbits, ybits, n, dev)
    cls = weak.Singletons(n=n)
    f, res = classify.learn(x, y, prng.key(seed), cfg, cls, device=dev)
    errors = int(weak.empirical_errors(f(x.reshape(-1)), y.reshape(-1)))
    # true OPT of the sample (Lemma 5.1)
    inter = int(np.sum((xbits == 1) & (ybits == 1)))
    opt = wx + wy - 2 if inter > 0 else wx + wy
    bits = res.ledger.total_bits + 2 * max(1, int(np.ceil(np.log2(max(r, 2)))))
    return DisjOutcome(disjoint_decided=errors >= wx + wy, errors=errors,
                       opt=opt, total_bits=bits, attempts=res.attempts)


def random_disj_instance(rng: np.random.Generator, r: int, weight: int,
                         disjoint: bool):
    """Random DISJ instance with |x| = |y| = weight and the given answer
    (the reference's numpy calls, in its order)."""
    xbits = np.zeros(r, np.int8)
    ybits = np.zeros(r, np.int8)
    xi = rng.choice(r, size=weight, replace=False)
    xbits[xi] = 1
    if disjoint:
        rest = np.setdiff1d(np.arange(r), xi)
        ybits[rng.choice(rest, size=min(weight, rest.size),
                         replace=False)] = 1
    else:
        # force exactly one intersection point
        ybits[rng.choice(xi, size=1)] = 1
        rest = np.setdiff1d(np.arange(r), np.where(xbits | ybits)[0])
        extra = min(weight - 1, rest.size)
        if extra > 0:
            ybits[rng.choice(rest, size=extra, replace=False)] = 1
    return xbits, ybits
