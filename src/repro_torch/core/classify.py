"""AccuratelyClassify (Figure 2): quarantine primitives and the final
classifier (counterpart of repro.core.classify, integer track).

A stuck attempt quarantines every copy of every point of its coreset,
on every player (full-point quarantine, docs/architecture.md); the
final classifier votes each disputed point by its full label counts in
S and defers to the boosted ensemble elsewhere, so E_S(f) ≤ OPT.  The
host loop ``run_accurately_classify`` is the JAX package's spec; the
port's tests hold this package to it through the JAX batched engine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import weak


def match_points(x: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """out = 1[x ∈ set(pts)] by sorted membership.

    x: [..., k, mloc] int points; pts: [..., P] (need not be
    deduplicated), the same leading axes as x.
    """
    ps = torch.sort(pts, dim=-1).values
    xf = x.reshape(pts.shape[:-1] + (-1,))
    pos = torch.searchsorted(ps, xf).clamp(0, pts.shape[-1] - 1)
    return (torch.gather(ps, -1, pos) == xf).reshape(x.shape)


def _sentinel(dtype) -> int:
    """dtype max — outside every [0, n) domain."""
    return torch.iinfo(dtype).max


def mask_invalid_points(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Replace entries where ``valid`` is False by a value no real point
    can equal."""
    return torch.where(valid, pts, _sentinel(pts.dtype))


def distinct_count_masked(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """|unique(pts[valid])| over the last axis, int32."""
    big = _sentinel(pts.dtype)
    ps = torch.sort(torch.where(valid, pts, big), dim=-1).values
    bumps = torch.cat([torch.ones_like(ps[..., :1], dtype=torch.bool),
                       ps[..., 1:] != ps[..., :-1]], dim=-1)
    return (bumps & (ps != big)).sum(dim=-1, dtype=torch.int32)


def dispute_table(x: np.ndarray, y: np.ndarray, alive0: np.ndarray,
                  disputed: np.ndarray):
    """Host-side (unique points, n₊, n₋) from a disputed-example mask.

    Quarantine removes every copy of a disputed point, so the copies
    alive at its quarantine are its initially-alive copies: the counts
    follow from the mask alone.  Points with no alive copy under
    ``alive0`` carry no label evidence and are dropped.
    """
    x, y = np.asarray(x), np.asarray(y)
    alive0, disputed = np.asarray(alive0), np.asarray(disputed)
    pts = np.unique(x.reshape(-1)[disputed.reshape(-1)])
    pos, neg = _point_counts(x, y, alive0, pts)
    keep = (pos + neg) > 0
    return pts[keep], pos[keep], neg[keep]


def _point_counts(x, y, alive, pts):
    """Label counts of each (sorted, unique) point over alive copies."""
    flat = x.reshape(-1)
    if pts.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    at = np.clip(np.searchsorted(pts, flat), 0, pts.size - 1)
    hit = (pts[at] == flat) & alive.reshape(-1)
    yf = y.reshape(-1)
    pos = np.bincount(at[hit & (yf > 0)], minlength=pts.size)
    neg = np.bincount(at[hit & (yf < 0)], minlength=pts.size)
    return pos.astype(np.int64), neg.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ResilientClassifier:
    """The final classifier f — dispute vote patched over the ensemble.

    Host arrays; calling it on a tensor of points evaluates on that
    tensor's device and returns int8 ±1 of the same shape.
    """

    cls: object
    hypotheses: np.ndarray       # [T, 4]
    rounds: int
    dispute_x: np.ndarray        # [P]
    dispute_pos: np.ndarray      # [P]
    dispute_neg: np.ndarray      # [P]

    def g(self, x: torch.Tensor) -> torch.Tensor:
        hyp = torch.as_tensor(self.hypotheses, device=x.device)
        return weak.ensemble_predict(self.cls, hyp, self.rounds, x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        gx = self.g(x)
        if self.dispute_x.shape[0] == 0:
            return gx
        # the reference sums the counts of every matching entry: fold
        # duplicate points first, then look each x up once
        pts, inv = np.unique(self.dispute_x, return_inverse=True)
        pos = np.bincount(inv, weights=self.dispute_pos, minlength=pts.size)
        neg = np.bincount(inv, weights=self.dispute_neg, minlength=pts.size)
        dev = x.device
        ps = torch.as_tensor(pts, device=dev).to(x.dtype)
        at = torch.searchsorted(ps, x.reshape(-1)).clamp(0, pts.size - 1)
        in_d = (ps[at] == x.reshape(-1)).reshape(x.shape)
        pos_t = torch.as_tensor(pos.astype(np.int64), device=dev)[at]
        neg_t = torch.as_tensor(neg.astype(np.int64), device=dev)[at]
        vote = torch.where(pos_t >= neg_t, 1, -1).reshape(x.shape)
        return torch.where(in_d, vote.to(torch.int8), gx)


def make_classifier(cls, result) -> ResilientClassifier:
    pos, neg = result.dispute_y
    return ResilientClassifier(
        cls=cls, hypotheses=np.asarray(result.hypotheses),
        rounds=int(result.rounds), dispute_x=np.asarray(result.dispute_x),
        dispute_pos=np.asarray(pos), dispute_neg=np.asarray(neg))
