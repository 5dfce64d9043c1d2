"""AccuratelyClassify (Figure 2): quarantine primitives and the final
classifier (counterpart of repro.core.classify).

A stuck attempt quarantines every copy of every point of its coreset,
on every player (full-point quarantine, docs/architecture.md); the
final classifier votes each disputed point by its full label counts in
S and defers to the boosted ensemble elsewhere, so E_S(f) ≤ OPT.  The
host loop ``run_accurately_classify`` is the JAX package's spec; the
port's tests hold this package to it through the JAX batched engine.

Points are int32 domain values or float32 feature rows [.., F]; two
rows are equal when every feature is (``==``: a row holding a NaN
equals nothing, not even itself, as in the reference).  Rows are
matched by exact identities built from sorted columns
(:func:`_row_ids`), O((m + P)·F·log P) instead of the reference's
m × P compare.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import weak


def _row_ids(pts: torch.Tensor, valid: torch.Tensor, x=None):
    """Exact identities of float rows under ``==``.

    pts [..., P, F] with ``valid`` [..., P]; a row with a NaN, or not
    valid, matches nothing.  Returns (pid [..., P] int64: equal matchable
    rows share an id in [0, P), every other row P + its index; xid
    [..., M] int64 for rows ``x`` [..., M, F]: the id of an equal
    matchable row of pts, or −1 when there is none).  Column by column,
    a value's id is its first position in the sorted column, and a
    row prefix's id the first position of its (prefix id, value id)
    pair among the sorted pairs of pts.
    """
    P, F = pts.shape[-2:]
    ok = valid & ~torch.isnan(pts).any(dim=-1)
    big = P * P
    pv = torch.where(torch.isnan(pts), math.inf, pts)
    prev_p = torch.zeros(pts.shape[:-1], dtype=torch.int64,
                         device=pts.device)
    if x is not None:
        prev_x = torch.zeros(x.shape[:-1], dtype=torch.int64,
                             device=x.device)
        present = torch.ones(x.shape[:-1], dtype=torch.bool,
                             device=x.device)
    for f in range(F):
        srt = torch.sort(pv[..., f], dim=-1).values
        pair_p = torch.where(
            ok, prev_p * P + torch.searchsorted(srt, pv[..., f].contiguous()),
            big)
        sp = torch.sort(pair_p, dim=-1).values
        prev_p = torch.searchsorted(sp, pair_p)
        if x is not None:
            xc = x[..., f].contiguous()
            rx = torch.searchsorted(srt, xc).clamp(max=P - 1)
            present &= torch.gather(srt, -1, rx) == xc
            pair_x = prev_x * P + rx
            px = torch.searchsorted(sp, pair_x).clamp(max=P - 1)
            present &= torch.gather(sp, -1, px) == pair_x
            prev_x = px
    pid = torch.where(ok, prev_p, P + torch.arange(P, device=pts.device))
    xid = None if x is None else torch.where(present, prev_x, -1)
    return pid, xid


def match_points(x: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """out = 1[x ∈ set(pts)].

    x: [..., k, mloc] int points with pts [..., P] (sorted membership),
    or [..., k, mloc, F] feature rows with pts [..., P, F] (row
    identities); pts need not be deduplicated and share x's leading
    axes.
    """
    if torch.is_floating_point(x):
        lead = pts.shape[:-2]
        flat = x.reshape(lead + (-1, x.shape[-1]))
        valid = torch.ones(pts.shape[:-1], dtype=torch.bool,
                           device=pts.device)
        return (_row_ids(pts, valid, flat)[1] >= 0).reshape(x.shape[:-1])
    ps = torch.sort(pts, dim=-1).values
    xf = x.reshape(pts.shape[:-1] + (-1,))
    pos = torch.searchsorted(ps, xf).clamp(0, pts.shape[-1] - 1)
    return (torch.gather(ps, -1, pos) == xf).reshape(x.shape)


def _sentinel(dtype) -> int:
    """dtype max — outside every [0, n) domain."""
    return torch.iinfo(dtype).max


def mask_invalid_points(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Replace entries where ``valid`` is False by a value no real point
    can equal: the dtype max for int points, NaN for feature rows."""
    if torch.is_floating_point(pts):
        return torch.where(valid[..., None], pts, math.nan)
    return torch.where(valid, pts, _sentinel(pts.dtype))


def distinct_count_masked(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """|unique(pts[valid])| over the point axis, int32: pts [..., P]
    int points or [..., P, F] feature rows (a valid row holding a NaN
    equals no other row and counts once, as in the reference)."""
    if torch.is_floating_point(pts):
        P = pts.shape[-2]
        pid = _row_ids(pts, valid)[0]
        ok = pid < P
        ids = torch.sort(torch.where(ok, pid, P), dim=-1).values
        bumps = torch.cat([torch.ones_like(ids[..., :1], dtype=torch.bool),
                           ids[..., 1:] != ids[..., :-1]], dim=-1)
        return ((bumps & (ids < P)).sum(dim=-1, dtype=torch.int32)
                + (valid & ~ok).sum(dim=-1, dtype=torch.int32))
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
    sel = disputed.reshape(-1)
    if x.ndim == 3:                                    # feature rows
        pts = np.unique(x.reshape(-1, x.shape[-1])[sel], axis=0)
    else:
        pts = np.unique(x.reshape(-1)[sel])
    pos, neg = _point_counts(x, y, alive0, pts)
    keep = (pos + neg) > 0
    return pts[keep], pos[keep], neg[keep]


def _point_counts(x, y, alive, pts):
    """Label counts of each (sorted, unique) point over alive copies."""
    if pts.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if x.ndim == 3:
        # one lexicographic pass over pts and S gives each row of S the
        # index of its equal disputed row (−1 for none)
        flat = x.reshape(-1, x.shape[-1])
        _, inv = np.unique(np.concatenate([pts, flat]), axis=0,
                           return_inverse=True)
        inv = inv.reshape(-1)
        table = np.full(inv.max() + 1, -1, np.int64)
        table[inv[:pts.shape[0]]] = np.arange(pts.shape[0])
        at = table[inv[pts.shape[0]:]]
        hit = (at >= 0) & alive.reshape(-1)
        at = np.maximum(at, 0)
    else:
        flat = x.reshape(-1)
        at = np.clip(np.searchsorted(pts, flat), 0, pts.size - 1)
        hit = (pts[at] == flat) & alive.reshape(-1)
    yf = y.reshape(-1)
    pos = np.bincount(at[hit & (yf > 0)], minlength=pts.shape[0])
    neg = np.bincount(at[hit & (yf < 0)], minlength=pts.shape[0])
    return pos.astype(np.int64), neg.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ResilientClassifier:
    """The final classifier f — dispute vote patched over the ensemble.

    Host arrays; calling it on a tensor of points (or of feature rows
    [..., F]) evaluates on that tensor's device and returns int8 ±1 of
    the points' shape.
    """

    cls: object
    hypotheses: np.ndarray       # [T, P_dim]
    rounds: int
    dispute_x: np.ndarray        # [P] or [P, F]
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
        rows = self.dispute_x.ndim == 2
        pts, inv = np.unique(self.dispute_x, axis=0 if rows else None,
                             return_inverse=True)
        inv = inv.reshape(-1)
        n = pts.shape[0]
        pos = np.bincount(inv, weights=self.dispute_pos, minlength=n)
        neg = np.bincount(inv, weights=self.dispute_neg, minlength=n)
        dev = x.device
        ps = torch.as_tensor(pts, device=dev).to(x.dtype)
        shape = gx.shape
        if rows:
            pid, xid = _row_ids(ps, torch.ones(n, dtype=torch.bool,
                                               device=dev),
                                x.reshape(-1, x.shape[-1]))
            # pid of a matchable row indexes the table of unique rows
            slot = torch.full((2 * n,), -1, dtype=torch.int64, device=dev)
            slot[pid] = torch.arange(n, device=dev)
            at = torch.where(xid >= 0, slot[xid.clamp(min=0)], -1)
            in_d = (at >= 0).reshape(shape)
            at = at.clamp(min=0)
        else:
            at = torch.searchsorted(ps, x.reshape(-1)).clamp(0, n - 1)
            in_d = (ps[at] == x.reshape(-1)).reshape(shape)
        pos_t = torch.as_tensor(pos.astype(np.int64), device=dev)[at]
        neg_t = torch.as_tensor(neg.astype(np.int64), device=dev)[at]
        vote = torch.where(pos_t >= neg_t, 1, -1).reshape(shape)
        return torch.where(in_d, vote.to(torch.int8), gx)


def make_classifier(cls, result) -> ResilientClassifier:
    pos, neg = result.dispute_y
    return ResilientClassifier(
        cls=cls, hypotheses=np.asarray(result.hypotheses),
        rounds=int(result.rounds), dispute_x=np.asarray(result.dispute_x),
        dispute_pos=np.asarray(pos), dispute_neg=np.asarray(neg))
