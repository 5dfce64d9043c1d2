"""AccuratelyClassify (Figure 2): the host loop, quarantine primitives
and the final classifier (counterpart of repro.core.classify).

A stuck attempt quarantines every copy of every point of its coreset,
on every player (full-point quarantine, docs/architecture.md); the
final classifier votes each disputed point by its full label counts in
S and defers to the boosted ensemble elsewhere, so E_S(f) ≤ OPT.  The
host loop :func:`run_accurately_classify` (and :func:`learn`, its
one-call form) runs one BoostAttempt at a time on the device and
quarantines on the host with ``np.unique``/``np.isin``, as the
reference's spec does; the engines are held to it.

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

from repro_torch.core import boost_attempt, prng, weak
from repro_torch.core import ledger as L
from repro_torch.core.types import BoostConfig, ClassifyResult, Ledger
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace


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


def distinct_count(pts: torch.Tensor) -> torch.Tensor:
    """|unique(pts)| over the point axis, int32 — the all-valid case of
    :func:`distinct_count_masked`."""
    lead = pts.shape[:-2] if torch.is_floating_point(pts) else pts.shape[:-1]
    P = pts.shape[len(lead)]
    return distinct_count_masked(
        pts, torch.ones(lead + (P,), dtype=torch.bool, device=pts.device))


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


def _kill_points(x: np.ndarray, alive: np.ndarray, pts: np.ndarray):
    """Remove every copy of every disputed point, on every player
    (feature rows match under ``==``, as :func:`match_points`)."""
    if x.ndim == 3:
        dead = match_points(torch.from_numpy(x), torch.from_numpy(pts))
        return alive & ~dead.numpy()
    return alive & ~np.isin(x, pts)


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


def _emit_attempt(sp, att_led: Ledger, res, q_control: int,
                  q_dispute: int) -> None:
    """Annotate a host ``attempt`` span with its per-category wire bits
    — the attempt's Theorem 4.1 ledger delta plus the quarantine
    charges — in the ``task_bits`` format ``obs.roundtrace`` sums (one
    task: everything lands on task 0)."""
    bits = obs_trace.ledger_bits(att_led)
    bits["control"] += q_control
    bits["quarantine"] += q_dispute
    sp.update(task_bits={"0": bits},
              task_rounds={"0": res.rounds + (1 if res.stuck else 0)},
              task_attempts={"0": 1},
              rounds=res.rounds, stuck=res.stuck)


def run_accurately_classify(x, y, key, cfg: BoostConfig, cls, alive=None,
                            device=None) -> ClassifyResult:
    """The host-driven outer loop (≤ opt_budget + 1 BoostAttempts) of
    one task: x [k, mloc] int32 shards or [k, mloc, F] float32 feature
    rows, y [k, mloc] int8, ``key`` [2] words, ``alive`` an optional
    initial [k, mloc] mask.  Each attempt runs on ``device`` (default
    ``cuda``); quarantine and the ledger run on the host.  Raises when
    OPT exceeds the budget, as the reference does.  Under tracing, an
    ``attempt`` span per attempt carries its wire bits and a
    ``quarantine`` span covers each quarantine."""
    dev = resolve_device(device)
    x_np, y_np = _host(x), _host(y)
    k, mloc = x_np.shape[0], x_np.shape[1]
    alive_np = (np.ones((k, mloc), bool) if alive is None
                else _host(alive).astype(bool))
    xt, yt = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    key = prng.wrap_key_data(key).to(dev)
    led = Ledger()
    dis_pts, dis_pos, dis_neg = [], [], []
    stuck_history = []
    result = None
    m_bits_m = max(int(np.ceil(np.log2(max(k * mloc, 2)))), 1)
    n = L.domain_size(cls)
    for attempt in range(cfg.opt_budget + 1):
        with obs_trace.span("attempt", "protocol", engine="host",
                            attempt=attempt) as att_sp:
            halves = prng.split(key, 2)
            key, sub = halves[0], halves[1]
            m_alive = int(alive_np.sum())
            res = boost_attempt.run_boost_attempt(
                xt, yt, torch.from_numpy(alive_np).to(dev), sub, cfg, cls,
                device=dev)
            att_led = L.boost_attempt_ledger(cfg, cls, max(m_alive, 2),
                                             res.rounds, res.stuck)
            led = led + att_led
            stuck_history.append(res.stuck)
            if not res.stuck:
                result = res
                if obs_trace.enabled():
                    _emit_attempt(att_sp, att_led, res, 0, 0)
                break
            # ---- full-point quarantine of the non-realizable coreset
            with obs_trace.span("quarantine", "protocol", attempt=attempt):
                cx = res.coreset_x.reshape((-1,) + res.coreset_x.shape[2:])
                pts = (np.unique(cx, axis=0) if cx.ndim == 2
                       else np.unique(cx))
                pos, neg = _point_counts(x_np, y_np, alive_np, pts)
                # points with no alive copy carry no label evidence:
                # they stay out of the D-table, but the broadcast
                # charged them all
                keep = (pos + neg) > 0
                dis_pts.append(pts[keep])
                dis_pos.append(pos[keep])
                dis_neg.append(neg[keep])
                alive_np = _kill_points(x_np, alive_np, pts)
                P = int(pts.shape[0])
                q_control = cfg.k * P * L.point_bits(n)       # broadcast
                q_dispute = cfg.k * P * 2 * m_bits_m          # counts up
                led.bits_control += q_control
                led.bits_dispute += q_dispute
            if obs_trace.enabled():
                _emit_attempt(att_sp, att_led, res, q_control, q_dispute)
    if result is None:
        raise RuntimeError(
            f"AccuratelyClassify exceeded opt_budget={cfg.opt_budget}; "
            "OPT is larger than the promise this run was configured for.")
    if dis_pts:
        dpts, dpos, dneg = (np.concatenate(v)
                            for v in (dis_pts, dis_pos, dis_neg))
    else:
        dpts = np.zeros((0,) + x_np.shape[2:], x_np.dtype)
        dpos = dneg = np.zeros((0,), np.int64)
    return ClassifyResult(
        hypotheses=result.hypotheses, rounds=result.rounds,
        dispute_x=dpts, dispute_y=(dpos, dneg),
        dispute_count=int(dpts.shape[0]),
        attempts=len(stuck_history), stuck_history=stuck_history,
        ledger=led)


def learn(x, y, key, cfg: BoostConfig, cls, device=None):
    """One-call API: (ResilientClassifier, ClassifyResult) of one task
    (see :func:`run_accurately_classify`)."""
    result = run_accurately_classify(x, y, key, cfg, cls, device=device)
    return make_classifier(cls, result), result


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
