"""Adversarial noise scenarios and infrastructure faults (counterpart
of repro.core.scenarios).

The paper's guarantee E_S(f) ≤ OPT holds for any sample, however the
noise is placed and however the shards are split; this module plants
the adversaries that test it.  Noise adversaries (:data:`SCENARIOS`)
flip labels — uniformly, on the most duplicated points
(``targeted_heavy``), a whole player's shard (``byzantine``), nearest
the target's boundary (``boundary``) or in waves across the domain
(``drift``).  Feature concepts (:data:`FEATURE_SCENARIOS`) plant a tree
that single-feature classes cannot fit.  Infrastructure adversaries
(:class:`InfraSpec`) silence a player per round: the engine's
``player_sched``.

Task construction is numpy, copied from the reference so the same
seeds give identical arrays; labels of planted concepts come from the
port's ``predict``.  The reports hold each finished task to the
guarantee: :func:`scenario_report` over the whole sample,
:func:`infra_report` over the surviving shards.  OPT comes from
:func:`tasks.opt_counts`, for axis stumps from one launch of the stump
kernel for all tasks (:func:`scenario_reports`, :func:`infra_reports`).
The point-set helpers match feature rows by sorting them, not by the
reference's m × m compare, which does not fit memory at m = 2^16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import classify, tasks, weak
from repro_torch.device import resolve_device

SCENARIOS = ("clean", "uniform", "targeted_heavy", "byzantine",
             "boundary", "drift")
INFRA = ("none", "dropout", "flaky", "rejoin")

# Multi-feature concept families (planted ground truth, not a
# corruptor): the sample is labelled by a tree-expressible concept that
# single-feature classes provably cannot fit — XOR of two off-centre
# half-planes, a cells×cells checkerboard, alternating axis-aligned
# bands.  Any noise adversary above composes on top (``noise_kind``).
FEATURE_SCENARIOS = ("xor", "checkerboard", "bands")


def _x1d(x: np.ndarray) -> np.ndarray:
    """The 1-D sort key of the domain points ([k·mloc] flat)."""
    flat = x.reshape((-1,) + x.shape[2:])
    return flat if flat.ndim == 1 else flat[:, 0]


def _corrupt_uniform(rng, x, y, noise, params, cls):
    m = y.size
    flip = np.zeros(m, bool)
    if noise > 0:
        flip[rng.choice(m, size=min(noise, m), replace=False)] = True
    return flip


def _corrupt_targeted_heavy(rng, x, y, noise, params, cls):
    """One flipped copy of each of the ``noise`` heaviest points.

    Heaviness is multiplicity of the FULL point (whole feature row on
    the feature track), because the adversary's power here is exactly
    the hard-core mass a flipped copy creates: a point with a single
    copy yields no contradiction.  A continuous sample has no
    duplicates, so this adversary cannot materialise there — refuse
    loudly instead of silently degrading to arbitrary flips.
    """
    flat = x.reshape((-1,) + x.shape[2:])
    if flat.ndim == 2:
        _, first_idx, counts = np.unique(flat, axis=0, return_index=True,
                                         return_counts=True)
        keys = np.arange(first_idx.size)
    else:
        keys, first_idx, counts = np.unique(flat, return_index=True,
                                            return_counts=True)
    if noise > 0 and counts.max(initial=0) < 2:
        raise ValueError(
            "targeted_heavy needs duplicated points to corrupt (its "
            "flips must contradict surviving copies); this sample has "
            "none — use a discrete domain or another scenario")
    # heaviest first; ties broken by value so the choice is deterministic
    order = np.lexsort((keys, -counts))
    flip = np.zeros(y.size, bool)
    flip[first_idx[order[:min(noise, first_idx.size)]]] = True
    return flip


def _corrupt_boundary(rng, x, y, noise, params, cls):
    """Flips at the ``noise`` points nearest the target's boundary."""
    xf = _x1d(x).astype(np.float64)
    t, a, b = float(params[0]), float(params[1]), float(params[2])
    if t == 3.0:                               # interval: both endpoints
        dist = np.minimum(np.abs(xf - a), np.abs(xf - b))
    elif t == 4.0:                             # stump: feature a, theta b
        feat = x.reshape((-1,) + x.shape[2:])[:, int(a)].astype(np.float64)
        dist = np.abs(feat - b)
    elif t == 5.0:                             # tree: nearest node cut
        flat = x.reshape((-1,) + x.shape[2:]).astype(np.float64)
        ni, Q = cls.nodes, cls.bins
        feats = params[1:1 + ni].astype(np.int64)
        qbins = params[1 + ni:1 + 2 * ni]
        dist = np.full(flat.shape[0], np.inf)
        for f, q in zip(feats, qbins):
            if q > 0:                          # skip degenerate splits
                dist = np.minimum(dist, np.abs(flat[:, f] - q / Q))
    else:                                      # threshold / singleton: a
        dist = np.abs(xf - a)
    flip = np.zeros(y.size, bool)
    flip[np.argsort(dist, kind="stable")[:min(noise, y.size)]] = True
    return flip


def _corrupt_drift(rng, x, y, noise, params, cls, waves: int = 4):
    """noise flips split across ``waves`` disjoint domain regions."""
    m = y.size
    order = np.argsort(_x1d(x), kind="stable")
    flip = np.zeros(m, bool)
    waves = max(min(waves, noise if noise else 1, m), 1)
    bounds = np.linspace(0, m, waves + 1).astype(np.int64)
    per = [noise // waves + (1 if g < noise % waves else 0)
           for g in range(waves)]
    for g in range(waves):
        seg = order[bounds[g]:bounds[g + 1]]
        take = min(per[g], seg.size)
        if take > 0:
            flip[rng.choice(seg, size=take, replace=False)] = True
    return flip


_CORRUPTORS = {
    "uniform": _corrupt_uniform,
    "targeted_heavy": _corrupt_targeted_heavy,
    "boundary": _corrupt_boundary,
    "drift": _corrupt_drift,
}


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A named adversary with its knobs (hashable, so batch constructors can
    key jit caches on it).

    ``name`` is either a noise adversary (:data:`SCENARIOS`) applied to
    a class-labelled task, or a planted multi-feature concept
    (:data:`FEATURE_SCENARIOS`); for the latter ``noise_kind`` picks
    which noise adversary corrupts the planted sample on top (the
    feature families and the corruptors compose, they don't compete).
    """

    name: str
    noise: int = 0
    byzantine_player: int = 0
    waves: int = 4
    # feature-family knobs
    noise_kind: str = "uniform"  # corruptor composed over a planted task
    cells: int = 4               # checkerboard strips per axis (2^j)
    n_bands: int = 4             # bands count (2^j)

    def __post_init__(self):
        if self.name not in SCENARIOS + FEATURE_SCENARIOS:
            raise ValueError(
                f"unknown scenario {self.name!r}; pick from "
                f"{SCENARIOS + FEATURE_SCENARIOS}")
        if self.name in FEATURE_SCENARIOS:
            if self.noise_kind not in _CORRUPTORS:
                raise ValueError(
                    f"noise_kind {self.noise_kind!r} must be one of "
                    f"{tuple(_CORRUPTORS)}")
            for v, what in ((self.cells, "cells"),
                            (self.n_bands, "n_bands")):
                if v < 2 or v & (v - 1):
                    raise ValueError(
                        f"{what} must be a power of two ≥ 2, got {v}")

    def min_tree_depth(self) -> int:
        """Tree depth this scenario is DESIGNED for (FEATURE_SCENARIOS
        only) — CLI entry points validate against it up front instead
        of failing (or silently plateauing) deep inside a run.  For
        ``bands`` this is the greedy peel-chain depth n_bands−1, not
        the balanced representability depth log2(n_bands): greedy
        grows the chain, and a shallower class predictably leaves an
        impure leaf (see the comment where bands are planted)."""
        if self.name == "xor":
            return 2
        if self.name == "checkerboard":
            return 2 * (self.cells.bit_length() - 1)
        if self.name == "bands":
            return max(self.n_bands - 1, 1)
        raise ValueError(f"{self.name!r} plants no tree concept")


def corrupt_task(task: tasks.Task, spec: ScenarioSpec,
                 seed: int = 0) -> tasks.Task:
    """Apply a scenario to a CLEAN task; returns a new Task whose
    ``flipped`` mask marks exactly the corrupted examples."""
    y = np.array(task.y)
    k, mloc = y.shape
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5CE7A]))
    if spec.name == "clean":
        flip = np.zeros(y.size, bool)
    elif spec.name == "byzantine":
        j = spec.byzantine_player % k
        flip = np.zeros((k, mloc), bool)
        flip[j] = True
        flip = flip.reshape(-1)
    else:
        flip = _CORRUPTORS[spec.name](
            rng, task.x, y.reshape(-1), spec.noise, task.target_params,
            task.cls, **({"waves": spec.waves} if spec.name == "drift"
                         else {}))
    yf = y.reshape(-1)
    yf[flip] = -yf[flip]
    return dataclasses.replace(
        task, y=yf.reshape(k, mloc).astype(np.int8),
        noise_count=int(flip.sum()), flipped=flip.reshape(k, mloc),
        scenario=spec.name)


# ---------------------------------------------------------------------------
# Multi-feature concept families (planted trees — the workloads stumps
# provably cannot fit).
# ---------------------------------------------------------------------------

def _bst_cut_levels(cuts) -> list:
    """Sorted interior cuts [2^j − 1] → per-level cut lists of the
    balanced BST over them (level i holds 2^i cuts).  A leaf's path
    bits, read as a binary number (right = 1), are its strip index —
    the in-order property the leaf labelling below relies on."""
    cuts = list(cuts)
    j = (len(cuts) + 1).bit_length() - 1
    assert (1 << j) == len(cuts) + 1, "cuts must number 2^j − 1"
    return [[cuts[(2 * t + 1) * (1 << (j - 1 - i)) - 1]
             for t in range(1 << i)] for i in range(j)]


def _require_distinct_cuts(cuts: np.ndarray, what: str,
                           Q: int) -> np.ndarray:
    """Planted cuts must be strictly increasing interior bins — a
    collision means a strip/band vanished and the concept is silently
    NOT what was requested.  Refuse loudly: the fix is more bins (or
    fewer cells/bands), not a degenerate plant."""
    if not (np.all(np.diff(cuts) > 0) and cuts[0] >= 1
            and cuts[-1] <= Q - 1):
        raise ValueError(
            f"{what}: cannot plant {len(cuts) + 1} distinct strips on "
            f"a {Q}-bin grid (cuts {cuts.tolist()} collide) — raise "
            "tree_bins or lower cells/n_bands")
    return cuts


def _uneven_cuts(rng, Q: int, parts: int) -> np.ndarray:
    """parts−1 interior cut bins, deliberately OFF the even grid.

    Greedy split finding needs gain at the true boundaries: a perfectly
    even partition makes interior cuts gain-free at the root (mass
    balances) and greedy degenerates.  Even spacing plus a nonzero
    jitter of ≤ ¼ strip keeps every strip alive while making each cut's
    two sides unbalanced.
    """
    step = Q // parts
    base = np.arange(1, parts) * step
    mag = max(step // 4, 1)
    jit = rng.integers(1, mag + 1, size=parts - 1) \
        * rng.choice([-1, 1], size=parts - 1)
    return _require_distinct_cuts(
        np.clip(base + jit, 1, Q - 1), f"checkerboard×{parts}", Q)


def _plant_tree(cls, levels: list, leaf_of_path) -> np.ndarray:
    """Encode a concept as params of ``cls`` (HistogramTrees).

    ``levels[i]`` is the list of (feature, qbin) of level i's 2^i
    nodes; depths below ``len(levels)`` pad with degenerate qbin = 0
    splits (everything routes right), and every leaf takes the value of
    its first len(levels) path bits — so the padded tree computes the
    same function at any ``cls.depth ≥ len(levels)``.
    """
    d0, D = len(levels), cls.depth
    if D < d0:
        raise ValueError(
            f"concept needs depth ≥ {d0}, class has {D}")
    feats = np.zeros(cls.nodes, np.int64)
    qbins = np.zeros(cls.nodes, np.int64)
    for lv in range(d0):
        for i, (f, q) in enumerate(levels[lv]):
            feats[(1 << lv) - 1 + i] = f
            qbins[(1 << lv) - 1 + i] = q
    signs = np.array([leaf_of_path(leaf >> (D - d0))
                      for leaf in range(cls.leaves)], np.float32)
    return cls.pack_params(feats, qbins, signs)


def _plant_feature_concept(cls, spec: ScenarioSpec, rng) -> np.ndarray:
    """The planted tree of a FEATURE_SCENARIOS member, over cls's grid."""
    Q, F = cls.bins, cls.num_features
    s0 = float(rng.choice([-1.0, 1.0]))
    if spec.name == "xor":
        # two half-plane cuts, off-centre on opposite sides by
        # [Q/8, 3Q/16]: greedy's root gain is proportional to the
        # offset (a centred XOR has a flat gain surface and greedy
        # degenerates), while the best-stump error is ≈ the smaller cut
        # mass — capping the offset at 3Q/16 keeps it ≥ 5/16 > 0.25,
        # the separation the trees-vs-stumps tests pin
        f1, f2 = rng.choice(F, size=2, replace=False)
        qa = int(rng.integers(5 * Q // 16, 3 * Q // 8 + 1))
        qb = int(rng.integers(5 * Q // 8, 11 * Q // 16 + 1))
        levels = [[(f1, qa)], [(f2, qb), (f2, qb)]]
        return _plant_tree(
            cls, levels,
            lambda p: s0 * (1.0 if (p >> 1) != (p & 1) else -1.0))
    if spec.name == "checkerboard":
        c = spec.cells
        j = c.bit_length() - 1
        f1, f2 = rng.choice(F, size=2, replace=False)
        lv1 = _bst_cut_levels(_uneven_cuts(rng, Q, c))
        lv2 = _bst_cut_levels(_uneven_cuts(rng, Q, c))
        levels = [[(f1, q) for q in lv1[i]] for i in range(j)]
        levels += [[(f2, lv2[i][idx % (1 << i)])
                    for idx in range(1 << (j + i))] for i in range(j)]
        return _plant_tree(
            cls, levels,
            lambda p: s0 * (1.0 if ((p >> j) + (p & ((1 << j) - 1)))
                            % 2 == 0 else -1.0))
    # bands: alternating-sign intervals of one feature, widths strictly
    # DECREASING.  Alternation defeats stumps (min-side error stays a
    # band mass) and, with equal widths, also defeats 1-step greedy
    # (every cut of a −+− region scores the middle band — a flat gain
    # surface).  Decreasing masses restore a strict greedy gradient:
    # peeling the widest end band wins at every level, so a depth ≥
    # n_bands−1 tree grows the exact peel chain (the planted tree
    # itself is the balanced depth-log2(n_bands) form).
    b = spec.n_bands
    j = b.bit_length() - 1
    f1 = int(rng.integers(F))
    widths = np.power(0.62, np.arange(b))
    cuts = np.round(np.cumsum(widths / widths.sum())[:-1] * Q)
    cuts = np.clip(cuts.astype(np.int64)
                   + rng.integers(-1, 2, size=b - 1), 1, Q - 1)
    cuts = _require_distinct_cuts(cuts, f"bands×{b}", Q)
    lv = _bst_cut_levels(cuts)
    levels = [[(f1, lv[i][idx % (1 << i)]) for idx in range(1 << i)]
              for i in range(j)]
    return _plant_tree(
        cls, levels, lambda p: s0 * (1.0 if p % 2 == 0 else -1.0))


def make_feature_task(cls, m: int, k: int, spec: ScenarioSpec,
                      seed: int = 0,
                      adversarial_split: bool = True) -> tasks.Task:
    """A planted multi-feature task: grid-snapped uniform points of
    [0, 1)^F labelled by the scenario's tree concept, adversarially
    split, then corrupted by ``spec.noise_kind`` (``spec.noise`` flips
    — the planted tree labels all of them wrong, so OPT ≤ noise with
    the concept itself as witness; see :func:`planted_errors`)."""
    if not hasattr(cls, "pack_params"):
        raise ValueError(
            f"{spec.name!r} plants a tree concept and needs a "
            f"HistogramTrees class, got {type(cls).__name__} (run other "
            "classes on these tasks via class_floor for comparison)")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xFEA7]))
    x = cls.sample_points(rng, m)
    params = _plant_feature_concept(cls, spec, rng)
    y = cls.predict(torch.from_numpy(params),
                    torch.from_numpy(x)).numpy().astype(np.int8)
    xs, ys = tasks._split(rng, x, y, k, adversarial_split)
    task = tasks.Task(x=xs, y=ys, target_params=params, noise_count=0,
                      cls=cls, flipped=np.zeros((k, m // k), bool),
                      scenario=spec.name)
    if spec.noise > 0:
        # every corruptor knob rides along (byzantine_player is inert
        # today — noise_kind can't name byzantine — but forgetting it
        # here would silently target player 0 if that ever changes)
        task = corrupt_task(
            task, ScenarioSpec(name=spec.noise_kind, noise=spec.noise,
                               waves=spec.waves,
                               byzantine_player=spec.byzantine_player),
            seed=seed)
        task = dataclasses.replace(
            task, target_params=params,
            scenario=f"{spec.name}+{spec.noise_kind}")
    return task


def planted_errors(task: tasks.Task, device=None) -> int:
    """Errors of the PLANTED concept on the (corrupted) sample — an
    in-class witness, so true OPT ≤ this (= noise_count when every flip
    lands on a distinct point).  The greedy tree ERM floor
    (:func:`class_floor`) can sit above true OPT; this cannot."""
    device = resolve_device(device)
    pred = task.cls.predict(
        torch.as_tensor(task.target_params, device=device),
        torch.as_tensor(task.flat_x, device=device))
    return int(weak.empirical_errors(
        pred, torch.as_tensor(task.flat_y, device=device)))


def class_floor(task: tasks.Task, cls=None, device=None) -> int:
    """Best full-sample uniform-weight error count ``cls`` reaches on
    the task (default: the task's own class) — exact OPT for the
    closed-form 1-D classes and stumps (the stump kernel's counts), the
    greedy floor for trees (:func:`tasks.opt_counts`)."""
    cls = task.cls if cls is None else cls
    return int(tasks.opt_counts(cls, task.flat_x[None], task.flat_y[None],
                                device)[0])


def make_scenario_task(cls, m: int, k: int, spec: ScenarioSpec,
                       seed: int = 0,
                       adversarial_split: bool = True) -> tasks.Task:
    """Clean task from ``tasks.make_task`` (identical x/target streams),
    then scenario corruption on the split arrays; FEATURE_SCENARIOS
    route to :func:`make_feature_task` (planted concept + composed
    noise) instead."""
    if spec.name in FEATURE_SCENARIOS:
        return make_feature_task(cls, m=m, k=k, spec=spec, seed=seed,
                                 adversarial_split=adversarial_split)
    base = tasks.make_task(cls, m=m, k=k, noise=0, seed=seed,
                           adversarial_split=adversarial_split)
    return corrupt_task(base, spec, seed=seed)


def make_scenario_batch(cls, B: int, m: int, k: int, spec: ScenarioSpec,
                        seed0: int = 0, adversarial_split: bool = True):
    """B corrupted tasks stacked for the batched/sharded engines."""
    ts = [make_scenario_task(cls, m=m, k=k, spec=spec, seed=seed0 + b,
                             adversarial_split=adversarial_split)
          for b in range(B)]
    return (np.stack([t.x for t in ts]), np.stack([t.y for t in ts]),
            ts)


# ---------------------------------------------------------------------------
# Infrastructure adversaries: per-round player-alive schedules.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InfraSpec:
    """A named infrastructure adversary with its knobs (hashable).

    The schedule row at wire round ``min(step, R−1)`` is the round's
    player mask — the final row extends forever, so ``dropout`` ends on
    a dead row and ``flaky``/``rejoin`` end on a live one.
    """

    name: str = "none"
    player: int = 0              # the targeted player
    drop_round: int = 6          # dropout/rejoin: first absent round
    rejoin_round: int = 18       # rejoin: first round back
    miss_rate: float = 0.3       # flaky: per-round absence probability
    horizon: int = 64            # flaky: schedule rows drawn

    def __post_init__(self):
        if self.name not in INFRA:
            raise ValueError(
                f"unknown infra adversary {self.name!r}; pick from {INFRA}")
        if self.name == "rejoin" and self.rejoin_round <= self.drop_round:
            raise ValueError("rejoin_round must exceed drop_round")

    def schedule(self, k: int, seed: int = 0) -> np.ndarray:
        """The ``[R, k]`` bool player_alive schedule this adversary
        induces.  Every row keeps ≥ 1 player alive (k ≥ 2 required for
        any adversary that silences a player)."""
        if self.name == "none":
            return np.ones((1, k), bool)
        if k < 2:
            raise ValueError(f"{self.name} needs k ≥ 2 players")
        j = self.player % k
        if self.name == "dropout":
            sched = np.ones((self.drop_round + 1, k), bool)
            sched[self.drop_round:, j] = False
        elif self.name == "rejoin":
            sched = np.ones((self.rejoin_round + 1, k), bool)
            sched[self.drop_round:self.rejoin_round, j] = False
        else:                                           # flaky
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, 0xF1A2]))
            sched = np.ones((self.horizon, k), bool)
            sched[:, j] = rng.random(self.horizon) >= self.miss_rate
            sched[-1, j] = True        # always returns eventually
        assert sched.any(axis=-1).all()
        return sched

    def survivors(self, k: int, seed: int = 0) -> np.ndarray:
        """[k] bool — players alive at the schedule's horizon (its
        final, forever-repeating row): the shard set the E_S(f) ≤ OPT
        guarantee is pinned over."""
        return self.schedule(k, seed=seed)[-1]


def _opts(cls, xs, ys, device) -> list[int]:
    """OPT of every stacked sample, one :func:`tasks.opt_counts` call."""
    if not xs:
        return []
    return [int(v) for v in tasks.opt_counts(cls, np.stack(xs),
                                             np.stack(ys), device)]


def _errors(f, x, y, device) -> int:
    return int(weak.empirical_errors(f(torch.as_tensor(x, device=device)),
                                     torch.as_tensor(y, device=device)))


def _survivor_sample(task: tasks.Task, surv: np.ndarray):
    xs = task.x[surv].reshape((-1,) + task.x.shape[2:])
    return xs, task.y[surv].reshape(-1)


def infra_report(task: tasks.Task, result, b: int, spec: InfraSpec,
                 seed: int = 0, device=None) -> dict:
    """Guarantee stats of one fault-injected task, over the shards of
    surviving players only: E_S(f) vs OPT restricted to those shards,
    with the dispute vote counting surviving copies."""
    return _infra_reports([task], result, [b], spec, seed, device)[0]


def infra_reports(ts, result, spec: InfraSpec, seed: int = 0,
                  device=None) -> list[dict]:
    """:func:`infra_report` of every finished task, in task order; their
    survivor OPTs come from one :func:`tasks.opt_counts` call (one stump
    launch for axis stumps)."""
    done = [b for b in range(len(ts)) if result.ok[b]]
    return _infra_reports([ts[b] for b in done], result, done, spec, seed,
                          device)


def _infra_reports(ts, result, lanes, spec, seed, device) -> list[dict]:
    device = resolve_device(device)
    if not ts:
        return []
    surv = spec.survivors(ts[0].y.shape[0], seed=seed)
    samples = [_survivor_sample(t, surv) for t in ts]
    opts = _opts(ts[0].cls, [s[0] for s in samples],
                 [s[1] for s in samples], device)
    out = []
    for task, b, (xs, ys), opt in zip(ts, lanes, samples, opts):
        res = result.per_task(b, player_mask=surv)
        errs = _errors(classify.make_classifier(task.cls, res), xs, ys,
                       device)
        out.append({
            "infra": spec.name,
            "survivors": int(surv.sum()),
            "errors": errs,
            "opt": opt,
            "guarantee_ok": errs <= opt,
            "attempts": res.attempts,
            "disputed": int(res.dispute_count),
            "bits": res.ledger.total_bits,
        })
    return out


# ---------------------------------------------------------------------------
# Ground-truth helpers for the guarantee tests / serving stats.
# ---------------------------------------------------------------------------

def planted_points(task: tasks.Task) -> np.ndarray:
    """Unique domain points whose labels the scenario corrupted."""
    if task.flipped is None or not task.flipped.any():
        return np.zeros((0,) + tuple(task.x.shape[2:]), task.x.dtype)
    flat = task.flat_x
    sel = task.flipped.reshape(-1)
    return (np.unique(flat[sel], axis=0) if flat.ndim == 2
            else np.unique(flat[sel]))


def _row_ids(pts: np.ndarray, x=None):
    """:func:`classify._row_ids` on host rows: (ids of ``pts`` — equal
    rows share one below len(pts), a row holding a NaN gets one of its
    own — and, for rows ``x``, the id of an equal row of pts or −1)."""
    pid, xid = classify._row_ids(
        torch.from_numpy(pts), torch.ones(pts.shape[0], dtype=torch.bool),
        None if x is None else torch.from_numpy(x))
    return pid.numpy(), None if xid is None else xid.numpy()


def contradicted_points(task: tasks.Task) -> np.ndarray:
    """Points carrying BOTH labels in S — the sub-multiset no classifier
    can be consistent with (each contributes ≥ min(n₊, n₋) to OPT)."""
    xf, yf = task.flat_x, task.flat_y
    if xf.ndim == 2:                     # feature rows, by sorted ids
        ids = _row_ids(xf)[0]
        pos = np.bincount(ids[yf > 0], minlength=2 * ids.size) > 0
        neg = np.bincount(ids[yf < 0], minlength=2 * ids.size) > 0
        pts = xf[(pos & neg)[ids]]
        return np.unique(pts, axis=0) if pts.size else pts
    vals = np.unique(xf)
    pos = np.isin(vals, xf[yf > 0])
    neg = np.isin(vals, xf[yf < 0])
    return vals[pos & neg]


def quarantine_recall(dispute_x: np.ndarray, target_pts: np.ndarray,
                      ) -> float:
    """Fraction of the target point set that ended up quarantined."""
    tgt = np.asarray(target_pts)
    if tgt.shape[0] == 0:
        return 1.0
    dis = np.asarray(dispute_x)
    if tgt.ndim == 2:
        if dis.shape[0]:
            hit = _row_ids(np.ascontiguousarray(dis, tgt.dtype),
                           np.ascontiguousarray(tgt))[1] >= 0
        else:
            hit = np.zeros(tgt.shape[0], bool)
    else:
        hit = np.isin(tgt, dis)
    return float(hit.mean())


def scenario_report(task: tasks.Task, result, b: int | None = None,
                    device=None) -> dict:
    """Guarantee stats of one solved task: E_S(f) vs OPT, quarantine
    recall on contradicted/planted points.  ``result`` is a batched
    result with lane b, or a ClassifyResult when b is None."""
    res = result.per_task(b) if b is not None else result
    return _scenario_reports([task], [res], device)[0]


def scenario_reports(ts, result, device=None) -> list[dict]:
    """:func:`scenario_report` of every finished task, in task order;
    their OPTs come from one :func:`tasks.opt_counts` call (one stump
    launch for axis stumps)."""
    done = [b for b in range(len(ts)) if result.ok[b]]
    return _scenario_reports([ts[b] for b in done],
                             [result.per_task(b) for b in done], device)


def _scenario_reports(ts, results, device) -> list[dict]:
    device = resolve_device(device)
    if not ts:
        return []
    opts = _opts(ts[0].cls, [t.flat_x for t in ts], [t.flat_y for t in ts],
                 device)
    out = []
    for task, res, opt in zip(ts, results, opts):
        f = classify.make_classifier(task.cls, res)
        errs = _errors(f, task.flat_x, task.flat_y, device)
        contr = contradicted_points(task)
        out.append({
            "scenario": task.scenario,
            "errors": errs,
            "opt": opt,
            "guarantee_ok": errs <= opt,
            "attempts": res.attempts,
            "disputed": int(res.dispute_count),
            "contradicted": int(contr.shape[0]),
            "recall_contradicted": quarantine_recall(
                np.asarray(res.dispute_x), contr),
            "recall_planted": quarantine_recall(
                np.asarray(res.dispute_x), planted_points(task)),
            "bits": res.ledger.total_bits,
        })
    return out
