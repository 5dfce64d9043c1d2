"""Resilient boosting as a neural training feature — the port of
``repro.core.resilient``.

The deep-learning transliteration of AccuratelyClassify:

* per-example multiplicative weights over the training corpus: an
  example's weight halves whenever the model handles it well
  (per-example NLL at most the batch median), mirroring
  W·2^{−1[h(x)=y]};
* the hard-core check: the coreset of the heaviest alive examples, if
  its weight has concentrated and its loss EMA stays far above the
  corpus level, is unfit for the model family and is quarantined (the
  dispute set D), removed from the loss as the paper removes the
  non-realizable S'.

The bookkeeping stays on the host in numpy, as in the reference (the
same arrays and the same numpy calls, so the same NLL stream gives the
same hits, alive set and quarantine history); the per-example NLL comes
back from the device once a step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ResilientConfig:
    num_examples: int
    coreset_size: int = 64          # per check, per shard
    check_every: int = 50           # steps between hard-core checks
    nll_threshold: float = 0.0      # 0 ⇒ adaptive (median + 2·MAD)
    min_ratio: float = 1.75         # coreset must be ≥ ratio × corpus level
    min_hits_gap: int = 4           # weight ratio 2^gap ⇒ "concentrated"
    mw_loss_weighting: bool = False  # apply MW weights to the loss (the
                                    # bookkeeping for quarantine always
                                    # runs); OFF by default — measured:
                                    # even capped weighting costs clean
                                    # eval at small scale, quarantine
                                    # alone is the win
    mw_cap_bits: int = 3            # SmoothBoost-style cap: batch weight
                                    # ratio ≤ 2^cap (unbounded MW skew
                                    # measurably hurts clean-eval loss —
                                    # the same fix the paper's cited
                                    # Chen–Balcan–Chau baseline uses)
    mw_enabled: bool = True
    quarantine_enabled: bool = True


@dataclasses.dataclass
class ResilientState:
    hits: np.ndarray                # [N] int32 — −log2 of MW weight
    alive: np.ndarray               # [N] bool
    nll_ema: np.ndarray             # [N] float32 — per-example loss EMA
    seen: np.ndarray                # [N] int32
    quarantined_at: list


def init_state(cfg: ResilientConfig) -> ResilientState:
    N = cfg.num_examples
    return ResilientState(
        hits=np.zeros(N, np.int32),
        alive=np.ones(N, bool),
        nll_ema=np.zeros(N, np.float32),
        seen=np.zeros(N, np.int32),
        quarantined_at=[],
    )


def batch_weights(state: ResilientState, ids: np.ndarray,
                  cfg: ResilientConfig, device=None):
    """MW weights + alive mask for a batch.

    The weights are SmoothBoost-cap-clipped relative MW weights, NOT
    normalized: ``w = 2^{clip(h_min − h, −cfg.mw_cap_bits, 0)}``, so the
    batch's lightest-hit example gets weight exactly 1, every other
    weight lies in ``[2^{−cap}, 1]`` (the cap bounds the skew the MW
    distribution can impose on a step), and the sum is whatever it is —
    the training loss divides by the weight sum itself.  With MW
    weighting disabled, all-ones.  ``alive`` is the quarantine mask as
    float (0 = quarantined, excluded from the loss).  Both are float32
    tensors on ``device`` (``cuda`` unless the caller asks for the CPU).
    """
    ids = np.asarray(ids)
    if not (cfg.mw_enabled and cfg.mw_loss_weighting):
        w = np.ones(ids.shape, np.float32)
    else:
        h = state.hits[ids].astype(np.float32)
        w = np.exp2(np.clip(h.min() - h, -float(cfg.mw_cap_bits), 0.0))
    alive = state.alive[ids].astype(np.float32)
    dev = resolve_device(device)
    return (torch.from_numpy(np.asarray(w, np.float32)).to(dev),
            torch.from_numpy(alive).to(dev))


def update(state: ResilientState, ids, per_example_nll,
           cfg: ResilientConfig, step: int) -> ResilientState:
    """Post-step MW update + (periodically) the hard-core quarantine.

    Duplicate-safe: when ``ids`` repeats an id (sampling with
    replacement), every occurrence counts — hits accumulate via
    ``np.add.at`` (fancy-index ``+=`` silently dropped all but one
    increment) and the loss EMA folds the occurrences sequentially in
    batch order (plain ``nll_ema[ids] =`` was last-write-wins).
    """
    ids = np.asarray(ids)
    if torch.is_tensor(per_example_nll):
        per_example_nll = per_example_nll.detach().cpu().numpy()
    nll = np.asarray(per_example_nll, np.float32)
    # EMA of the example's loss
    if np.unique(ids).size == ids.size:
        # no duplicates: the vectorized fold is exact
        seen = state.seen[ids]
        ema = state.nll_ema[ids]
        alpha = np.where(seen == 0, 1.0, 0.3).astype(np.float32)
        state.nll_ema[ids] = (1 - alpha) * ema + alpha * nll
        state.seen[ids] = seen + 1
    else:
        for j in range(ids.size):          # sequential, duplicate-aware
            i = ids[j]
            a = np.float32(1.0 if state.seen[i] == 0 else 0.3)
            state.nll_ema[i] = (1 - a) * state.nll_ema[i] + a * nll[j]
            state.seen[i] += 1
    if cfg.mw_enabled:
        # "correct" analog: the model fits this example better than the
        # batch median ⇒ halve its weight (hits += 1)
        med = np.median(nll)
        np.add.at(state.hits, ids, (nll <= med).astype(np.int32))
    if cfg.quarantine_enabled and step > 0 and step % cfg.check_every == 0:
        _hard_core_check(state, cfg, step)
    return state


def _hard_core_check(state: ResilientState, cfg: ResilientConfig,
                     step: int) -> None:
    """Quarantine the coreset if it is provably hard.

    The MW dynamics concentrate weight on examples the model keeps
    getting wrong.  The coreset = the ``coreset_size`` heaviest alive
    examples.  If, despite the boosting pressure, the model's loss EMA
    on them is far above the corpus level (median + 2·MAD by default),
    no member of the family fits them — quarantine (dispute set).
    """
    alive_idx = np.where(state.alive & (state.seen > 0))[0]
    if alive_idx.size < 4 * cfg.coreset_size:
        return
    hits = state.hits[alive_idx]
    order = np.argsort(hits, kind="stable")       # fewest hits = heaviest
    coreset = alive_idx[order[:cfg.coreset_size]]
    rest = alive_idx[order[cfg.coreset_size:]]
    gap = np.median(state.hits[rest]) - np.median(state.hits[coreset])
    if gap < cfg.min_hits_gap:
        return                                    # weight not concentrated
    if cfg.nll_threshold > 0:
        thr = cfg.nll_threshold
    else:
        # adaptive: clearly above the fit-table corpus level, BOTH in
        # spread (median + 2·MAD) and in ratio (≥ min_ratio×median) —
        # the ratio floor stops the check from eating hard-but-learnable
        # examples once all actual noise is gone.
        lvl = state.nll_ema[rest]
        med = np.median(lvl)
        mad = np.median(np.abs(lvl - med)) + 1e-6
        thr = max(med + 2.0 * mad, cfg.min_ratio * med)
    hard = coreset[state.nll_ema[coreset] > thr]
    if hard.size:
        state.alive[hard] = False
        state.hits[hard] = 0
        state.quarantined_at.append((step, hard.copy()))


def quarantine_stats(state: ResilientState, noisy_ids=None) -> dict:
    q = ~state.alive
    out = {"quarantined": int(q.sum()),
           "alive": int(state.alive.sum())}
    if noisy_ids is not None:
        noisy = np.zeros_like(q)
        noisy[np.asarray(noisy_ids)] = True
        tp = int((q & noisy).sum())
        out.update(
            noise_recall=tp / max(int(noisy.sum()), 1),
            noise_precision=tp / max(int(q.sum()), 1),
        )
    return out
