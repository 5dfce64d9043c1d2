"""BoostAttempt (Figure 1): one wire round of the protocol
(counterpart of repro.core.boost_attempt, the round body).

Every player picks its ε-coreset (step 2(a)) and reports its log2
weight sum (2(b)); the center mixes the sums (2(c)) and runs weighted
ERM over the pooled coreset (2(d)); a loss above 1/100 makes the round
stuck (2(e)); otherwise each player applies the multiplicative-weights
hit update (2(f)).  The round runs for B tasks at once: the task axis
the reference ``vmap``s is written out, and the players of every task
form the rows of one ``mw_update`` launch.

Each round splits the attempt's key as the reference does (``key, kc =
split(key)``, then one key per player from ``kc``); the randomized
coreset of the feature track draws from the players' keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import approximation, prng, weights as W
from repro_torch.core.ledger import tree_comm_mode
from repro_torch.kernels.mw_update import ops as mw_ops


class _Carry(NamedTuple):
    t: torch.Tensor          # [B] int32 hypotheses produced so far
    stuck: torch.Tensor      # [B] bool
    hits: torch.Tensor       # [B, k, mloc] int32 MW state
    wsum: torch.Tensor       # [B, k] float32 Σ_alive 2^(wsum_shift − hits)
    wsum_shift: torch.Tensor  # [B, k] int32 the sum's exponent shift
    h_params: torch.Tensor   # [B, T, P] ensemble
    core_x: torch.Tensor     # [B, k, c] last round's coreset points
    core_y: torch.Tensor     # [B, k, c]
    min_loss: torch.Tensor   # [B] last center ERM loss
    key: torch.Tensor        # [B, 2] the attempt's round key (words)


def _gather_coreset(x, y, idx):
    """The coreset's points and labels, with the reference's fill for
    the out-of-range index a dead shard's sampled coreset names."""
    return (approximation.gather_fill(x, idx),
            approximation.gather_fill(y, idx))


def _center_erm(cls, cx, cy, mix, c: int):
    """Pooled-coreset ERM under the mixture D_t (steps 2(c)+(d)): every
    coreset example of player i weighs mix_i / c — computed as
    mix_i · (1/c) with the reciprocal rounded to float32, the form XLA
    rewrites the reference's division by the constant c into.  A tree
    class with a distributed ``comm_mode`` grows from the players'
    own histograms instead (``erm_players``), and there the reference's
    engine keeps the true division ``mix / c``."""
    B, k = cy.shape[:2]
    if tree_comm_mode(cls) != "coreset":
        return cls.erm_players(cx, cy, mix / float(c))
    inv_c = float(np.float32(1.0) / np.float32(c))
    w = (mix[..., None] * inv_c).expand(B, k, c).reshape(B, k * c)
    return cls.erm(cx.reshape((B, k * c) + cx.shape[3:]),
                   cy.reshape(B, k * c), w)


def _round_body(cfg, cls, x, y, alive, x_orders, y_sorted, alive_sorted,
                carry: _Carry, *, player_alive: torch.Tensor,
                active: torch.Tensor) -> _Carry:
    """One round of B tasks: x [B, k, mloc] int32 points or
    [B, k, mloc, F] float32 feature rows; y, alive [B, k, mloc];
    ``player_alive`` [B, k] the round's senders; ``active`` [B] the
    lanes whose MW state may move (finished lanes freeze).  The sorted
    views (``x_orders`` …) serve the quantile coreset and are None on
    the randomized track.

    Steps 2(f) and 2(b) run as one ``mw_update`` over all B·k player
    rows.  Its mask folds in the reference's three freezes — a stuck
    round, an absent player, a finished lane — so the new hits equal
    the reference's bit for bit, and the weight sum it returns is the
    next round's step 2(b) (alive changes only at quarantine, which
    ends the attempt, so the carried sum is never stale).  The sum is
    shifted by this round's least alive hit count, as the reference
    shifts by the row maximum of −hits, so its terms stay normal floats
    however many rounds a run takes.
    """
    c = cfg.coreset_size
    B, k, mloc = x.shape[:3]
    halves = prng.split(carry.key, 2)
    key, keys = halves[:, 0], prng.split(halves[:, 1], k)        # [B, k, 2]
    # --- players: step 2(a) coreset + step 2(b) weight sums -------------
    hmin = approximation.least_alive_hits(carry.hits, alive)      # [B, k]
    lws = W.log_wsums_from_sums(carry.wsum, hmin, carry.wsum_shift)
    idx = approximation.select_coreset(
        x, y, carry.hits, alive, c, is_quantile_track(cfg, x),
        order=x_orders, y_sorted=y_sorted, alive_sorted=alive_sorted,
        hmin=hmin, keys=keys, log_wsum=lws)
    cx, cy = _gather_coreset(x, y, idx)
    # an absent player sends nothing: −inf ⇒ mixture weight 0
    log_wsums = torch.where(player_alive, lws, -math.inf)
    mix = W.mixture_weights(log_wsums)
    # --- center: step 2(c)+(d) weighted ERM over the pooled coreset -----
    h, loss = _center_erm(cls, cx, cy, mix, c)
    stuck_now = loss > cfg.weak_threshold
    # --- players: step 2(f) multiplicative-weights update ---------------
    moves = (~stuck_now & active)[:, None, None] & player_alive[:, :, None]
    correct = (cls.predict(h, x) == y) & moves
    hits, wsum = mw_ops.mw_update(carry.hits.reshape(B * k, mloc),
                                  correct.reshape(B * k, mloc),
                                  alive.reshape(B * k, mloc),
                                  hmin.reshape(B * k))
    rows = torch.arange(B, device=x.device)
    t_idx = carry.t.clamp(max=carry.h_params.shape[1] - 1).long()
    h_params = carry.h_params.clone()
    h_params[rows, t_idx] = torch.where(stuck_now[:, None],
                                        carry.h_params[rows, t_idx], h)
    return _Carry(
        t=torch.where(stuck_now, carry.t, carry.t + 1),
        stuck=stuck_now,
        hits=hits.reshape(B, k, mloc),
        wsum=wsum.reshape(B, k),
        wsum_shift=hmin,
        h_params=h_params,
        core_x=cx, core_y=cy,
        min_loss=loss,
        key=key,
    )


def is_quantile_track(cfg, x: torch.Tensor) -> bool:
    """The deterministic quantile coreset serves the integer track
    ([B, k, mloc] points); feature rows always draw the randomized
    coreset, as in the reference."""
    return bool(cfg.deterministic_coreset) and x.ndim == 3
