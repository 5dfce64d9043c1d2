"""Bit-exact communication accounting (counterpart of
repro.core.ledger).

Theorem 4.1 charges, per BoostAttempt round: k coresets of
``coreset_size`` examples at ``⌈log2 n⌉ + 1`` bits each (step 2(a)),
k weight sums in fixed point (2(b)), one hypothesis broadcast to k
players (2(d)) and the control bits of a stuck or halting attempt
(2(e)).  The histogram trees' distributed wire modes replace the
per-round coresets with per-player histograms or votes (examples cross
the wire only on a stuck round).  ``collective_sites_per_round`` is
the census of the sharded engine's collectives, which its process-group
wire counts at every call (core/sharded_batched.py).
"""

from __future__ import annotations

import math

from repro_torch.core.types import BoostConfig, Ledger


def domain_size(cls) -> int:
    """|U| of a weak class: explicit ``n`` (integer track) or the
    2^value_bits grid of the feature track."""
    return getattr(cls, "n", 1 << getattr(cls, "value_bits", 16))


def point_bits(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def example_bits(n: int) -> int:
    return point_bits(n) + 1                       # + label


def weight_sum_bits(m: int, num_rounds: int) -> int:
    """log2 W^(i) ∈ [−T, log2 m] in fixed point with ⌈log2 m⌉
    fractional bits."""
    return math.ceil(math.log2(max(num_rounds + math.log2(max(m, 2)), 2))) \
        + math.ceil(math.log2(max(m, 2)))


def tree_comm_mode(cls) -> str:
    """The class's split-finding exchange mode ("coreset" for every
    class without one)."""
    return getattr(cls, "comm_mode", "coreset")


def hist_scalars_per_player(cls) -> int:
    """Histogram scalars one player ships per round: 2·nodes·F·Q in
    histogram mode, 2·nodes·elected·Q in voting mode."""
    mode = tree_comm_mode(cls)
    if mode == "histogram":
        return 2 * cls.nodes * cls.num_features * cls.bins
    if mode == "voting":
        return 2 * cls.nodes * cls.elected * cls.bins
    return 0


def vote_entries_per_player(cls) -> int:
    """Vote proposals one player ships per round: top-k per node."""
    if tree_comm_mode(cls) == "voting":
        return cls.nodes * cls.vote_topk
    return 0


def collective_sites_per_round(cls, *, no_center: bool = False) -> dict:
    """The collective calls ONE wire round of the sharded engine makes,
    by kind, each a charged (or control) payload of this module:

    * ``all_gather`` — coreset x, coreset y and the weight sums (3,
      charged as ``bits_coresets`` / ``bits_weight_sums``), plus the
      per-level merges of a distributed ``comm_mode`` (histogram: hw +
      hwy = 2·depth; voting: proposals + alive mask + elected hw/hwy =
      4·depth);
    * ``psum`` — the alive-example count (control traffic), plus the
      §2.2 no-center model's hypothesis/loss broadcast pair.
    """
    mode = tree_comm_mode(cls)
    all_gather = 3
    if mode == "histogram":
        all_gather += 2 * cls.depth
    elif mode == "voting":
        all_gather += 4 * cls.depth
    psum = 1
    if no_center and mode == "coreset":
        psum += 2
    return {"all_gather": all_gather, "psum": psum}


def histogram_cell_bits(m: int, num_rounds: int) -> int:
    """One histogram scalar on the wire: a weight sum's fixed point."""
    return weight_sum_bits(m, num_rounds)


def vote_entry_bits(cls, m: int, num_rounds: int) -> int:
    """One vote proposal: (feature id, bin edge, gain)."""
    return cls.feat_bits + cls.bin_bits + weight_sum_bits(m, num_rounds)


def boost_attempt_ledger(cfg: BoostConfig, cls, m: int, rounds: int,
                         stuck: bool) -> Ledger:
    """Exact bits of one BoostAttempt that produced ``rounds``
    hypotheses (plus one stuck round if ``stuck``), all players alive."""
    wire_rounds = rounds + (1 if stuck else 0)
    return boost_attempt_ledger_masked(
        cfg, cls, m, rounds, stuck, player_rounds=wire_rounds * cfg.k,
        player_h_rounds=rounds * cfg.k, players_last=cfg.k)


def boost_attempt_ledger_masked(cfg: BoostConfig, cls, m: int, rounds: int,
                                stuck: bool, player_rounds: int,
                                player_h_rounds: int,
                                players_last: int) -> Ledger:
    """:func:`boost_attempt_ledger` under a per-round player mask: only
    bits alive players sent are charged.  ``player_rounds`` sums the
    alive players over wire rounds, ``player_h_rounds`` over successful
    rounds, ``players_last`` counts them at the final wire round."""
    n = domain_size(cls)
    T = cfg.num_rounds(m)
    led = Ledger(attempts=1, rounds=rounds + (1 if stuck else 0))
    if tree_comm_mode(cls) == "coreset":
        led.bits_coresets = (player_rounds * cfg.coreset_size
                             * example_bits(n))
    else:
        # only the stuck round ships examples, from the players alive
        # at it (the attempt's final wire round)
        led.bits_coresets = (players_last * cfg.coreset_size
                             * example_bits(n) if stuck else 0)
        led.bits_histograms = (player_rounds * hist_scalars_per_player(cls)
                               * histogram_cell_bits(m, T))
        led.bits_votes = (player_rounds * vote_entries_per_player(cls)
                          * vote_entry_bits(cls, m, T))
    led.bits_weight_sums = player_rounds * weight_sum_bits(m, T)
    led.bits_hypotheses = player_h_rounds * cls.hypothesis_bits()
    led.bits_control = players_last * (1 if stuck else 0) + players_last
    return led


def theorem_41_bound(cfg: BoostConfig, cls, m: int, opt: int,
                     constant: float = 1.0) -> float:
    """O(OPT · k·log|S|·(d·log n + hyp + log|S|)) with an explicit
    constant and the coreset size standing in for O(d/ε²)."""
    n = domain_size(cls)
    logm = math.log2(max(m, 2))
    logn = math.log2(max(n, 2))
    d = cls.vc_dim
    T = cfg.num_rounds(m)
    # distributed tree growth swaps the per-round coresets for
    # histograms/votes; the bound keeps both terms
    mode_payload = (hist_scalars_per_player(cls)
                    * histogram_cell_bits(m, T)
                    + vote_entries_per_player(cls)
                    * vote_entry_bits(cls, m, T)
                    if tree_comm_mode(cls) != "coreset" else 0)
    per_attempt = cfg.k * (6 * logm + 1) * (
        cfg.coreset_size * (logn + 1) / max(d, 1) * d
        + cls.hypothesis_bits() + logm + mode_payload)
    return constant * max(opt + 1, 1) * per_attempt


def naive_baseline_bits(m: int, n: int) -> int:
    """Send-all-data baseline: every example to the center."""
    return m * example_bits(n)
