"""Core dataclasses of the protocol (counterpart of repro.core.types).

Terminology follows the paper (Filmus–Mehalel–Moran, ICML 2022): ``k``
players, ``m = |S|`` examples, domain ``[0, n)``, ``OPT`` the errors of
the best hypothesis, and the coreset each player sends per round.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import fp32

# The paper's constants (Figure 1 / Theorem 3.1).
EPS_APPROX = 1.0 / 100.0
WEAK_EDGE_THRESHOLD = 1.0 / 100.0
ADABOOST_ROUNDS_FACTOR = 6


@dataclasses.dataclass(frozen=True)
class BoostConfig:
    """Static configuration of the protocol (the reference's fields).
    ``chunk_size`` sorts each player's shard in tiles of that many
    points merged by ranks (``streaming.sort_order``): the same order
    bit for bit, so every protocol output is unchanged."""

    k: int
    coreset_size: int = 256
    domain_size: int = 1 << 16
    rounds_factor: int = ADABOOST_ROUNDS_FACTOR
    weak_threshold: float = WEAK_EDGE_THRESHOLD
    opt_budget: int = 64
    deterministic_coreset: bool = True
    seed: int = 0
    chunk_size: int | None = None

    def num_rounds(self, m: int) -> int:
        """T = ceil(6·log2 |S|), in float32 as the reference's host
        path computes it (``repro.core.types.BoostConfig.num_rounds``)."""
        m = torch.tensor([max(int(m), 2)], dtype=torch.float32)
        return int(fp32.num_rounds(self.rounds_factor, m, traced=False))


@dataclasses.dataclass
class BoostAttemptResult:
    """Output of one BoostAttempt (Figure 1), host arrays.

    ``stuck == False``: ``hypotheses[:rounds]`` is the boosted ensemble
    with E_S(f) = 0 on the alive sample (Lemma 4.2).  ``stuck == True``:
    the final coreset (``coreset_index`` per player, an index past the
    shard where a dead shard's sampled coreset named none) is
    non-realizable (Observation 4.3) and goes to quarantine.
    """

    stuck: bool
    rounds: int                  # hypotheses produced
    hypotheses: Any              # [T, P] stacked hypothesis params
    coreset_index: Any           # [k, c] int32 local indices
    coreset_x: Any               # [k, c(, F)] points of the final coreset
    coreset_y: Any               # [k, c] labels of the final coreset
    min_mixture_loss: Any        # L_{D_t}(ĥ) of the last round


@dataclasses.dataclass
class ClassifyResult:
    """Output of AccuratelyClassify (Figure 2), host arrays."""

    hypotheses: Any              # [T, P] ensemble of the final attempt
    rounds: int
    dispute_x: Any               # [P] quarantined points
    dispute_y: Any               # (n₊ [P], n₋ [P]) label counts
    dispute_count: int
    attempts: int                # BoostAttempt invocations (≤ OPT + 1)
    stuck_history: list
    ledger: "Ledger"


@dataclasses.dataclass
class Ledger:
    """Bit-exact communication accounting (see core/ledger.py)."""

    bits_coresets: int = 0
    bits_weight_sums: int = 0
    bits_hypotheses: int = 0
    bits_control: int = 0
    bits_dispute: int = 0
    rounds: int = 0
    attempts: int = 0
    bits_histograms: int = 0
    bits_votes: int = 0

    @property
    def total_bits(self) -> int:
        return (self.bits_coresets + self.bits_weight_sums
                + self.bits_hypotheses + self.bits_control
                + self.bits_dispute + self.bits_histograms
                + self.bits_votes)

    def __add__(self, other: "Ledger") -> "Ledger":
        return Ledger(**{f.name: getattr(self, f.name) + getattr(other, f.name)
                         for f in dataclasses.fields(Ledger)})
