"""Multiplicative-weights state in log2 space (counterpart of
repro.core.weights).

A weight is stored as its hit count H = −log2 W (int32, exact); the
paper's update W·2^{−1[h(x)=y]} is H += 1[h(x)=y] on alive examples.
Dead (quarantined) examples weigh 0.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import fp32


def init_hits(shape, device=None) -> torch.Tensor:
    """H_1 ≡ 0  ⇔  W_1 ≡ 1."""
    return torch.zeros(shape, dtype=torch.int32, device=device)


def update_hits(hits: torch.Tensor, correct: torch.Tensor,
                alive: torch.Tensor) -> torch.Tensor:
    """H += 1[h(x)=y] on alive examples (dtype preserved)."""
    return hits + (correct & alive).to(hits.dtype)


def log_weight_sum(hits: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """log2 Σ_{alive} 2^{−hits} over the last axis, max-shifted as the
    reference computes it; −inf for an all-dead row.  The engine reads
    the shifted sum from the mw_update kernel instead
    (:func:`log_wsums_from_sums`)."""
    logw = torch.where(alive, -hits.float(), -math.inf)
    mx = logw.amax(dim=-1, keepdim=True)
    finite = torch.isfinite(mx)
    mx_safe = torch.where(finite, mx, 0.0)
    s = fp32.sum_(fp32.exp2(logw - mx_safe))[..., None]
    out = mx_safe + fp32.log2(torch.clamp(s, min=1e-30))
    return torch.where(finite, out, -math.inf)[..., 0]


def log_wsums_from_sums(wsum: torch.Tensor, hmin: torch.Tensor,
                        shift: torch.Tensor | int = 0) -> torch.Tensor:
    """Step 2(b)'s log2 W^{(i)} from the carried weight sum
    ``wsum = Σ 2^(shift − hits)`` and each row's least alive hit count,
    in the reference's max-shifted form ``−hmin + log2(wsum·2^(hmin −
    shift))`` (the scaling is exact).  Within an attempt hmin − shift
    is 0 or 1: the engine passes the least hit count of the kernel's
    input as the shift.  A dead player (wsum 0) gives −inf."""
    d = torch.where(wsum > 0, hmin - shift, 0)
    # 2^d from its exponent bits: exact on every device
    scale = ((d + 127) << 23).view(torch.float32)
    out = -hmin.float() + fp32.log2(torch.clamp(wsum * scale, min=1e-30))
    return torch.where(wsum > 0, out, -math.inf)


def normalized_log_probs(hits: torch.Tensor, alive: torch.Tensor,
                         log_wsum: torch.Tensor) -> torch.Tensor:
    """log2 p_t(z) = −hits − log2 W over the last axis (−inf on dead
    entries, NaN across an all-dead row, as in the reference), from the
    row's log2 weight sum ``log_wsum`` [...] — the engine's
    :func:`log_wsums_from_sums`, the reference's max-shifted form."""
    logw = torch.where(alive, -hits.float(), -math.inf)
    return logw - log_wsum[..., None]


def mixture_weights(log_wsums: torch.Tensor) -> torch.Tensor:
    """W^{(i)} / W over the last (player) axis from per-player log2
    sums (step 2(c)); players with −inf get weight 0."""
    shifted = torch.where(torch.isfinite(log_wsums), log_wsums, -math.inf)
    mx = shifted.amax(dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    w = fp32.exp2(shifted - mx)
    return w / torch.clamp(fp32.sum_(w), min=1e-30)[..., None]
