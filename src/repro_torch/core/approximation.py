"""ε-approximation construction, step 2(a) (counterpart of
repro.core.approximation).

Two constructions, as in the reference:

* the deterministic quantile coreset — sort a player's shard by domain
  point and take, within each label class, the points at weighted
  quantile levels (j+½)/c± (the 1-D integer classes);
* the randomized coreset — c i.i.d. draws from p_t by Gumbel-max over
  threefry keys (:mod:`repro_torch.core.prng`), the draws bit-equal to
  ``jax.random.gumbel`` (the feature-track classes).

Every function works over leading batch axes (tasks, players).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import fp32, prng
from repro_torch.core import weights as W
from repro_torch.core.pinned import pinned_argmax


def quantile_coreset(x: torch.Tensor, y: torch.Tensor, hits: torch.Tensor,
                     alive: torch.Tensor, c: int,
                     order: torch.Tensor | None = None,
                     y_sorted: torch.Tensor | None = None,
                     alive_sorted: torch.Tensor | None = None,
                     hmin: torch.Tensor | None = None) -> torch.Tensor:
    """Per-label weighted-quantile coreset: ``[..., m]`` inputs →
    ``[..., c]`` local indices.  ``order``/``y_sorted``/
    ``alive_sorted`` hoist the loop-invariant sort and gathers;
    ``hmin`` ([...]) passes in the least alive hit count of each row
    when the caller already has it (``weights.least_alive_hits``).

    Floats follow the reference's rounding (core/fp32.py): the weights
    are XLA's exp2(−shift) values and the prefix sums its scan order,
    so the indices equal the reference's bit for bit.
    """
    m = x.shape[-1]
    if order is None:
        order = torch.argsort(x, dim=-1, stable=True)
    ys = torch.gather(y, -1, order) if y_sorted is None else y_sorted
    al = torch.gather(alive, -1, order) if alive_sorted is None \
        else alive_sorted
    hs = torch.gather(hits, -1, order)
    if hmin is None:
        hmin = W.least_alive_hits(hits, alive)
    hmin = hmin[..., None]
    # quantile levels are scale-free: weights relative to the lightest
    # hit count, clipped so an all-dead row stays finite
    p = torch.where(al, fp32.exp2_neg((hs - hmin).clamp(0, 126)), 0.0)
    pos = ys > 0
    p2 = torch.stack([torch.where(pos, p, 0.0), torch.where(pos, 0.0, p)],
                     dim=-2)                                  # [..., 2, m]
    cum = fp32.cumsum(p2)
    w_pos, w_neg = cum[..., 0, -1:], cum[..., 1, -1:]          # [..., 1]
    has_pos = (w_pos > 1e-12).to(torch.int32)
    has_neg = (w_neg > 1e-12).to(torch.int32)
    c_pos = torch.round(c * w_pos / torch.clamp(w_pos + w_neg, min=1e-30))
    c_pos = torch.minimum(torch.maximum(c_pos.to(torch.int32), has_pos),
                          c - has_neg)
    j = torch.arange(c, dtype=torch.float32, device=x.device)
    c_posf = torch.clamp(c_pos.float(), min=1.0)
    c_negf = torch.clamp((c - c_pos).float(), min=1.0)
    lvls = torch.stack([(j + 0.5) * w_pos / c_posf,
                        (j - c_posf + 0.5) * w_neg / c_negf], dim=-2)
    idx2 = torch.searchsorted(cum.contiguous(), lvls.contiguous())
    idx2 = idx2.clamp(0, m - 1)
    pos_sel = torch.arange(c, device=x.device) < c_pos
    idx_sorted = torch.where(pos_sel, idx2[..., 0, :], idx2[..., 1, :])
    return torch.gather(order, -1, idx_sorted)


def sampled_coreset(keys: torch.Tensor, hits: torch.Tensor,
                    alive: torch.Tensor, c: int,
                    log_wsum: torch.Tensor) -> torch.Tensor:
    """Randomized coreset: c i.i.d. draws from p_t per row.

    ``keys`` [..., 2] one key per row; ``hits``/``alive`` [..., m];
    ``log_wsum`` [...] each row's log2 weight sum.  Returns [..., c]
    int64 local indices: Gumbel-max over ``gumbel(key, (c, m))`` plus
    the natural-log probabilities, the winner pinned to the lowest
    index as in the reference.  An all-dead row has NaN logits and
    yields index m, one past the row, exactly as the reference does
    (its gather then fills, see :func:`gather_fill`).
    """
    logp = W.normalized_log_probs(hits, alive, log_wsum) * fp32.LN2
    g = prng.gumbel(keys, (c, hits.shape[-1]))
    return pinned_argmax(g + logp[..., None, :], dim=-1)


def gather_fill(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v`` [..., m(, F)] gathered at ``idx`` [..., c] along the m
    axis, with the reference's out-of-bounds fill (``jnp.take_along_
    axis``): an index ≥ m reads NaN for floats and the type's minimum
    for integers."""
    m = v.shape[idx.ndim - 1]
    oob = idx >= m
    safe = idx.clamp(max=m - 1)
    if v.ndim > idx.ndim:                               # feature rows
        safe = safe[..., None].expand(idx.shape + v.shape[idx.ndim:])
        oob = oob[..., None]
    out = torch.gather(v, idx.ndim - 1, safe)
    fill = (math.nan if torch.is_floating_point(v)
            else torch.iinfo(v.dtype).min)
    return torch.where(oob, torch.tensor(fill, dtype=v.dtype,
                                         device=v.device), out)


def select_coreset(x: torch.Tensor, y: torch.Tensor, hits: torch.Tensor,
                   alive: torch.Tensor, c: int, deterministic: bool,
                   order: torch.Tensor | None = None,
                   y_sorted: torch.Tensor | None = None,
                   alive_sorted: torch.Tensor | None = None,
                   hmin: torch.Tensor | None = None,
                   keys: torch.Tensor | None = None,
                   log_wsum: torch.Tensor | None = None) -> torch.Tensor:
    """Step 2(a) coreset indices: the quantile coreset when
    ``deterministic``, else :func:`sampled_coreset` under ``keys``
    with the rows' ``log_wsum``."""
    if not deterministic:
        return sampled_coreset(keys, hits, alive, c, log_wsum)
    return quantile_coreset(x, y, hits, alive, c, order=order,
                            y_sorted=y_sorted, alive_sorted=alive_sorted,
                            hmin=hmin)


def approximation_error(coreset_idx: torch.Tensor, x: torch.Tensor,
                        y: torch.Tensor, hits: torch.Tensor,
                        alive: torch.Tensor, predict_fn,
                        hyp_params: torch.Tensor) -> torch.Tensor:
    """sup_h |L_{S'}(h) − L_p(h)| over the hypotheses ``hyp_params``
    [C, P]: how far the coreset ``coreset_idx`` [c] of one player's
    shard (x [m] or [m, F], y, hits, alive [m]) is from an
    ε-approximation of p_t (Lemma 4.2's property; a diagnostic).
    ``predict_fn(params [C, P], pts [C, n(, F)]) → [C, n]`` pairs each
    hypothesis with its own copy of the points (the port's ``predict``).
    Sums follow XLA:CPU's order (core/fp32.py)."""
    C = hyp_params.shape[0]
    p = fp32.exp2(W.normalized_log_probs(
        hits, alive, W.log_weight_sum(hits, alive)))

    def each(v):
        return v[None].expand((C,) + tuple(v.shape))

    wrong = predict_fn(hyp_params, each(x)) != y
    err_full = fp32.sum_(torch.where(wrong, p, 0.0))
    cx, cy = x[coreset_idx], y[coreset_idx]
    wrong_core = (predict_fn(hyp_params, each(cx)) != cy).float()
    err_core = fp32.sum_(wrong_core) / float(coreset_idx.shape[0])
    return (err_full - err_core).abs().amax()
