"""The reduction baseline the paper credits (Section 1 / 2.2) — the port
of ``repro.core.semi_agnostic``.

Theorem 2.2 also follows from semi-agnostic distributed learning
(Balcan et al. 2012; Chen, Balcan, Chau 2016): obtain g with E_S(g) ≤
c·OPT, then have every player broadcast the examples g misclassifies
and patch g on those points.

1. Agnostic boosting: the same coreset messages, but the center always
   takes the ERM hypothesis and runs all T rounds, each player drawing
   its coreset from the SmoothBoost-capped distribution
   (``_capped_probs``: weights clipped at ``smooth_cap`` × uniform).
   The T rounds run on the device, one draw of [k, c, m_loc] Gumbel
   variates a round.
2. Patch: players broadcast every misclassified example; the final
   classifier answers the full-count majority there and g elsewhere.

The reference compiles the T rounds as one ``lax.scan``; XLA keeps
every float operation of the round as written but two: it folds the
division of the mixture weights by the constant c into ``mix ·
f32(1/c)`` (as in the engine, ``boost_attempt.center_erm``), and it
fuses each log2 weight sum's ``mx + log(s)·(1/ln 2)`` into one FMA
(``weights.log_weight_sum(jitted=True)``).  Sums run
in XLA:CPU's order (``fp32.sum_``), logs and exps are XLA:CPU's
(``fp32``), so the hypotheses equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fp32, ledger as L, prng, weak, weights as W
from repro_torch.core.boost_attempt import center_erm
from repro_torch.core.classify import ResilientClassifier
from repro_torch.core.types import BoostConfig, Ledger
from repro_torch.device import resolve_device


def _capped_probs(hits: torch.Tensor, alive: torch.Tensor,
                  cap: float) -> torch.Tensor:
    """SmoothBoost-style clipped distribution over the last axis:
    min(p, cap/m_alive) on alive entries, renormalized."""
    p = W.probs(hits, alive, jitted=True)
    m_alive = alive.sum(-1, dtype=torch.int32).clamp(min=1)
    cap_t = float(np.float32(cap)) / m_alive.float()
    p = torch.minimum(p, cap_t[..., None])
    p = torch.where(alive, p, 0.0)
    return p / torch.clamp(fp32.sum_(p), min=1e-30)[..., None]


def agnostic_boost(x, y, alive, key, cfg: BoostConfig, cls,
                   num_rounds: int, smooth_cap: float):
    """The T rounds of agnostic boosting on x's device: x [k, m_loc]
    (or [k, m_loc, F]), y/alive [k, m_loc], ``key`` [2] →
    (hypotheses [T, P] float32, losses [T])."""
    k, c = x.shape[0], cfg.coreset_size
    hits = W.init_hits(x.shape[:2], device=x.device)
    hyps, losses = [], []
    for _ in range(num_rounds):
        halves = prng.split(key, 2)
        key, keys = halves[0], prng.split(halves[1], k)
        p = _capped_probs(hits, alive, smooth_cap)
        logits = fp32.log(torch.clamp(p, min=1e-30))
        idx = prng.categorical(keys, logits, (c,))              # [k, c]
        if x.ndim == 3:
            cx = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
        else:
            cx = torch.gather(x, 1, idx)
        cy = torch.gather(y, 1, idx)
        mix = W.mixture_weights(W.log_weight_sum(hits, alive, jitted=True))
        h, loss = center_erm(cls, cx[None], cy[None], mix[None], c)
        h, loss = h[0], loss[0]
        hits = W.update_hits(hits, cls.predict(h, x) == y, alive)
        hyps.append(h)
        losses.append(loss)
    return torch.stack(hyps), torch.stack(losses)


@dataclasses.dataclass
class SemiAgnosticResult:
    classifier: object
    boost_errors: int           # E_S(g) before patching
    final_errors: int           # E_S(f) after patching
    patched: int                # examples broadcast in the patch step
    ledger: Ledger


def run_semi_agnostic(x, y, key, cfg: BoostConfig, cls,
                      smooth_cap: float = 8.0,
                      device=None) -> SemiAgnosticResult:
    """Agnostic boosting on ``device`` (``cuda`` unless the caller asks
    for the CPU), then the host patch step and its ledger.  ``key`` is
    a ``prng`` key (or the reference's uint32 key words)."""
    dev = resolve_device(device)
    x_np = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    y_np = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
    k, mloc = x_np.shape[0], x_np.shape[1]
    m = k * mloc
    num_rounds = cfg.num_rounds(m)
    xt, yt = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).to(dev)
    alive = torch.ones((k, mloc), dtype=torch.bool, device=dev)
    h_params, _ = agnostic_boost(xt, yt, alive,
                                 prng.wrap_key_data(key).to(dev), cfg, cls,
                                 num_rounds, smooth_cap)
    gx = weak.ensemble_predict(cls, h_params, num_rounds, xt)
    wrong = (gx != yt).cpu().numpy()
    # patch step: players broadcast every misclassified example; the
    # center patches f there by the full-count majority (players also
    # report the counts of their correct copies, as in classify.py)
    xf = x_np.reshape((m,) + x_np.shape[2:])
    yf = y_np.reshape(-1)
    wf = wrong.reshape(-1)
    if wf.any():
        bad = xf[wf]
        pts = np.unique(bad, axis=0) if bad.ndim == 2 else np.unique(bad)
        if pts.ndim == 2:
            eq = (xf[:, None, :] == pts[None]).all(-1)
        else:
            eq = xf[:, None] == pts[None]
        pos = (((yf > 0)[:, None]) & eq).sum(0)
        neg = (((yf < 0)[:, None]) & eq).sum(0)
    else:
        pts = np.zeros((0,) + tuple(xf.shape[1:]), xf.dtype)
        pos = neg = np.zeros((0,), np.int64)
    f = ResilientClassifier(cls=cls, hypotheses=h_params.cpu().numpy(),
                            rounds=num_rounds, dispute_x=pts,
                            dispute_pos=pos, dispute_neg=neg)
    preds = f(torch.from_numpy(xf).to(dev))
    final_errors = int(weak.empirical_errors(preds, torch.from_numpy(yf)
                                             .to(dev)))
    n = L.domain_size(cls)
    led = L.boost_attempt_ledger(cfg, cls, m, num_rounds, stuck=False)
    led.bits_dispute = int(wf.sum()) * L.example_bits(n) * cfg.k
    return SemiAgnosticResult(
        classifier=f, boost_errors=int(wrong.sum()),
        final_errors=final_errors, patched=int(wf.sum()), ledger=led)
