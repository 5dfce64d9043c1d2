"""Finite-class agnostic learning with no promise on OPT — the port of
``repro.core.finite`` (Section 6 of the paper).

For a finite class H = {h_1, …, h_|H|} each player computes its local
error vector E_i(h) (no communication) and sends it to the center,
⌈log2 m⌉·|H| bits; the center sums and returns the argmin: exactly OPT
errors whatever OPT is, for k·|H|·⌈log2 m⌉ + k·⌈log2 |H|⌉ bits.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.pinned import pinned_argmin
from repro_torch.device import resolve_device


@dataclasses.dataclass
class FiniteResult:
    best_params: torch.Tensor
    errors: int
    opt: int                      # == errors (exact ERM)
    total_bits: int


def learn_finite(x, y, hyp_params, cls, device=None) -> FiniteResult:
    """x, y: [k, m_loc] shards; hyp_params: [H, 4] the finite class.
    The error vectors are computed on ``device`` (``cuda`` unless the
    caller asks for the CPU), one player at a time."""
    dev = resolve_device(device)
    x, y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    hyp = torch.as_tensor(hyp_params, device=dev)
    k, mloc = x.shape[0], x.shape[1]
    m = k * mloc
    H = hyp.shape[0]
    totals = torch.zeros(H, dtype=torch.int32, device=dev)
    for i in range(k):
        preds = cls.predict(hyp, x[i].expand((H,) + x.shape[1:]))  # [H, mloc]
        totals += (preds != y[i][None]).sum(-1, dtype=torch.int32)
    j = int(pinned_argmin(totals))
    errors = int(totals[j])
    bits = (k * H * max(1, math.ceil(math.log2(max(m, 2))))
            + k * max(1, math.ceil(math.log2(max(H, 2)))))
    return FiniteResult(best_params=hyp[j], errors=errors, opt=errors,
                        total_bits=bits)
