"""Plain PyTorch version of the stump score contraction (the kernel's
oracle), with the reference's signatures (``repro.kernels.stump.ref``).

The compare tensor [B, c, F, n] is materialised a chunk of thresholds
at a time, at most :data:`CHUNK_ELEMS` entries, and contracted with the
weights by a matrix product, so the temporaries stay bounded whatever
Q is.  The sum order is the product's, not the kernel's point-index
order: on integer or dyadic weights whose partial sums fit 24 bits both
are exact and agree bit for bit; on general weights they differ by
rounding only.
"""

from __future__ import annotations

import torch

CHUNK_ELEMS = 1 << 26


def stump_scores_ref(x: torch.Tensor, wy: torch.Tensor,
                     thetas: torch.Tensor) -> torch.Tensor:
    """S[(b,) f, q] = Σ_i wy_i · 1[x[i, f] ≥ θ[f, q]]: x [(B,) c, F],
    wy [(B,) c], thetas [(B,) F, Q] float32 → [(B,) F, Q] float32."""
    batched = x.ndim == 3
    if not batched:
        x, wy, thetas = x[None], wy[None], thetas[None]
    B, c, F = x.shape
    Q = thetas.shape[-1]
    out = torch.empty((B, F, Q), dtype=torch.float32, device=x.device)
    step = max(1, CHUNK_ELEMS // max(B * c * F, 1))
    for q0 in range(0, Q, step):
        th = thetas[..., q0:q0 + step]
        n = th.shape[-1]
        pred = (x[..., None] >= th[:, None]).to(torch.float32)
        out[..., q0:q0 + n] = torch.matmul(
            wy[:, None, :], pred.reshape(B, c, F * n)).reshape(B, F, n)
    return out if batched else out[0]


def stump_errors_ref(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                     thetas: torch.Tensor) -> torch.Tensor:
    """Weighted error of every (f, q, sign) stump, [(B,) F, Q, 2]; sign
    index 0 predicts +1 where x ≥ θ, index 1 predicts −1 there."""
    return errors_from_scores(stump_scores_ref(x, w * y.to(w.dtype), thetas),
                              w, y)


def errors_from_scores(S: torch.Tensor, w: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """Stump errors [(B,) F, Q, 2] from scores S [(B,) F, Q] in closed
    form: err± = ½(W ∓ (2S − Σwy))."""
    wy = w * y.to(w.dtype)
    W = w.sum(dim=-1)
    swy = wy.sum(dim=-1)
    if S.ndim == 3:
        W, swy = W[:, None, None], swy[:, None, None]
    corr_plus = 2.0 * S - swy          # Σ wy_i · pred_i for sign +1
    return torch.stack([0.5 * (W - corr_plus), 0.5 * (W + corr_plus)],
                       dim=-1)
