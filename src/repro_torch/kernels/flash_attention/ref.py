"""Plain PyTorch oracle of the flash-attention kernel (GQA, causal,
sliding window) — the port of ``repro.kernels.flash_attention.ref``.

Full softmax in float32 whatever the input type; the output is cast to
q's type.  It is what the wrapper runs on CPU tensors and what
``chip_smoke.py`` holds the CUDA kernel to on the card; nothing on the
card's main path calls it.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [B, H, S, hd]; k, v [B, KV, T, hd] → [B, H, S, hd].

    Query i attends key j iff j ≤ i (causal) and, with a window,
    j > i − window; positions count from 0 for both.  Query head h
    reads KV head h // (H / KV)."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgsh,bkth->bkgst", qg, k.float()) * hd ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    live = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        live &= kpos <= qpos
    if window > 0:
        live &= kpos > qpos - window
    s = torch.where(live, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bkth->bkgsh", w, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)
