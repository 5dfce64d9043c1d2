"""Plain PyTorch version of the decode attention kernel: one new token
attends over the live slots of a ring cache and over itself, and its
K/V is then written at slot ``len % C``.

The same math as the model's einsum path (``models.attention.
_decode_core``, which the DTensor caches of the launch tooling keep):
scores are q·k in float32 scaled by 1/√hd, slots that are not live are
−1e30, the softmax is float32, and the weights are rounded to the
cache's type before the weighted sum.  It is what the wrapper runs on
CPU tensors and what the card-only tests and ``chip_smoke.py`` hold
the CUDA kernel to; nothing on the card's main path calls it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def live_slots(lens: torch.Tensor, C: int, window: int = 0) -> torch.Tensor:
    """[B, C] bool: the slots written in the last min(len, C) steps,
    and with a window only those whose position p (the latest write of
    the slot in the ring) has p > len − window."""
    slots = torch.arange(C, dtype=torch.int32, device=lens.device)[None, :]
    ln = lens[:, None]
    live = slots < torch.clamp(ln, max=C)
    if window > 0:
        abs_pos = torch.where(slots < ln % max(C, 1),
                              ln - ln % C + slots,
                              ln - ln % C - C + slots)
        live &= abs_pos > ln - window
        live &= abs_pos >= 0
    return live


def decode_attention_ref(q, k_new, v_new, k_cache, v_cache, lens,
                         window: int = 0) -> torch.Tensor:
    """q [B, 1, H, hd], the token's k_new/v_new [B, 1, KV, hd], the
    cache [B, C, KV, hd] and its lengths int32 [B] → [B, 1, H·hd] in
    v's type; query head h reads KV head h // (H / KV).  Writes k_new
    and v_new into the cache at slot ``len % C`` after reading it."""
    B, _, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    live = live_slots(lens, C, window)
    qg = q.reshape(B, 1, KV, H // KV, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k_cache.float())
    scores = scores / math.sqrt(hd)
    scores = torch.where(live[:, None, None, None, :], scores, NEG_INF)
    self_score = torch.einsum("bskgh,bskh->bkgs", qg,
                              k_new.reshape(B, 1, KV, hd).float())
    self_score = self_score / math.sqrt(hd)
    all_scores = torch.cat([scores, self_score[..., None]], dim=-1)
    w = torch.softmax(all_scores, dim=-1).to(v_cache.dtype)
    out = (torch.einsum("bkgst,btkh->bskgh", w[..., :C], v_cache)
           + torch.einsum("bkgs,bskh->bskgh", w[..., C],
                          v_new.reshape(B, 1, KV, hd)))
    rows = torch.arange(B, device=lens.device)
    widx = (lens % C).long()
    k_cache[rows, widx] = k_new[:, 0]
    v_cache[rows, widx] = v_new[:, 0]
    return out.reshape(B, 1, H * hd)
