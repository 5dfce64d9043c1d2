"""GQA attention with a KV cache, sliding window, optional qk-norm and
the flash kernel — the port of ``repro.models.attention``.

Layouts, as in the reference:
  q:      [B, S, H,  hd]
  k, v:   [B, T, KV, hd]
  cache:  {"k": [B, C, KV, hd], "v": [B, C, KV, hd], "len": int32 [B]}

The decode step writes the new token at slot ``len % C`` (a ring).  As
in the reference, nothing keeps ``len < C``: after a prefill of S
tokens (C = S, len = S) the first decode step writes slot 0, so from
the second generated token on the oldest prompt position is gone and
the model attends over a ring of C slots plus the token itself
(ROADMAP queue 3).  The port writes the cache in place — the caller's
cache dict is the one returned — where the reference returns a new
one; the values are the same.

The reference's GSPMD layout hints (``_tp_size``/``_constrain_heads``)
have no meaning on one card and are left out.  Cross-attention (the
encoder-decoder's) has no qk-norm and no RoPE; its decode reads the
encoder's precomputed K/V.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import prng
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L

NEG_INF = -1e30


def init(key: torch.Tensor, cfg, cross: bool = False) -> dict:
    """The reference's ``split(key, 6)``: keys 0–3 draw wq, wk, wv, wo;
    qk-norm scales unless ``cross``."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    ks = prng.split(key, 6)
    p = {"wq": L.linear_init(ks[0], D, H * hd, bias=cfg.attn_bias),
         "wk": L.linear_init(ks[1], D, KV * hd, bias=cfg.attn_bias),
         "wv": L.linear_init(ks[2], D, KV * hd, bias=cfg.attn_bias),
         "wo": L.linear_init(ks[3], H * hd, D, bias=cfg.attn_bias)}
    if cfg.qk_norm and not cross:
        p["q_norm"] = L.rmsnorm_init(hd, key.device)
        p["k_norm"] = L.rmsnorm_init(hd, key.device)
    return p


def _project_qkv(p, cfg, x, kv_x, positions, kv_positions, use_rope=True):
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = L.linear(p["wq"], x).reshape(B, -1, H, hd)
    k = L.linear(p["wk"], kv_x).reshape(B, -1, KV, hd)
    v = L.linear(p["wv"], kv_x).reshape(B, -1, KV, hd)
    if "q_norm" in p:
        q = L.rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = L.rms_norm(p["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _scores(qg: torch.Tensor, k: torch.Tensor, spec: str) -> torch.Tensor:
    """q·k over hd in float32 (the reference's bf16 einsum with
    ``preferred_element_type=float32``: products of bf16 values are
    exact in float32, so the sum is the only rounding), scaled by
    1/√hd."""
    s = torch.einsum(spec, qg.float(), k.float())
    return s / math.sqrt(qg.shape[-1])


def gqa_scores_mask(q, k, v, mask):
    """Plain attention (the reference's einsum path).  mask: [B, S, T]
    bool, True where query i may attend key j."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    scores = _scores(qg, k, "bskgh,btkh->bkgst")
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H * hd)


def causal_mask(S: int, T: int, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """[S, T] bool; query i attends key j iff j ≤ i + offset and, with a
    window, j > i + offset − window."""
    i = torch.arange(S, dtype=torch.int32, device=device)[:, None] + offset
    j = torch.arange(T, dtype=torch.int32, device=device)[None, :]
    m = j <= i
    if window > 0:
        m &= j > (i - window)
    return m


def full_attention(p, cfg, x, positions, *, causal=True, window=0,
                   kv_x=None, kv_positions=None, use_rope=True,
                   use_flash=False):
    """Prefill / forward attention over a full sequence.

    Returns (out [B, S, D], k, v) so prefill can write the cache.  The
    flash kernel serves causal self-attention when ``use_flash``; every
    other case takes the einsum path, as in the reference."""
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(p, cfg, x, kv_x, positions, kv_positions,
                           use_rope)
    B, S = q.shape[0], q.shape[1]
    T = k.shape[1]
    if use_flash and causal and kv_x is x:
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
        out = out.reshape(B, S, -1)
    else:
        if causal:
            m = causal_mask(S, T, offset=T - S, window=window,
                            device=x.device)
        else:
            m = torch.ones((S, T), dtype=torch.bool, device=x.device)
        out = gqa_scores_mask(q, k, v, m.expand(B, S, T))
    return L.linear(p["wo"], out), k, v


def init_cache(cfg, batch: int, capacity: int, device,
               dtype=torch.bfloat16) -> dict:
    KV, hd = cfg.num_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, capacity, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, capacity, KV, hd), dtype=dtype,
                             device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_attention(p, cfg, x, cache, *, window=0, use_rope=True):
    """One-token decode: attend to the ring cache and to the token
    itself, then write the token's K/V at slot ``len % C`` in place.

    x: [B, 1, D].  Returns (out [B, 1, D], cache)."""
    B = x.shape[0]
    C = cache["k"].shape[1]
    pos = cache["len"][:, None]                            # [B, 1]
    q, k_new, v_new = _project_qkv(p, cfg, x, x, pos, pos, use_rope)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    G = H // KV
    k_all, v_all = cache["k"], cache["v"]
    # slots written in the last min(len, C) steps are live
    slots = torch.arange(C, dtype=torch.int32, device=x.device)[None, :]
    ln = cache["len"][:, None]
    live = slots < torch.clamp(ln, max=C)
    if window > 0:
        # absolute position of slot s (ring): the latest write wins
        abs_pos = torch.where(slots < ln % max(C, 1),
                              ln - ln % C + slots,
                              ln - ln % C - C + slots)
        live &= abs_pos > ln - window
        live &= abs_pos >= 0
    qg = q.reshape(B, 1, KV, G, hd)
    scores = _scores(qg, k_all, "bskgh,btkh->bkgst")
    scores = torch.where(live[:, None, None, None, :], scores, NEG_INF)
    self_score = _scores(qg, k_new.reshape(B, 1, KV, hd),
                         "bskgh,bskh->bkgs")
    all_scores = torch.cat([scores, self_score[..., None]], dim=-1)
    w = torch.softmax(all_scores, dim=-1).to(v_all.dtype)  # [B,KV,G,1,C+1]
    out = (torch.einsum("bkgst,btkh->bskgh", w[..., :C], v_all)
           + torch.einsum("bkgs,bskh->bskgh", w[..., C],
                          v_new.reshape(B, 1, KV, hd)))
    out = out.reshape(B, 1, H * hd)
    rows = torch.arange(B, device=x.device)
    widx = (cache["len"] % C).long()
    k_all[rows, widx] = k_new[:, 0]
    v_all[rows, widx] = v_new[:, 0]
    cache["len"] = cache["len"] + 1
    return L.linear(p["wo"], out), cache


def cross_decode_attention(p, cfg, x, enc_kv) -> torch.Tensor:
    """Cross-attention of one decoder token x [B, 1, D] over the
    encoder's precomputed {"k", "v"} [B, T, KV, hd]: O(T) a token."""
    B = x.shape[0]
    q = L.linear(p["wq"], x).reshape(B, 1, cfg.num_heads, cfg.hd)
    T = enc_kv["k"].shape[1]
    mask = torch.ones((B, 1, T), dtype=torch.bool, device=x.device)
    out = gqa_scores_mask(q, enc_kv["k"], enc_kv["v"], mask)
    return L.linear(p["wo"], out)
