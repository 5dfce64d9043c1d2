"""Decoder-only stack for any block pattern — the port of
``repro.models.transformer``.

A *superblock* is one repetition of ``cfg.block_pattern``: a single
(attn, mlp) or (attn, moe) layer for the dense and MoE archs, eight
Mamba/attention layers with alternating MLP/MoE FFNs for jamba, eight
m/sLSTM blocks for xLSTM.  The reference stacks each pattern position's
parameters on a leading [num_superblocks] axis and drives them with
``jax.lax.scan``; the port keeps one parameter dict per layer in
``params["blocks"]``, in the order the reference applies them
(superblock-major: layer s·P + i is pattern position i of superblock
s), and loops over them; ``cfg.remat`` recomputes each layer in a
training backward pass (``torch.utils.checkpoint``).

Modes:
* ``forward``      — logits over the full sequence (an optional prefix of
  frontend embeddings before the tokens) and the summed MoE aux loss.
* ``prefill``      — forward of the prompt; returns the last position's
  logits, the aux and one cache per layer of the layer's own kind
  (attention: K/V of capacity S, len S; Mamba, mLSTM, sLSTM: the
  recurrent state after position S).
* ``decode_step``  — one token against the caches.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import prng
from repro_torch.models import attention, layers as L, moe, ssm, xlstm
from repro_torch.obs import trace as obs_trace

MIXERS = ("attn", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")
SLSTM_STATE = ("h", "c", "n", "m")


def check_pattern(cfg) -> None:
    """Raise on a mixer or FFN name that the reference has not either."""
    for mixer, ffn in cfg.block_pattern:
        if mixer not in MIXERS or ffn not in FFNS:
            raise ValueError(f"{cfg.name}: block ({mixer!r}, {ffn!r}) is "
                             f"not a block the model has: mixers "
                             f"{MIXERS}, FFNs {FFNS}")


def layer_kinds(cfg) -> list:
    """(mixer, ffn) of each layer, in the order they apply."""
    return [cfg.block_pattern[i % cfg.pattern_len]
            for i in range(cfg.num_layers)]


def _block_init(key, cfg, mixer: str, ffn: str) -> dict:
    km, kf = prng.split(key)
    p = {"norm1": L.rmsnorm_init(cfg.d_model, key.device)}
    if mixer == "attn":
        p["mixer"] = attention.init(km, cfg)
    elif mixer == "mamba":
        p["mixer"] = ssm.init(km, cfg)
    elif mixer == "mlstm":
        p["mixer"] = xlstm.mlstm_init(km, cfg)
    else:
        p["mixer"] = xlstm.slstm_init(km, cfg)
    if ffn != "none":
        p["norm2"] = L.rmsnorm_init(cfg.d_model, key.device)
        p["ffn"] = (L.mlp_init(kf, cfg.d_model, cfg.d_ff) if ffn == "mlp"
                    else moe.init(kf, cfg))
    return p


def init_params(key: torch.Tensor, cfg) -> dict:
    """Parameters (float32, on the key's device) along the reference's
    key tree: ``split(key, pattern_len + 3)``; superblock s of pattern
    position i draws from ``split(ks[i], num_superblocks)[s]``, as the
    reference's ``vmap`` over layer keys does; ``ks[-3]`` the
    embedding, ``ks[-2]`` the untied head."""
    check_pattern(cfg)
    P = cfg.pattern_len
    ks = prng.split(key, P + 3)
    layer_keys = [prng.split(ks[i], cfg.num_superblocks) for i in range(P)]
    blocks = [_block_init(layer_keys[i][s], cfg, mixer, ffn)
              for s in range(cfg.num_superblocks)
              for i, (mixer, ffn) in enumerate(cfg.block_pattern)]
    params = {"embed": L.embed_init(ks[-3], cfg.padded_vocab, cfg.d_model),
              "blocks": blocks,
              "final_norm": L.rmsnorm_init(cfg.d_model, key.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.linear_init(ks[-2], cfg.d_model,
                                          cfg.padded_vocab)
    return params


def _apply_block(p, cfg, mixer, ffn, h, positions, *, window, use_flash,
                 collect_cache=False):
    """One layer on the full sequence: (h, aux, the layer's cache).
    ``collect_cache`` (the prefill's) applies attention's head-layout
    hint, as the reference's serving path does."""
    hn = L.rms_norm(p["norm1"], h, cfg.norm_eps)
    if mixer == "attn":
        with obs_trace.span("attention", "model"):
            out, k, v = attention.full_attention(
                p["mixer"], cfg, hn, positions, causal=True, window=window,
                use_flash=use_flash, constrain_layout=collect_cache)
        cache = {"k": k, "v": v}
    elif mixer == "mamba":
        out, cache = ssm.forward(p["mixer"], cfg, hn)
    elif mixer == "mlstm":
        out, cache = xlstm.mlstm_forward(p["mixer"], cfg, hn)
    else:
        out, cache = xlstm.slstm_forward(p["mixer"], cfg, hn)
    h, aux = _ffn(p, cfg, ffn, h + out)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux, cache


def _ffn(p, cfg, ffn, h):
    """The layer's FFN on its residual stream: (h, the MoE's aux, None
    for another FFN).  The MLP runs inside an ``mlp`` span, the MoE
    inside a ``moe_ffn`` span, their norm outside either; a profiler
    capture under an active recorder shows each span with its
    kernels."""
    if ffn == "mlp":
        x = L.rms_norm(p["norm2"], h, cfg.norm_eps)
        with obs_trace.span("mlp", "model"):
            y = L.mlp(p["ffn"], x)
        return h + y, None
    if ffn == "moe":
        x = L.rms_norm(p["norm2"], h, cfg.norm_eps)
        with obs_trace.span("moe_ffn", "model"):
            y, aux = moe.apply(p["ffn"], cfg, x)
        return h + y, aux
    return h, None


def _embed(params, tokens, prefix_embeds):
    h = L.embed(params["embed"], tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    return h


def _logits(params, cfg, h) -> torch.Tensor:
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], h)
    return L.linear(params["lm_head"], h).float()


def forward(params, cfg, tokens, prefix_embeds=None, use_flash=False):
    """tokens [B, St] (after ``prefix_embeds`` [B, Sp, D] if given) →
    (logits [B, Sp + St, Vp] float32, aux summed over layers).  Under
    autograd with ``cfg.remat`` each layer is recomputed in the backward
    pass (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of each superblock."""
    check_pattern(cfg)
    h = _embed(params, tokens, prefix_embeds)
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p, (mixer, ffn) in zip(params["blocks"], layer_kinds(cfg)):
        def layer(hh, p=p, mixer=mixer, ffn=ffn):
            return _apply_block(p, cfg, mixer, ffn, hh, positions,
                                window=cfg.sliding_window,
                                use_flash=use_flash)[:2]
        h, a = (torch.utils.checkpoint.checkpoint(layer, h,
                                                  use_reentrant=False)
                if remat else layer(h))
        aux = aux + a
    return _logits(params, cfg, h), aux


def init_cache(cfg, batch: int, capacity: int, device,
               dtype=torch.bfloat16, filled: bool = True) -> list:
    """One empty cache per layer, of the layer's kind: attention K/V of
    ``capacity`` slots (``filled`` marks them all live, as the
    reference's dry-run decode shapes do), a Mamba state (its conv ring
    in ``dtype``), an mLSTM or sLSTM state."""
    check_pattern(cfg)
    caches = []
    for mixer, _ in layer_kinds(cfg):
        if mixer == "attn":
            c = attention.init_cache(cfg, batch, capacity, device, dtype)
            if filled:
                c["len"].fill_(capacity)
        elif mixer == "mamba":
            c = ssm.init_state(cfg, batch, dtype, device=device)
        elif mixer == "mlstm":
            c = xlstm.mlstm_init_state(cfg, batch, device=device)
        else:
            c = dict(zip(SLSTM_STATE,
                         xlstm.slstm_init_state(cfg, batch, device=device)))
        caches.append(c)
    return caches


def prefill(params, cfg, tokens, prefix_embeds=None, use_flash=False,
            window=0):
    """Forward of the prompt that also returns the serving caches:
    (last-position logits [B, Vp] float32, aux, caches)."""
    check_pattern(cfg)
    h = _embed(params, tokens, prefix_embeds)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = []
    for p, (mixer, ffn) in zip(params["blocks"], layer_kinds(cfg)):
        h, a, c = _apply_block(p, cfg, mixer, ffn, h, positions,
                               window=window or cfg.sliding_window,
                               use_flash=use_flash, collect_cache=True)
        aux = aux + a
        if mixer == "attn":
            c["len"] = torch.full((B,), S, dtype=torch.int32,
                                  device=h.device)
        caches.append(c)
    logits = _logits(params, cfg, h[:, -1:])
    return logits[:, 0], aux, caches


def decode_step(params, cfg, caches, tokens, *, window=0):
    """One-token decode.  tokens [B, 1] → (logits [B, Vp], caches); the
    list of caches is updated in place (attention K/V in place too)."""
    check_pattern(cfg)
    h = L.embed(params["embed"], tokens)
    for i, (p, (mixer, ffn)) in enumerate(zip(params["blocks"],
                                              layer_kinds(cfg))):
        h, caches[i] = _decode_block(p, cfg, mixer, ffn, h, caches[i],
                                     window=window)
    return _logits(params, cfg, h)[:, 0], caches


def _decode_block(p, cfg, mixer, ffn, h, cache, *, window):
    """One layer on one new token: (h, the layer's new cache)."""
    hn = L.rms_norm(p["norm1"], h, cfg.norm_eps)
    if mixer == "attn":
        with obs_trace.span("attention", "model"):
            out, cache = attention.decode_attention(p["mixer"], cfg, hn,
                                                    cache, window=window)
    elif mixer == "mamba":
        out, cache = ssm.decode_step(p["mixer"], cfg, hn, cache)
    elif mixer == "mlstm":
        out, cache = xlstm.mlstm_decode(p["mixer"], cfg, hn, cache)
    else:
        st = tuple(cache[n] for n in SLSTM_STATE)
        out, st = xlstm.slstm_decode(p["mixer"], cfg, hn, st)
        cache = dict(zip(SLSTM_STATE, st))
    return _ffn(p, cfg, ffn, h + out)[0], cache
