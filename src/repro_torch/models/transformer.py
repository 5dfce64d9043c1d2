"""Decoder-only stack for the dense family — the port of
``repro.models.transformer``.

The reference stacks each pattern position's parameters on a leading
[num_superblocks] axis and drives them with ``jax.lax.scan``; the port
keeps one parameter dict per layer in ``params["blocks"]`` and loops
over them; ``cfg.remat`` recomputes each layer in a training backward
pass (``torch.utils.checkpoint``).  Only the dense pattern ``(("attn", "mlp"),)``
runs; MoE, SSM, xLSTM and hybrid patterns raise.

Modes:
* ``forward``      — logits over the full sequence.
* ``prefill``      — forward of the prompt; returns the last position's
  logits and the KV cache (capacity S, len S).
* ``decode_step``  — one token against the cache.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import prng
from repro_torch.models import attention, layers as L

DENSE = (("attn", "mlp"),)


def check_dense(cfg) -> None:
    """Raise unless ``cfg`` is a dense decoder the port runs."""
    if tuple(cfg.block_pattern) != DENSE or cfg.encoder_layers \
            or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern} (encoder "
            f"layers {cfg.encoder_layers}, frontend {cfg.frontend!r}) is "
            f"not ported yet; the port runs the dense (attn, mlp) family "
            f"(ROADMAP queue 1, item 15)")


def _block_init(key, cfg) -> dict:
    km, kf = prng.split(key)
    return {"norm1": L.rmsnorm_init(cfg.d_model, key.device),
            "mixer": attention.init(km, cfg),
            "norm2": L.rmsnorm_init(cfg.d_model, key.device),
            "ffn": L.mlp_init(kf, cfg.d_model, cfg.d_ff)}


def init_params(key: torch.Tensor, cfg) -> dict:
    """Parameters (float32, on the key's device) along the reference's
    key tree: ``split(key, pattern_len + 3)``; layer l of the (single)
    pattern position draws from ``split(ks[0], num_layers)[l]`` as the
    reference's ``vmap`` over layer keys does; ``ks[-3]`` the
    embedding, ``ks[-2]`` the untied head."""
    check_dense(cfg)
    ks = prng.split(key, cfg.pattern_len + 3)
    layer_keys = prng.split(ks[0], cfg.num_superblocks)
    params = {"embed": L.embed_init(ks[-3], cfg.padded_vocab, cfg.d_model),
              "blocks": [_block_init(k, cfg) for k in layer_keys],
              "final_norm": L.rmsnorm_init(cfg.d_model, key.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.linear_init(ks[-2], cfg.d_model,
                                          cfg.padded_vocab)
    return params


def _apply_block(p, cfg, h, positions, *, window, use_flash):
    """One (attn, mlp) layer on the full sequence: (h, k, v)."""
    out, k, v = attention.full_attention(
        p["mixer"], cfg, L.rms_norm(p["norm1"], h, cfg.norm_eps), positions,
        causal=True, window=window, use_flash=use_flash)
    h = h + out
    h = h + L.mlp(p["ffn"], L.rms_norm(p["norm2"], h, cfg.norm_eps))
    return h, k, v


def _logits(params, cfg, h) -> torch.Tensor:
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], h)
    return L.linear(params["lm_head"], h).float()


def forward(params, cfg, tokens, use_flash=False):
    """tokens [B, S] → (logits [B, S, Vp] float32, aux 0.0).  Under
    autograd with ``cfg.remat`` each layer is recomputed in the
    backward pass (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of each superblock."""
    check_dense(cfg)
    h = L.embed(params["embed"], tokens)
    positions = torch.arange(h.shape[1], dtype=torch.int32,
                             device=h.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    for p in params["blocks"]:
        def layer(hh, p=p):
            return _apply_block(p, cfg, hh, positions,
                                window=cfg.sliding_window,
                                use_flash=use_flash)[0]
        h = (torch.utils.checkpoint.checkpoint(layer, h, use_reentrant=False)
             if remat else layer(h))
    return _logits(params, cfg, h), torch.zeros((), device=h.device)


def init_cache(cfg, batch: int, capacity: int, device,
               dtype=torch.bfloat16, filled: bool = True) -> list:
    """One empty cache per layer; ``filled`` marks ``capacity`` slots
    live, as the reference's dry-run decode shapes do."""
    check_dense(cfg)
    caches = []
    for _ in range(cfg.num_layers):
        c = attention.init_cache(cfg, batch, capacity, device, dtype)
        if filled:
            c["len"].fill_(capacity)
        caches.append(c)
    return caches


def prefill(params, cfg, tokens, use_flash=False, window=0):
    """Forward of the prompt that also returns the serving cache:
    (last-position logits [B, Vp] float32, aux 0.0, caches)."""
    check_dense(cfg)
    h = L.embed(params["embed"], tokens)
    B, S = h.shape[0], h.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=h.device)[None, :]
    caches = []
    for p in params["blocks"]:
        h, k, v = _apply_block(p, cfg, h, positions,
                               window=window or cfg.sliding_window,
                               use_flash=use_flash)
        caches.append({"k": k, "v": v, "len": torch.full(
            (B,), S, dtype=torch.int32, device=h.device)})
    logits = _logits(params, cfg, h[:, -1:])
    return logits[:, 0], torch.zeros((), device=h.device), caches


def decode_step(params, cfg, caches, tokens, *, window=0):
    """One-token decode.  tokens [B, 1] → (logits [B, Vp], caches); the
    caches are updated in place."""
    check_dense(cfg)
    h = L.embed(params["embed"], tokens)
    for p, cache in zip(params["blocks"], caches):
        out, _ = attention.decode_attention(
            p["mixer"], cfg, L.rms_norm(p["norm1"], h, cfg.norm_eps), cache,
            window=window)
        h = h + out
        h = h + L.mlp(p["ffn"], L.rms_norm(p["norm2"], h, cfg.norm_eps))
    return _logits(params, cfg, h)[:, 0], caches
