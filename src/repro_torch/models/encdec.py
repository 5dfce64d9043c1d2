"""Encoder-decoder stack (seamless-m4t) — the port of
``repro.models.encdec``: a bidirectional encoder over stub frame
embeddings and a causal decoder with cross-attention.

Serving: the prefill encodes the source once and precomputes each
decoder layer's cross-attention K/V; a decode step then reads the
encoder's K/V (O(L_enc · d) a token) and its own self-attention cache.
As in the reference, the prefill scores the prompt teacher-forced but
leaves the decoder's self-attention cache empty (len 0), so decoding
attends to the generated tokens and the encoder only.

Parameters keep one dict per layer in ``params["encoder"]`` and
``params["decoder"]`` (the reference stacks them on a leading layer
axis and scans).
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.models import attention, layers as L


def _enc_layer_init(key, cfg) -> dict:
    ka, kf = prng.split(key)
    dev = key.device
    return {"norm1": L.rmsnorm_init(cfg.d_model, dev),
            "attn": attention.init(ka, cfg),
            "norm2": L.rmsnorm_init(cfg.d_model, dev),
            "ffn": L.mlp_init(kf, cfg.d_model, cfg.d_ff)}


def _dec_layer_init(key, cfg) -> dict:
    ka, kc, kf = prng.split(key, 3)
    dev = key.device
    return {"norm1": L.rmsnorm_init(cfg.d_model, dev),
            "self_attn": attention.init(ka, cfg),
            "norm_x": L.rmsnorm_init(cfg.d_model, dev),
            "cross_attn": attention.init(kc, cfg, cross=True),
            "norm2": L.rmsnorm_init(cfg.d_model, dev),
            "ffn": L.mlp_init(kf, cfg.d_model, cfg.d_ff)}


def init_params(key: torch.Tensor, cfg) -> dict:
    """The reference's key tree: ``split(key, 4)`` → encoder layers
    (``split(ke, encoder_layers)``), decoder layers (``split(kd,
    num_layers)``), embedding, head."""
    ke, kd, kt, kh = prng.split(key, 4)
    dev = key.device
    return {
        "encoder": [_enc_layer_init(k, cfg)
                    for k in prng.split(ke, cfg.encoder_layers)],
        "decoder": [_dec_layer_init(k, cfg)
                    for k in prng.split(kd, cfg.num_layers)],
        "embed": L.embed_init(kt, cfg.padded_vocab, cfg.d_model),
        "enc_norm": L.rmsnorm_init(cfg.d_model, dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, dev),
        "lm_head": L.linear_init(kh, cfg.d_model, cfg.padded_vocab),
    }


def _positions(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)[None, :]


def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, Se, D] stub embeddings → encoder output [B, Se, D]."""
    h = frames.to(torch.bfloat16)
    positions = _positions(h.shape[1], h.device)
    for lp in params["encoder"]:
        hn = L.rms_norm(lp["norm1"], h, cfg.norm_eps)
        out, _, _ = attention.full_attention(lp["attn"], cfg, hn, positions,
                                             causal=False)
        h = h + out
        h = h + L.mlp(lp["ffn"], L.rms_norm(lp["norm2"], h, cfg.norm_eps))
    return L.rms_norm(params["enc_norm"], h, cfg.norm_eps)


def decode_train(params, cfg, enc_out: torch.Tensor, tokens: torch.Tensor):
    """Teacher-forced decoder.  tokens [B, St] → (logits [B, St, Vp]
    float32, aux 0.0)."""
    h = L.embed(params["embed"], tokens)
    positions = _positions(tokens.shape[1], h.device)
    enc_positions = _positions(enc_out.shape[1], h.device)
    for lp in params["decoder"]:
        hn = L.rms_norm(lp["norm1"], h, cfg.norm_eps)
        out, _, _ = attention.full_attention(lp["self_attn"], cfg, hn,
                                             positions, causal=True)
        h = h + out
        hn = L.rms_norm(lp["norm_x"], h, cfg.norm_eps)
        out, _, _ = attention.full_attention(
            lp["cross_attn"], cfg, hn, positions, causal=False,
            kv_x=enc_out, kv_positions=enc_positions, use_rope=False)
        h = h + out
        h = h + L.mlp(lp["ffn"], L.rms_norm(lp["norm2"], h, cfg.norm_eps))
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    return (L.linear(params["lm_head"], h).float(),
            torch.zeros((), dtype=torch.float32, device=h.device))


def forward(params, cfg, frames, tokens):
    return decode_train(params, cfg, encode(params, cfg, frames), tokens)


def build_cross_cache(params, cfg, enc_out: torch.Tensor) -> list:
    """Each decoder layer's cross-attention {"k", "v"} [B, T, KV, hd]
    over the encoder output."""
    B, T = enc_out.shape[0], enc_out.shape[1]
    KV, hd = cfg.num_kv_heads, cfg.hd
    return [{n: L.reshape(L.linear(lp["cross_attn"]["w" + n], enc_out),
                          B, T, KV, hd) for n in "kv"}
            for lp in params["decoder"]]


def init_self_cache(cfg, batch: int, capacity: int, device,
                    dtype=torch.bfloat16, filled: bool = False) -> list:
    """One empty self-attention cache per decoder layer, len
    ``capacity`` if ``filled`` else 0."""
    caches = []
    for _ in range(cfg.num_layers):
        c = attention.init_cache(cfg, batch, capacity, device, dtype)
        if filled:
            c["len"].fill_(capacity)
        caches.append(c)
    return caches


def decode_step(params, cfg, cross_cache, self_cache, tokens):
    """One decoder token against the encoder's K/V.  tokens [B, 1] →
    (logits [B, Vp], self_cache updated in place)."""
    h = L.embed(params["embed"], tokens)
    for lp, cc, sc in zip(params["decoder"], cross_cache, self_cache):
        hn = L.rms_norm(lp["norm1"], h, cfg.norm_eps)
        out, _ = attention.decode_attention(lp["self_attn"], cfg, hn, sc)
        h = h + out
        hn = L.rms_norm(lp["norm_x"], h, cfg.norm_eps)
        h = h + attention.cross_decode_attention(lp["cross_attn"], cfg, hn,
                                                 cc)
        h = h + L.mlp(lp["ffn"], L.rms_norm(lp["norm2"], h, cfg.norm_eps))
    h = L.rms_norm(params["final_norm"], h, cfg.norm_eps)
    logits = L.linear(params["lm_head"], h).float()
    return logits[:, 0], self_cache
