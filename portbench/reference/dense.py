"""Plain float32 forward pass of a decoder-only transformer with a
SwiGLU MLP, written from the configuration file's semantics.

It imports nothing of the program.  Per layer: h += attention(rms(h)),
h += ffn(rms(h)); then the final norm and the untied LM head.

* RMS norm: x · rsqrt(mean(x²) + eps) · scale.
* Attention: q, k, v = x·wq, x·wk, x·wv in heads of ``head_dim``;
  rotary embedding on q and k (the two halves of a head rotated
  together, frequencies theta^(−i/half)); causal softmax of q·k/√hd;
  each group of num_heads/num_kv_heads query heads shares one K/V
  head; the output through wo.
* MLP: wd(silu(x·wg) · x·wu).
* Multipliers, where the file states them (Granite's names): the
  embedding times ``embedding_multiplier``, each layer's two residual
  branches times ``residual_multiplier``, attention scores times
  ``attention_multiplier`` (else 1/√hd), logits over
  ``logits_scaling``.

Everything is float32 with TF32 off (:func:`exact_float32`).  With
``products="fp8"`` (the benchmark's control) every product that the
configuration runs in bf16 takes its two inputs rounded to float8
e4m3, each tensor scaled by its own largest magnitude, and sums in
float32: the next precision below bf16.

Parameters are the tree the benchmark drew (``weights.draw``):
``embed.emb`` [Vp, D], ``blocks[i].{norm1, mixer, norm2, ffn}``,
``final_norm``, ``lm_head.w`` [D, Vp].
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0             # largest finite float8 e4m3 value
HEAD_CHUNK = 8              # query heads whose scores are held at once


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32 (TF32 off for cuBLAS and cuDNN),
    restored afterwards."""
    mats = (torch.backends.cuda.matmul, torch.backends.cudnn)
    if all(hasattr(m, "fp32_precision") for m in mats):
        saved = [m.fp32_precision for m in mats]
        for m in mats:
            m.fp32_precision = "ieee"
        try:
            yield
        finally:
            for m, s in zip(mats, saved):
                m.fp32_precision = s
    else:
        saved = [m.allow_tf32 for m in mats]
        for m in mats:
            m.allow_tf32 = False
        try:
            yield
        finally:
            for m, s in zip(mats, saved):
                m.allow_tf32 = s


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    s = FP8_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class Products:
    """The products' precision: ``"f32"`` or ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"products {kind!r}: f32 or fp8")
        self.round = fp8 if kind == "fp8" else (lambda t: t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def head_dim(c: dict) -> int:
    return c.get("head_dim") or c["d_model"] // c["num_heads"]


def rope(x, theta: float):
    """x [B, S, H, hd] at positions 0 … S − 1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    i = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * i / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                      x[..., 2 * half:]], dim=-1)


def attention(p, c, x, prod: Products):
    B, S, _ = x.shape
    H, KV, hd = c["num_heads"], c["num_kv_heads"], head_dim(c)
    q = rope(prod.mm(x, p["wq"]["w"]).view(B, S, H, hd), c["rope_theta"])
    k = rope(prod.mm(x, p["wk"]["w"]).view(B, S, KV, hd), c["rope_theta"])
    v = prod.mm(x, p["wv"]["w"]).view(B, S, KV, hd)
    q, k, v = prod.round(q), prod.round(k), prod.round(v)
    scale = c.get("attention_multiplier", 1.0 / math.sqrt(hd))
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    kv_of = torch.arange(H, device=x.device) // (H // KV)
    out = torch.empty(B, S, H, hd, dtype=torch.float32, device=x.device)
    for b in range(B):
        for h0 in range(0, H, HEAD_CHUNK):
            heads = kv_of[h0:h0 + HEAD_CHUNK]
            qh = q[b, :, h0:h0 + HEAD_CHUNK].transpose(0, 1)      # [h, S, hd]
            kh = k[b][:, heads].transpose(0, 1)
            vh = v[b][:, heads].transpose(0, 1)
            s = (qh @ kh.transpose(1, 2)) * scale
            w = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
            out[b, :, h0:h0 + HEAD_CHUNK] = (prod.round(w) @ vh).transpose(0, 1)
    return prod.mm(out.view(B, S, H * hd), p["wo"]["w"])


def mlp(p, c, x, prod: Products, prompt_len=None):
    g = F.silu(prod.mm(x, p["wg"]["w"]))
    return prod.mm(g * prod.mm(x, p["wu"]["w"]), p["wd"]["w"])


def forward(params, c, tokens, out_pos, ffn, products="f32",
            prompt_len=None):
    """Logits [B, len(out_pos), Vp] of ``tokens`` [B, S] at the
    positions ``out_pos``; ``ffn(p, c, x, prod, prompt_len)`` is each
    layer's FFN."""
    prod = Products(products)
    eps, res = c["norm_eps"], c.get("residual_multiplier", 1.0)
    with exact_float32(), torch.no_grad():
        h = (params["embed"]["emb"][tokens.long()].float()
             * c.get("embedding_multiplier", 1.0))
        for blk in params["blocks"]:
            h = h + res * attention(blk["mixer"], c,
                                    rms_norm(h, blk["norm1"]["scale"], eps),
                                    prod)
            h = h + res * ffn(blk["ffn"], c,
                              rms_norm(h, blk["norm2"]["scale"], eps), prod,
                              prompt_len)
        hf = rms_norm(h[:, list(out_pos)], params["final_norm"]["scale"], eps)
        return prod.mm(hf, params["lm_head"]["w"]) / c.get("logits_scaling",
                                                           1.0)


def logits(params, c, tokens, out_pos, products="f32", prompt_len=None):
    return forward(params, c, tokens, out_pos, mlp, products, prompt_len)
