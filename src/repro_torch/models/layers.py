"""Primitive layers: linear, RMS norm, RoPE, SwiGLU MLP, embeddings —
the port of ``repro.models.layers``.

Plain functions on dicts of tensors, as in the reference: parameters
are stored float32, and the forward pass runs in bf16 (each product
casts its input and its weight to bf16 and returns bf16), with the
norms and RoPE computed in float32.  ``init`` functions take an
explicit ``torch.Generator``; the tensors land on its device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BF16 = torch.bfloat16


def normal(gen: torch.Generator, shape, scale: float = 0.02) -> torch.Tensor:
    """``scale`` × a standard normal truncated to [−2, 2], float32 on
    the generator's device (the reference's ``_normal``)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.nn.init.trunc_normal_(t, 0.0, scale, -2.0 * scale,
                                       2.0 * scale, generator=gen)


def linear_init(gen, in_dim: int, out_dim: int, bias: bool = False,
                scale: float = 0.02) -> dict:
    p = {"w": normal(gen, (in_dim, out_dim), scale)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32,
                             device=gen.device)
    return p


def linear(p: dict, x: torch.Tensor, dtype=BF16) -> torch.Tensor:
    """x @ w (w is [in, out]) with both cast to ``dtype``."""
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def rmsnorm_init(dim: int, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding of x [..., S, H, hd] at ``positions``
    (broadcastable to [..., S]), the two halves of hd rotated
    together."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs             # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                     # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:2 * half].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    if 2 * half != hd:                                     # odd head_dim
        out = torch.cat([out, x[..., 2 * half:].float()], dim=-1)
    return out.to(x.dtype)


def mlp_init(gen, d_model: int, d_ff: int) -> dict:
    return {"wg": linear_init(gen, d_model, d_ff),
            "wu": linear_init(gen, d_model, d_ff),
            "wd": linear_init(gen, d_ff, d_model)}


def mlp(p: dict, x: torch.Tensor, dtype=BF16) -> torch.Tensor:
    """SwiGLU: wd(silu(wg x) · wu x)."""
    g = F.silu(linear(p["wg"], x, dtype))
    u = linear(p["wu"], x, dtype)
    return linear(p["wd"], g * u, dtype)


def embed_init(gen, vocab: int, d_model: int) -> dict:
    return {"emb": normal(gen, (vocab, d_model), 0.02)}


def embed(p: dict, tokens: torch.Tensor, dtype=BF16) -> torch.Tensor:
    return p["emb"][tokens.long()].to(dtype)


def unembed(p: dict, x: torch.Tensor, dtype=BF16) -> torch.Tensor:
    """Logits in float32 against the embedding matrix (tied heads)."""
    return (x.to(dtype) @ p["emb"].T.to(dtype)).float()
