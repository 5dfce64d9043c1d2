"""Primitive layers: linear, RMS and layer norms, RoPE, SwiGLU MLP,
embeddings — the port of ``repro.models.layers``.

Plain functions on dicts of tensors, as in the reference: parameters
are stored float32, and the forward pass runs in bf16 (each product
casts its input and its weight to bf16 and returns bf16), with the
norms and RoPE computed in float32.  ``init`` functions take a
threefry key (:mod:`repro_torch.core.prng`, ``[2]`` int64 words) and
walk the reference's key tree, so a seed gives the reference's
parameters bit for bit; the tensors land on the key's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng

BF16 = torch.bfloat16


def normal(key: torch.Tensor, shape, scale: float = 0.02) -> torch.Tensor:
    """``scale`` × ``jax.random.truncated_normal(key, −2, 2, shape)``,
    float32 on the key's device (the reference's ``_normal``: the draw
    is jax's jitted function, the product one eager float32 multiply)."""
    t = prng.truncated_normal(key, -2.0, 2.0, shape)
    return t.mul_(float(np.float32(scale)))


def linear_init(key, in_dim: int, out_dim: int, bias: bool = False,
                scale: float = 0.02) -> dict:
    p = {"w": normal(key, (in_dim, out_dim), scale)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32,
                             device=key.device)
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


def rms_norm_scaleless(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm without a learned scale."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def layernorm_init(dim: int, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in float32 (the population variance, as ``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


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


def mlp_init(key, d_model: int, d_ff: int) -> dict:
    kg, ku, kd = prng.split(key, 3)
    return {"wg": linear_init(kg, d_model, d_ff),
            "wu": linear_init(ku, d_model, d_ff),
            "wd": linear_init(kd, d_ff, d_model)}


def mlp(p: dict, x: torch.Tensor, dtype=BF16) -> torch.Tensor:
    """SwiGLU: wd(silu(wg x) · wu x)."""
    g = F.silu(linear(p["wg"], x, dtype))
    u = linear(p["wu"], x, dtype)
    return linear(p["wd"], g * u, dtype)


def embed_init(key, vocab: int, d_model: int) -> dict:
    return {"emb": normal(key, (vocab, d_model), 0.02)}


def embed(p: dict, tokens: torch.Tensor, dtype=BF16) -> torch.Tensor:
    return p["emb"][tokens.long()].to(dtype)


def unembed(p: dict, x: torch.Tensor, dtype=BF16) -> torch.Tensor:
    """Logits in float32 against the embedding matrix (tied heads)."""
    return (x.to(dtype) @ p["emb"].T.to(dtype)).float()
