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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import prng

BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# DTensor mechanics (the launch tooling places the models on a mesh).  The
# models call these where a DTensor needs more than the plain op; a plain
# tensor passes each of them untouched.
# ---------------------------------------------------------------------------

def _fit_shards(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """DTensor ``t`` ready to split tensor dim ``dim`` into (n, …): the
    mesh axes that shard ``dim`` are kept while their product divides
    n, and the others replicate it, as DTensor cannot split an uneven
    shard (GSPMD would shard the inner part too)."""
    dim %= t.ndim
    mesh, place = t.device_mesh, list(t.placements)
    parts = 1
    for i, pl in enumerate(place):
        if isinstance(pl, Shard) and pl.dim == dim:
            if n % (parts * mesh.size(i)):
                place[i] = Replicate()
            else:
                parts *= mesh.size(i)
    if place == list(t.placements):
        return t
    return t.redistribute(mesh, place)


class _FitGrad(torch.autograd.Function):
    """The identity, whose backward fits the gradient (_fit_shards)."""

    @staticmethod
    def forward(ctx, t, dim, n):
        ctx.dim, ctx.n = dim, n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _fit_shards(grad, ctx.dim, ctx.n), None, None


def _groups(old, new) -> list:
    """The dims of a reshape from ``old`` to ``new`` in groups of equal
    product: a list of (old dims, new dims).  A size-1 dim that would
    open a group joins the one before."""
    out, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        if out and old[i] == 1 != new[j]:
            out[-1][0].append(i)
            i += 1
            continue
        if out and new[j] == 1 != old[i]:
            out[-1][1].append(j)
            j += 1
            continue
        gi, gj = [i], [j]
        a, b = old[i], new[j]
        while a != b:
            if a < b:
                i += 1
                gi.append(i)
                a *= old[i]
            else:
                j += 1
                gj.append(j)
                b *= new[j]
        out.append((gi, gj))
        i, j = i + 1, j + 1
    if out:
        out[-1][0].extend(range(i, len(old)))
        out[-1][1].extend(range(j, len(new)))
    return out


def reshape(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(shape)``, also for a DTensor whose shards the reshape
    would split unevenly.  For each group of dims that the reshape
    splits, only the group's leading dim stays sharded, while its
    shards divide the leading new dim; in a backward pass the gradient
    is fitted the same way where the reshape merges dims, because the
    backward splits them again."""
    if not isinstance(t, DTensor):
        return t.reshape(*shape)
    old = tuple(t.shape)
    new = list(shape)
    if -1 in new:
        new[new.index(-1)] = t.numel() // math.prod(n for n in new if n != -1)
    groups = _groups(old, new)
    for gi, gj in groups:
        if len(gj) > 1:
            for d in gi[1:]:
                t = _fit_shards(t, d, 1)
            t = _fit_shards(t, gi[0], new[gj[0]])
    out = t.reshape(new)
    if out.requires_grad:
        for gi, gj in groups:
            if len(gi) > 1:
                for d in gj[1:]:
                    out = _FitGrad.apply(out, d, 1)
                out = _FitGrad.apply(out, gj[0], old[gi[0]])
    return out


def on_local(fn, mesh, places: dict, ins: str, outs: str):
    """``fn`` as ``local_map`` runs it on each device's block of DTensor
    inputs.  ``places`` maps a letter to placements on ``mesh`` ("r",
    replicated, is always there); ``ins`` gives one letter an input,
    ``outs`` one an output.  A plain tensor input counts as
    replicated.  Where some input shards a mesh dim, each device's
    block holds part of the work, so the gradient of an input that is
    replicated there is each device's part of a sum (``Partial``)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    rep = (Replicate(),) * mesh.ndim
    places = dict(places, r=rep)
    split = {i for c in ins for i, pl in enumerate(places[c])
             if isinstance(pl, Shard)}
    grads = tuple(tuple(Partial() if i in split and pl.is_replicate() else pl
                        for i, pl in enumerate(places[c])) for c in ins)
    run = local_map(fn, tuple(places[c] for c in outs),
                    in_placements=tuple(places[c] for c in ins),
                    in_grad_placements=grads,
                    redistribute_inputs=True, device_mesh=mesh)

    def call(*args):
        return run(*(a if isinstance(a, DTensor)
                     else DTensor.from_local(a, mesh, rep, run_check=False)
                     for a in args))

    return call


def on_rows(fn, like: torch.Tensor, ins: str, outs: str):
    """``fn`` on each device's batch rows where ``like`` is a DTensor
    (:func:`on_local`: "b" a [B, …] tensor sharded on its rows as
    ``like`` is, "r" one replicated), else ``fn`` itself."""
    if not isinstance(like, DTensor):
        return fn
    rows = tuple(pl if type(pl) is Shard and pl.dim == 0 else Replicate()
                 for pl in like.placements)
    return on_local(fn, like.device_mesh, {"b": rows}, ins, outs)


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
