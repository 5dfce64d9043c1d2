"""Plain float32 forward pass of a decoder-only transformer whose FFN is
a top-k mixture of SwiGLU experts, written from the configuration
file's semantics.  Everything but the FFN is :mod:`dense`'s.

The FFN, per token x (after its norm):

* router: probabilities softmax(x · router) in float32 (the router's
  product stays float32 in the control too, as the configuration
  states); the ``experts_per_token`` experts of highest probability,
  ties to the lowest expert id; their gates renormalised to sum to 1.
* capacity: a prompt's tokens are routed in groups.  The tokens of the
  batch, flattened in (sequence, position) order, are cut into g equal
  groups, g = T // ``moe_group_tokens`` (1 below that size), lowered
  until it divides T.  In a group of Tg tokens an expert takes
  C = int(Tg · k / E · capacity_factor) choices: the first choices of
  all the group's tokens queue before the second choices, and so on,
  each in token order, and a choice past C is dropped (adds nothing).
  Positions at or past ``prompt_len`` are decode steps: nothing is
  dropped there.
* output: the sum over kept choices of gate · wd(silu(x·wg) · x·wu) of
  that expert.

The groups are those of the batch it is given, so a caller passes the
prompts that the program prefilled together.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import dense


def groups(T: int, size: int) -> int:
    g = max(1, T // size) if T >= size else 1
    while T % g:
        g -= 1
    return g


def keep_mask(idx: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """idx [Tg, k] expert ids of one group → kept [Tg, k]: each choice's
    place in its expert's queue (choice-major, then token order) is
    below C."""
    Tg, K = idx.shape
    queue = idx.t().reshape(-1)
    hot = F.one_hot(queue, E)
    place = (hot.cumsum(0) * hot).sum(-1) - 1
    return (place < C).view(K, Tg).t()


def route(p, c, xt: torch.Tensor, prompt_tokens: torch.Tensor):
    """Expert ids, gates and kept choices [T, k] of tokens xt [T, D];
    ``prompt_tokens`` (indices into xt, in batch order) are routed with
    capacity, the others drop-free."""
    E, K = c["num_experts"], c["experts_per_token"]
    probs = torch.softmax(xt @ p["router"]["w"], dim=-1)
    idx = torch.argsort(-probs, dim=-1, stable=True)[:, :K]
    gates = torch.gather(probs, -1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    keep = torch.ones_like(idx, dtype=torch.bool)
    T = prompt_tokens.numel()
    if T:
        g = groups(T, c["moe_group_tokens"])
        Tg = T // g
        C = max(1, int(Tg * K / E * c["capacity_factor"]))
        for j in range(g):
            rows = prompt_tokens[j * Tg:(j + 1) * Tg]
            keep[rows] = keep_mask(idx[rows], E, C)
    return idx, gates, keep


def ffn(p, c, x, prod, prompt_len=None):
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    P = S if prompt_len is None else min(prompt_len, S)
    flat = torch.arange(B * S, device=x.device).view(B, S)
    idx, gates, keep = route(p, c, xt, flat[:, :P].reshape(-1))
    y = torch.zeros_like(xt)
    for e in range(c["num_experts"]):
        rows, ks = torch.nonzero((idx == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = xt[rows]
        h = F.silu(prod.mm(xe, p["wg"][e])) * prod.mm(xe, p["wu"][e])
        y.index_add_(0, rows, prod.mm(h, p["wd"][e]) * gates[rows, ks, None])
    return y.view(B, S, D)


def logits(params, c, tokens, out_pos, products="f32", prompt_len=None):
    return dense.forward(params, c, tokens, out_pos, ffn, products,
                         prompt_len)
