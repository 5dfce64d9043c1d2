"""Mixture-of-Experts FFN: a top-k router and two dispatches — the port
of ``repro.models.moe``.

* ``einsum`` (the default): the grouped one-hot dispatch.  Tokens run in
  groups of ``GROUP_SIZE``; each group builds a dispatch tensor
  [G, Tg, E, C] (1 where token t sits in slot c of expert e) and a
  combine tensor (its gate there), and four einsums move the tokens
  into the experts' buffers, through the experts and back.
* ``sort``: the tokens' (token, k) slots sorted by expert, gathered
  into per-expert buffers of C slots, the experts applied as batched
  products, the results added back per token.

Both keep the reference's capacity rule: an expert takes at most
C = int(T·K/E·capacity_factor) slots of a group (C = T·K when
``exact``), the k-th choices of every token queued after the (k−1)-th
ones, and a slot past C is dropped.  Serving's decode steps (S = 1) run
``exact``, so decode drops nothing while a prefill drops what lies past
capacity, as in the reference.

The router's top-k is a stable argsort of −probs, never ``topk``:
equal probabilities resolve to the lowest expert id, as in the
reference (``torch.topk``'s tie order is no contract).  The dispatch
tensors are written by index where the reference sums one-hot
products: each (token, expert) pair is chosen at most once, so every
entry is the same 0/1 (and the same gate), and no step waits on the
host.  DTensor tokens (the launch tooling's dry run) take the
reference's one-hot products: an indexed write into a fresh tensor has
no DTensor rule, an elementwise product shards like its operands.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core import prng
from repro_torch.models import layers as L

GROUP_SIZE = 1024
BF16 = torch.bfloat16


def _num_experts(cfg) -> int:
    """Physical expert count (≥ logical; a padded expert never wins the
    router, whose outputs cover the logical experts only)."""
    return max(cfg.expert_pad_to, cfg.num_experts)


def init(key: torch.Tensor, cfg) -> dict:
    """The reference's ``split(key, 4)``: router, wg, wu, wd."""
    D, E, Fd = cfg.d_model, _num_experts(cfg), cfg.expert_d_ff
    kr, kg, ku, kd = prng.split(key, 4)
    return {"router": L.linear_init(kr, D, cfg.num_experts, scale=0.02),
            "wg": L.normal(kg, (E, D, Fd)),
            "wu": L.normal(ku, (E, D, Fd)),
            "wd": L.normal(kd, (E, Fd, D))}


def _route(p, cfg, x: torch.Tensor):
    """Router in float32 over tokens x [..., T, D] → gates [..., T, K]
    (renormalised over the K chosen), expert ids idx [..., T, K] (int64)
    and the weighted Switch aux plus z-loss [...] per group."""
    logits = x.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)                    # [..., T, E]
    order = torch.argsort(-probs, dim=-1, stable=True)
    idx = order[..., :cfg.experts_per_token]
    gates = torch.gather(probs, -1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = cfg.num_experts
    load = F.one_hot(idx[..., 0], E).float().mean(-2)       # top-1 shares
    importance = probs.mean(-2)
    aux = E * (load * importance).sum(-1)
    zloss = (torch.logsumexp(logits, dim=-1) ** 2).mean(-1)
    return gates, idx, (cfg.router_aux_weight * aux
                        + cfg.router_z_weight * zloss)


def capacity(cfg, tokens: int, exact: bool) -> int:
    """Slots per expert for a group of ``tokens`` tokens."""
    K = cfg.experts_per_token
    if exact:
        return tokens * K
    return max(1, int(tokens * K / cfg.num_experts * cfg.capacity_factor))


def einsum_slots(idx: torch.Tensor, Ep: int, C: int):
    """Each (token, k) choice's slot in its expert's buffer and whether
    it is kept, for idx [G, Tg, K]: the reference's per-k cumulative
    positions — choice k of token t queues after every choice k' < k of
    the group and after choice k of the tokens before t — as one count
    over the k-major queue of each expert.  Returns (pos, keep), both
    [G, Tg, K]."""
    G, Tg, K = idx.shape
    queue = idx.transpose(1, 2).reshape(G, 1, K * Tg)       # k-major
    experts = torch.arange(Ep, device=idx.device)[None, :, None]
    ahead = torch.cumsum((queue == experts).to(torch.int32), dim=-1)
    pos = torch.gather(ahead, 1, queue).reshape(G, K, Tg).transpose(1, 2)
    pos = pos.long() - 1
    return pos, pos < C


def _experts(p, xe: torch.Tensor, spec_in: str, spec_out: str):
    """SwiGLU of each expert over its buffer xe (bf16 products)."""
    h = F.silu(torch.einsum(spec_in, xe, p["wg"].to(BF16)))
    u = torch.einsum(spec_in, xe, p["wu"].to(BF16))
    return torch.einsum(spec_out, h * u, p["wd"].to(BF16))


def _einsum_moe(p, cfg, xg: torch.Tensor, exact: bool = False):
    """xg [G, Tg, D] grouped tokens → (y [G, Tg, D] bf16, mean aux)."""
    Tg = xg.shape[1]
    Ep = _num_experts(cfg)
    C = capacity(cfg, Tg, exact)
    gates, idx, aux = _route(p, cfg, xg)
    build = _one_hot_dispatch if isinstance(xg, DTensor) else _indexed_dispatch
    dispatch, combine = build(idx, gates, Ep, C)
    xe = torch.einsum("gtec,gtd->gecd", dispatch, xg.to(BF16))
    ye = _experts(p, xe, "gecd,edf->gecf", "gecf,efd->gecd")
    y = torch.einsum("gtec,gecd->gtd", combine.to(BF16), ye)
    return y, aux.mean()


def _indexed_dispatch(idx, gates, Ep: int, C: int):
    """The dispatch and combine tensors [G, Tg, Ep, C] for idx/gates
    [G, Tg, K], written by index: every choice writes its own (token,
    expert) cell, 1 and its gate where kept, 0 where dropped (at slot
    C − 1 of a cell no kept choice of the token shares)."""
    G, Tg, _ = idx.shape
    pos, keep = einsum_slots(idx, Ep, C)
    c = pos.clamp(max=C - 1)
    g = torch.arange(G, device=idx.device)[:, None, None].expand_as(idx)
    t = torch.arange(Tg, device=idx.device)[None, :, None].expand_as(idx)
    dispatch = torch.zeros((G, Tg, Ep, C), dtype=BF16, device=idx.device)
    combine = torch.zeros((G, Tg, Ep, C), dtype=torch.float32,
                          device=idx.device)
    dispatch[g, t, idx, c] = keep.to(BF16)
    combine[g, t, idx, c] = gates * keep
    return dispatch, combine


def _one_hot_dispatch(idx, gates, Ep: int, C: int):
    """The dispatch and combine tensors [G, Tg, Ep, C] as the reference
    builds them, for idx/gates [G, Tg, K]: choice k's one-hot expert
    rows, their positions a cumulative count after the (k−1)-th
    choices' (``offset``), and a one-hot slot where kept — only
    elementwise ops and a cumsum, no gather and no indexed write."""
    experts = torch.arange(Ep, device=idx.device)
    slots = torch.arange(C, device=idx.device)
    dispatch = combine = offset = None
    for kk in range(idx.shape[-1]):
        oh = (idx[..., kk, None] == experts).to(torch.int32)  # [G, Tg, Ep]
        pos = torch.cumsum(oh, dim=1) - 1
        if offset is not None:
            pos = pos + offset[:, None, :]
        count = oh.sum(dim=1)
        offset = count if offset is None else offset + count
        keep = (pos < C) & (oh > 0)
        sel = ((pos.clamp(0, C - 1)[..., None] == slots)
               & keep[..., None])                         # [G, Tg, Ep, C]
        d = sel.to(BF16)
        w = sel.float() * gates[..., kk, None, None]
        dispatch = d if dispatch is None else dispatch + d
        combine = w if combine is None else combine + w
    return dispatch, combine


def sort_slots(idx: torch.Tensor, Ep: int, C: int):
    """The sort dispatch's slots for idx [T, K]: ``order`` sorts the
    flat (token, k) choices by expert (stably), ``slot`` is each sorted
    choice's row of the expert buffers (Ep·C, the drop row, past
    capacity) and ``keep`` whether it is kept."""
    flat_e = idx.reshape(-1)
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    start = torch.searchsorted(e_sorted, torch.arange(
        Ep, dtype=e_sorted.dtype, device=idx.device))
    pos = torch.arange(n, device=idx.device) - start[e_sorted]
    keep = pos < C
    slot = torch.where(keep, e_sorted * C + pos, Ep * C)
    return order, slot, keep


def _sort_moe(p, cfg, x2d: torch.Tensor, exact: bool = False):
    """x2d [T, D] → (y [T, D] in x2d's type, aux): gather and scatter,
    no one-hot products."""
    T, D = x2d.shape
    K = cfg.experts_per_token
    Ep = _num_experts(cfg)
    C = capacity(cfg, T, exact)
    gates, idx, aux = _route(p, cfg, x2d)
    order, slot, keep = sort_slots(idx, Ep, C)
    tok = torch.arange(T, device=x2d.device).repeat_interleave(K)[order]
    xe = torch.zeros((Ep * C + 1, D), dtype=BF16, device=x2d.device)
    xe[slot] = x2d[tok].to(BF16)
    ye = _experts(p, xe[:Ep * C].reshape(Ep, C, D), "ecd,edf->ecf",
                  "ecf,efd->ecd").reshape(Ep * C, D)
    w = (gates.reshape(-1)[order] * keep).to(BF16)
    contrib = ye[torch.where(keep, slot, 0)] * w[:, None]
    y = torch.zeros((T, D), dtype=torch.float32, device=x2d.device)
    y.index_add_(0, tok, contrib.float())
    return y.to(x2d.dtype), aux


def apply(p, cfg, x: torch.Tensor, exact=None):
    """x [B, S, D] → (y [B, S, D], aux).  ``exact`` defaults to S == 1:
    a decode step is drop-free, a prefill or training step keeps the
    capacity factor."""
    B, S, D = x.shape
    T = B * S
    if exact is None:
        exact = S == 1
    if cfg.moe_dispatch == "sort":
        y, aux = _sort_moe(p, cfg, x.reshape(T, D), exact=exact)
        return y.reshape(B, S, D), aux
    g = max(1, T // GROUP_SIZE) if T >= GROUP_SIZE else 1
    while T % g:
        g -= 1
    y, aux = _einsum_moe(p, cfg, L.reshape(x, g, T // g, D), exact=exact)
    return L.reshape(y, B, S, D).to(x.dtype), aux
