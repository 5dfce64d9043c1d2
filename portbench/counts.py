"""Model FLOPs and the bytes a step needs, from the configuration's
shapes, and the H100's published peaks.

They count what the inputs need, never what the program happens to
compute: products of the active weights (2 FLOPs a multiply-add), the
LM head only where logits are read, causal attention over the live
(query, key) pairs, and for a decode step each weight read once in the
type it is served in and the live K/V cache read once.  The one-hot
MoE dispatch's products, dropped or padded slots and weight casts are
not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def _hd(c: dict) -> int:
    return c.get("head_dim") or c["d_model"] // c["num_heads"]


def attn_params(c: dict) -> int:
    D, H, KV, hd = c["d_model"], c["num_heads"], c["num_kv_heads"], _hd(c)
    return D * H * hd + 2 * D * KV * hd + H * hd * D


def ffn_params(c: dict, active: bool) -> int:
    """The FFN's product weights per layer: a SwiGLU MLP, or a router
    and the experts (``active``: the ``experts_per_token`` a token
    uses)."""
    D = c["d_model"]
    if not c.get("num_experts"):
        return 3 * D * c["d_ff"]
    n = c["experts_per_token"] if active else c["num_experts"]
    return D * c["num_experts"] + n * 3 * D * (c.get("moe_d_ff") or c["d_ff"])


def layer_params(c: dict, active: bool = True) -> int:
    """Product weights of one layer (norm scales are not products)."""
    return attn_params(c) + ffn_params(c, active)


def head_params(c: dict) -> int:
    """The LM head over the real vocabulary."""
    return c["d_model"] * c["vocab_size"]


def attention_flops(c: dict, pairs) -> float:
    """q·k and p·v: 4·hd FLOPs per live (query, key) pair, per head and
    layer."""
    return 4 * _hd(c) * c["num_heads"] * pairs * c["num_layers"]


def prefill_flops(c: dict, batch: int, length: int) -> int:
    """A prefill of ``batch`` prompts of ``length`` tokens that reads the
    last position's logits."""
    tokens = batch * length
    pairs = batch * length * (length + 1) // 2
    return (2 * c["num_layers"] * layer_params(c) * tokens
            + 2 * head_params(c) * batch
            + attention_flops(c, pairs))


def decode_flops(c: dict, batch: int, live: float) -> float:
    """One decode step of ``batch`` sequences, each attending over
    ``live`` cached keys plus itself."""
    return (2 * c["num_layers"] * layer_params(c) * batch
            + 2 * head_params(c) * batch
            + attention_flops(c, batch * (live + 1)))


def kv_bytes_per_token(c: dict) -> int:
    """K and V of one position over every layer, in bf16."""
    return 2 * c["num_kv_heads"] * _hd(c) * BF16_BYTES * c["num_layers"]


def decode_bytes(c: dict, batch: int, live: float,
                 experts_touched: int | None = None) -> float:
    """One decode step: every weight it reads once in bf16 (the experts
    ``experts_touched`` of each layer for an MoE; all of them when not
    given), the live cache read once and the new position written."""
    if c.get("num_experts"):
        n = c["num_experts"] if experts_touched is None else experts_touched
        D = c["d_model"]
        per_layer = (attn_params(c) + D * c["num_experts"]
                     + n * 3 * D * (c.get("moe_d_ff") or c["d_ff"]))
    else:
        per_layer = layer_params(c)
    weights = (c["num_layers"] * per_layer + head_params(c)) * BF16_BYTES
    return weights + kv_bytes_per_token(c) * batch * (live + 1)


def flash_work(batch: int, length: int, heads: int, kv_heads: int,
               hd: int) -> tuple[int, int]:
    """(FLOPs, bytes) causal attention needs without a window: 4·hd per
    live (query, key) pair (q·k and p·v), S(S + 1)/2 pairs per head, and
    each of q, k, v and o moved once in bf16."""
    pairs = length * (length + 1) // 2
    return (4 * hd * pairs * batch * heads,
            BF16_BYTES * (2 * batch * length * heads * hd
                          + 2 * batch * length * kv_heads * hd))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the FLOPs at
    the bf16 peak and the bytes at the HBM peak."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
