"""GQA attention with a KV cache, sliding window, optional qk-norm, the
flash kernel (prefill) and the decode attention kernel — the port of
``repro.models.attention``.

Layouts, as in the reference:
  q:      [B, S, H,  hd]
  k, v:   [B, T, KV, hd]
  cache:  {"k": [B, C, KV, hd], "v": [B, C, KV, hd], "len": int32 [B]}

The decode step writes the new token at slot ``len % C`` (a ring).  As
in the reference, nothing keeps ``len < C``: after a prefill of S
tokens (C = S, len = S) the first decode step writes slot 0, so from
the second generated token on the oldest prompt position is gone and
the model attends over a ring of C slots plus the token itself
(ROADMAP queue 3).  The port writes the cache in place — the caller's
cache dict is the one returned — where the reference returns a new
one; the values are the same.

The reference's GSPMD head-layout hint (``_constrain_heads``, on the
serving paths of an arch with ``cfg.attn_layout_constraint``) acts on
DTensors, as the launch tooling's dry run places them
(:mod:`repro_torch.launch.dryrun`); a plain tensor passes it untouched,
so a run on one card is unchanged.  A DTensor cache (the dry run's) is
written by a one-hot slot mask rather than by index: the same values,
in a form that DTensor shards on any cache axis.  Cross-attention (the
encoder-decoder's) has no qk-norm and no RoPE; its decode reads the
encoder's precomputed K/V.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import prng
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L

NEG_INF = -1e30


def _constrain_heads(t: torch.Tensor) -> torch.Tensor:
    """t [B, S, H, hd]: on a mesh with a "model" axis, shard H over it
    when H divides it, else replicate t on it (the reference's hint:
    GSPMD left alone may split the hd contraction when KV·hd is sharded
    wider than the KV head count, turning the softmax into S×S-sized
    all-reduces).  The degree is read from the mesh (the reference
    reads ``REPRO_TP_SIZE``, which has no counterpart); a plain tensor,
    or a mesh whose model axis is one device, passes untouched."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return t
    i = names.index("model")
    place = list(t.placements)
    place[i] = Shard(2) if t.shape[2] % mesh.size(i) == 0 else Replicate()
    return t.redistribute(mesh, place)


def init(key: torch.Tensor, cfg, cross: bool = False) -> dict:
    """The reference's ``split(key, 6)``: keys 0–3 draw wq, wk, wv, wo;
    qk-norm scales unless ``cross``."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    ks = prng.split(key, 6)
    p = {"wq": L.linear_init(ks[0], D, H * hd, bias=cfg.attn_bias),
         "wk": L.linear_init(ks[1], D, KV * hd, bias=cfg.attn_bias),
         "wv": L.linear_init(ks[2], D, KV * hd, bias=cfg.attn_bias),
         "wo": L.linear_init(ks[3], H * hd, D, bias=cfg.attn_bias)}
    if cfg.qk_norm and not cross:
        p["q_norm"] = L.rmsnorm_init(hd, key.device)
        p["k_norm"] = L.rmsnorm_init(hd, key.device)
    return p


def _project_qkv(p, cfg, x, kv_x, positions, kv_positions, use_rope=True,
                 constrain_layout=False):
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = L.reshape(L.linear(p["wq"], x), B, -1, H, hd)
    k = L.reshape(L.linear(p["wk"], kv_x), B, -1, KV, hd)
    v = L.reshape(L.linear(p["wv"], kv_x), B, -1, KV, hd)
    if constrain_layout and cfg.attn_layout_constraint:
        # serving paths only, per-arch opt-in, as in the reference
        q, k, v = map(_constrain_heads, (q, k, v))
    if "q_norm" in p:
        q = L.rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = L.rms_norm(p["k_norm"], k, cfg.norm_eps)
    if use_rope:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _scores(qg: torch.Tensor, k: torch.Tensor, spec: str) -> torch.Tensor:
    """q·k over hd in float32 (the reference's bf16 einsum with
    ``preferred_element_type=float32``: products of bf16 values are
    exact in float32, so the sum is the only rounding), scaled by
    1/√hd."""
    s = torch.einsum(spec, qg.float(), k.float())
    return s / math.sqrt(qg.shape[-1])


def _blocks(q, *kv):
    """How a DTensor attention core runs as a local function on each
    device's (batch, head) block.  Attention is independent per batch
    row and head, so each device can take its own: per mesh dim,
    Shard(0) where q shards its batch; Shard(2) on q, k and v on the
    other mesh dims while the H and KV heads both divide the product of
    their sizes (each device's q heads then use its own KV heads);
    replicated elsewhere.  It runs so where some mesh dim shards the
    heads (the Megatron layout), and wherever q, k or v (``kv``) shards
    both its batch and its heads: DTensor's einsum would flatten the two
    sharded dims into one batch of products, which its view rule
    refuses before torch 2.13.  Returns the mesh and the placements
    for :func:`layers.on_local`: "h" those of q, k, v and the [B, S,
    H·hd] output, "m" those of a [B, …] mask; or None for plain tensors
    and for heads that divide no mesh dim (DTensor's own rules place
    those, the domain of the head-layout hint)."""
    def both(t):
        return isinstance(t, DTensor) and {0, 2} <= {
            pl.dim for pl in t.placements if type(pl) is Shard}

    if not isinstance(q, DTensor):
        return None
    mesh, H, KV = q.device_mesh, q.shape[2], kv[0].shape[2]
    qkv, mask, parts = [], [], 1
    for i, pl in enumerate(q.placements):
        n = mesh.size(i)
        if type(pl) is Shard and pl.dim == 0:
            qkv.append(Shard(0))
        elif n > 1 and H % (parts * n) == 0 and KV % (parts * n) == 0:
            qkv.append(Shard(2))
            parts *= n
        else:
            qkv.append(Replicate())
        mask.append(Shard(0) if qkv[-1] == Shard(0) else Replicate())
    if parts == 1 and not any(map(both, (q, *kv))):
        return None
    return mesh, {"h": tuple(qkv), "m": tuple(mask)}


def gqa_scores_mask(q, k, v, mask):
    """Plain attention (the reference's einsum path).  mask: [B, S, T]
    bool, True where query i may attend key j.  DTensors whose batch
    and heads are both sharded run on their blocks (:func:`_blocks`)."""
    blocks = _blocks(q, k, v)
    core = _gqa_core if blocks is None else L.on_local(_gqa_core, *blocks,
                                                       "hhhm", "h")
    return core(q, k, v, mask)


def _gqa_core(q, k, v, mask):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = L.reshape(q, B, S, KV, G, hd)
    scores = _scores(qg, k, "bskgh,btkh->bkgst")
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return L.reshape(out, B, S, H * hd)


def causal_mask(S: int, T: int, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """[S, T] bool; query i attends key j iff j ≤ i + offset and, with a
    window, j > i + offset − window."""
    i = torch.arange(S, dtype=torch.int32, device=device)[:, None] + offset
    j = torch.arange(T, dtype=torch.int32, device=device)[None, :]
    m = j <= i
    if window > 0:
        m &= j > (i - window)
    return m


def full_attention(p, cfg, x, positions, *, causal=True, window=0,
                   kv_x=None, kv_positions=None, use_rope=True,
                   use_flash=False, constrain_layout=False):
    """Prefill / forward attention over a full sequence.

    Returns (out [B, S, D], k, v) so prefill can write the cache.  The
    flash kernel serves causal self-attention when ``use_flash``; every
    other case takes the einsum path, as in the reference.
    ``constrain_layout`` (the prefill's) applies the head-layout hint."""
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(p, cfg, x, kv_x, positions, kv_positions,
                           use_rope, constrain_layout=constrain_layout)
    B, S = q.shape[0], q.shape[1]
    T = k.shape[1]
    if use_flash and causal and kv_x is x:
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
        out = out.reshape(B, S, -1)
    else:
        if causal:
            m = causal_mask(S, T, offset=T - S, window=window,
                            device=x.device)
        else:
            m = torch.ones((S, T), dtype=torch.bool, device=x.device)
        out = gqa_scores_mask(q, k, v, m.expand(B, S, T))
    return L.linear(p["wo"], out), k, v


def init_cache(cfg, batch: int, capacity: int, device,
               dtype=torch.bfloat16) -> dict:
    KV, hd = cfg.num_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, capacity, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, capacity, KV, hd), dtype=dtype,
                             device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_attention(p, cfg, x, cache, *, window=0, use_rope=True):
    """One-token decode: attend to the ring cache and to the token
    itself, then write the token's K/V at slot ``len % C`` in place.
    A plain cache goes to the decode attention kernel's wrapper (the
    kernel on the card, its plain version on the CPU), a DTensor cache
    (the dry run's) to the einsum path.

    x: [B, 1, D].  Returns (out [B, 1, D], cache)."""
    pos = cache["len"][:, None]                            # [B, 1]
    q, k_new, v_new = _project_qkv(p, cfg, x, x, pos, pos, use_rope,
                                   constrain_layout=True)
    if isinstance(cache["k"], DTensor):
        out = _decode_dtensor(q, k_new, v_new, cache, window)
    else:
        out = decode_ops.decode_attention(q, k_new, v_new, cache["k"],
                                          cache["v"], cache["len"], window)
    cache["len"] = cache["len"] + 1
    return L.linear(p["wo"], out), cache


def _decode_dtensor(q, k_new, v_new, cache, window):
    """:func:`decode_attention`'s attention and slot write over a
    DTensor cache: the einsum core, on each device's (batch, head)
    block where :func:`_blocks` finds one, and the slot-mask write."""
    k_all, v_all = cache["k"], cache["v"]
    C = k_all.shape[1]
    live = decode_ref.live_slots(cache["len"], C, window)
    blocks = _blocks(q, k_new, v_new)
    core = _decode_core
    if blocks is not None and Shard(1) not in k_all.placements:
        # a cache sharded on its slots stays so (long_500k's)
        core = L.on_local(core, *blocks, "hhhhhm", "h")
    out = core(q, k_new, v_new, k_all, v_all, live)
    slots = torch.arange(C, dtype=torch.int32, device=q.device)[None, :]
    widx = (cache["len"] % C).long()
    hit = (slots == widx[:, None])[:, :, None, None]         # [B, C, 1, 1]
    _write_slot(k_all, k_new, hit)
    _write_slot(v_all, v_new, hit)
    return out


def _decode_core(q, k_new, v_new, k_all, v_all, live):
    """The token's attention over the C cached slots (``live`` [B, C])
    and itself: q [B, 1, H, hd], the new K/V [B, 1, KV, hd], the cache
    [B, C, KV, hd] → [B, 1, H·hd]."""
    B, _, H, hd = q.shape
    C, KV = k_all.shape[1], k_all.shape[2]
    qg = L.reshape(q, B, 1, KV, H // KV, hd)
    scores = _scores(qg, k_all, "bskgh,btkh->bkgst")
    scores = torch.where(live[:, None, None, None, :], scores, NEG_INF)
    self_score = _scores(qg, k_new.reshape(B, 1, KV, hd),
                         "bskgh,bskh->bkgs")
    all_scores = torch.cat([scores, self_score[..., None]], dim=-1)
    w = torch.softmax(all_scores, dim=-1).to(v_all.dtype)  # [B,KV,G,1,C+1]
    out = (torch.einsum("bkgst,btkh->bskgh", w[..., :C], v_all)
           + torch.einsum("bkgs,bskh->bskgh", w[..., C],
                          v_new.reshape(B, 1, KV, hd)))
    return out.reshape(B, 1, H * hd)


def _write_slot(cache_t, new, hit) -> None:
    """A DTensor cache [B, C, KV, hd] takes ``new`` [B, 1, KV, hd] where
    ``hit`` [B, C, 1, 1], in place.  ``new`` (one token) is first laid
    out as the cache is, replicated where the cache shards its slots, so
    the select needs no collective and keeps the cache's layout."""
    place = [Replicate() if isinstance(pl, Shard) and pl.dim == 1 else pl
             for pl in cache_t.placements]
    new = new.redistribute(cache_t.device_mesh, place)
    cache_t.copy_(torch.where(hit, new, cache_t))


def cross_decode_attention(p, cfg, x, enc_kv) -> torch.Tensor:
    """Cross-attention of one decoder token x [B, 1, D] over the
    encoder's precomputed {"k", "v"} [B, T, KV, hd]: O(T) a token."""
    B = x.shape[0]
    q = L.reshape(L.linear(p["wq"], x), B, 1, cfg.num_heads, cfg.hd)
    T = enc_kv["k"].shape[1]
    mask = torch.ones((B, 1, T), dtype=torch.bool, device=x.device)
    out = gqa_scores_mask(q, enc_kv["k"], enc_kv["v"], mask)
    return L.linear(p["wo"], out)
