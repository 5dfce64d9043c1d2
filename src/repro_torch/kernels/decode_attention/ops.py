"""Public wrapper of decode attention: route by the tensors' device.

One new token per sequence attends over the live slots of its ring
cache and over itself; then its K/V is written at slot ``len % C``, in
place.  A CPU tensor (or ``interpret=True`` on any device) goes to the
plain version in ``ref.py``; a CUDA tensor goes to the hand-written
kernel and nowhere else — a failed build or launch raises.
``launches`` counts the calls that ran the kernel (the plain version
never adds to it; a call whose plan splits the slots enqueues a second,
small combine launch as well).  The kernel reads the cache in place and
``len`` on the device, so the wrapper only checks shapes, types and
strides and allocates the output and, for a split, the partials.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ref

launches = 0


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lens: torch.Tensor,
                     window: int = 0, *,
                     interpret: bool | None = None) -> torch.Tensor:
    """q [B, 1, H, hd], k_new/v_new [B, 1, KV, hd], the cache
    [B, C, KV, hd] and its lengths int32 [B] → [B, 1, H·hd]; see
    :func:`ref.decode_attention_ref` for what it computes.  The kernel
    takes bf16 throughout and keeps the softmax's weights in float32
    in the weighted sum, where the plain version rounds them to bf16."""
    global launches
    B, S, H, hd = q.shape if q.ndim == 4 else (0, 0, 0, 0)
    C, KV = k_cache.shape[1:3] if k_cache.ndim == 4 else (0, 0)
    if (not B or S != 1 or not KV or k_new.shape != (B, 1, KV, hd)
            or v_new.shape != k_new.shape or k_cache.shape != (B, C, KV, hd)
            or v_cache.shape != k_cache.shape or lens.shape != (B,) or H % KV):
        raise ValueError(
            f"decode_attention takes q [B, 1, H, hd], k_new/v_new "
            f"[B, 1, KV, hd], the cache [B, C, KV, hd] and lens [B] (H a "
            f"multiple of KV): {tuple(q.shape)}, {tuple(k_new.shape)}, "
            f"{tuple(v_new.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}, {tuple(lens.shape)}")
    if lens.dtype != torch.int32:
        raise TypeError(f"decode_attention takes int32 lens, got {lens.dtype}")
    dev = q.device
    if not (k_new.device == v_new.device == k_cache.device == v_cache.device
            == lens.device == dev):
        raise ValueError("decode_attention inputs lie on different devices")
    if window < 0:
        raise ValueError(f"window must be ≥ 0, got {window}")
    if interpret or dev.type == "cpu":
        if interpret is False:
            raise ValueError("the decode attention kernel needs CUDA tensors")
        return ref.decode_attention_ref(q, k_new, v_new, k_cache, v_cache,
                                        lens, window)
    from repro_torch.kernels.decode_attention import kernel

    bf16 = torch.bfloat16
    if not (q.dtype == k_new.dtype == v_new.dtype == k_cache.dtype
            == v_cache.dtype == bf16):
        raise TypeError(f"the decode attention kernel takes bf16 q, K/V and "
                        f"cache, got {q.dtype}, {k_new.dtype}, "
                        f"{v_new.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    st = k_cache.stride()
    if (not (q.is_contiguous() and k_new.is_contiguous()
             and v_new.is_contiguous() and lens.is_contiguous())
            or st[3] != 1 or st[2] != hd or v_cache.stride() != st
            or st[0] % 8 or st[1] % 8
            or any(t.data_ptr() % 16 for t in (q, k_new, v_new, k_cache,
                                               v_cache))):
        raise ValueError("the decode attention kernel takes contiguous q and "
                         "new K/V, and a cache whose slots each hold KV·hd "
                         "contiguous values, k's strides equal to v's, "
                         "16-byte aligned")
    p = kernel.plan(B, KV, H // KV, hd, C)
    out = torch.empty((B, 1, H * hd), dtype=bf16, device=dev)
    scratch = (torch.empty(p.scratch_floats, dtype=torch.float32, device=dev)
               if p.splits > 1 else None)
    kernel.launch(q, k_new, v_new, k_cache, v_cache, lens, out, scratch,
                  window, p, torch.cuda.current_stream(dev))
    launches += 1
    return out
