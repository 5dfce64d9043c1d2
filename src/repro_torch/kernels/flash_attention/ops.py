"""Public wrapper of flash attention: route by the tensors' device.

Keeps the reference's model layout: q [B, S, H, hd], k/v [B, T, KV, hd]
→ [B, S, H, hd] in q's type.  A CPU tensor (or ``interpret=True`` on
any device) goes to the plain version in ``ref.py``; a CUDA tensor goes
to the hand-written kernel and nowhere else — a failed build or launch
raises.  ``launches`` counts kernel launches (the plain version never
adds to it), so a run can show that its main path went through the
kernel, and ``route_launches`` splits them by the kernel's route
(``kernel.ROUTES``: ``"wgmma"`` for bf16, ``"cuda_cores"`` for
float32).  The kernel reads the model layout directly and masks the
ragged edge itself, so nothing is padded or transposed on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ref

launches = 0
route_launches = {"wgmma": 0, "cuda_cores": 0}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, *,
                    interpret: bool | None = None) -> torch.Tensor:
    """Causal GQA attention, optionally over a sliding window — see
    :func:`ref.flash_attention_ref` for what it computes."""
    global launches
    if not causal:
        raise ValueError("flash_attention takes causal attention only, as "
                         "the reference's wrapper does")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q [B, S, H, hd] and k, v "
                         f"[B, T, KV, hd]: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H a multiple of KV)")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention inputs lie on different devices")
    if window < 0:
        raise ValueError(f"window must be ≥ 0, got {window}")
    if interpret or q.device.type == "cpu":
        if interpret is False:
            raise ValueError("the flash attention kernel needs CUDA tensors")
        out = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=True,
                                      window=window)
        return out.transpose(1, 2)
    from repro_torch.kernels.flash_attention import kernel

    if q.dtype not in kernel.DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"the flash attention kernel takes q, k and v of "
                        f"one type in {list(kernel.DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    kernel.plan(hd, q.dtype)                 # raises on a head dim it refuses
    q, k, v = (kernel.aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() and k.shape[1]:
        route = kernel.launch(q, k, v, out, window,
                              torch.cuda.current_stream(q.device))
        launches += 1
        route_launches[route] += 1
    return out
