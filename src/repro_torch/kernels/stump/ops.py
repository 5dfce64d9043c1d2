"""Public wrappers of the stump contraction: route by the tensors' device.

A CPU tensor (or ``interpret=True`` on any device) goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written kernel
and nowhere else — a failed build or launch raises.  ``launches``
counts kernel launches (the plain version never adds to it), so a run
can show that its path went through the kernel.

Both entry points take an optional leading task axis: ``x [c, F]`` or
``x [B, c, F]`` with per-task weights and thresholds — the batched
form is one launch for all B tasks.  No padding: the kernel masks the
ragged edges itself.  On the card a launch is the kernel's chain
(keys, radix sort, float64 prefix, search) on one stream, on scratch
of :func:`kernel.scratch_bytes`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.stump import ref

launches = 0


def stump_scores(x: torch.Tensor, wy: torch.Tensor, thetas: torch.Tensor,
                 interpret: bool | None = None) -> torch.Tensor:
    """S [(B,) F, Q] float32 — see :func:`ref.stump_scores_ref`."""
    global launches
    if x.dtype != torch.float32 or wy.dtype != torch.float32 \
            or thetas.dtype != torch.float32:
        raise TypeError("stump_scores takes float32 x, wy and thetas")
    if x.ndim not in (2, 3) or wy.ndim != x.ndim - 1 \
            or thetas.ndim != x.ndim or wy.shape != x.shape[:-1] \
            or thetas.shape[:-1] != x.shape[:-2] + x.shape[-1:]:
        raise ValueError(f"stump_scores shapes do not fit [(B,) c, F], "
                         f"[(B,) c] and [(B,) F, Q]: {tuple(x.shape)}, "
                         f"{tuple(wy.shape)}, {tuple(thetas.shape)}")
    if not (x.device == wy.device == thetas.device):
        raise ValueError("stump_scores inputs lie on different devices")
    if interpret or x.device.type == "cpu":
        if interpret is False:
            raise ValueError("the stump kernel needs CUDA tensors")
        return ref.stump_scores_ref(x, wy, thetas)
    from repro_torch.kernels.stump import kernel

    batched = x.ndim == 3
    xb, wyb, tb = (x, wy, thetas) if batched else (x[None], wy[None],
                                                    thetas[None])
    B, c, F = xb.shape
    Q = tb.shape[-1]
    if B > kernel.MAX_GRID_YZ or F > kernel.MAX_GRID_YZ or c >= 1 << 31 \
            or B * F >= 1 << 31:
        raise ValueError(f"the stump kernel's grid takes B and F up to "
                         f"{kernel.MAX_GRID_YZ}, B·F and c below 2^31, "
                         f"got B={B}, c={c}, F={F}")
    s = torch.empty((B, F, Q), dtype=torch.float32, device=x.device)
    if B and F and Q:
        kernel.launch(xb.contiguous(), wyb.contiguous(), tb.contiguous(), s,
                      torch.cuda.current_stream(x.device))
        launches += 1
    return s if batched else s[0]


def stump_errors(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                 thetas: torch.Tensor,
                 interpret: bool | None = None) -> torch.Tensor:
    """[(B,) F, Q, 2] weighted stump errors through the contraction;
    sign index 0 predicts +1 where x ≥ θ, index 1 predicts −1 there."""
    S = stump_scores(x, w * y.to(w.dtype), thetas, interpret=interpret)
    return ref.errors_from_scores(S, w, y)
