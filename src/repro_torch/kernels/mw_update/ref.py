"""Plain PyTorch version of the fused MW update (the kernel's oracle).

The same function as the CUDA kernel, summed in the kernel's exact
order so that the two agree bit for bit on every device: each block of
``BLOCK`` elements is read as ``ITEMS`` strided passes of ``THREADS``
lanes, each lane sums its items left to right, a warp folds its 32
lanes with a shuffle-down tree, the block adds its warps left to right,
and each row's block partials are folded the same way by one warp.
"""

from __future__ import annotations

import torch

THREADS = 256            # lanes of one block (the kernel's 128 threads
                         # add two lanes each)
ITEMS = 8                # elements each lane reads, THREADS apart
BLOCK = THREADS * ITEMS  # elements per block partial
WARP = 32


def pow2_neg(h: torch.Tensor) -> torch.Tensor:
    """2^−h as float32, exact and built from its bits as the kernel
    builds 2^(shift − hits) (h = hits − shift, clamped to [0, 150]):
    normal down to 2^−126, subnormal to 2^−149, then 0."""
    h = h.clamp(0, 150)
    normal = (127 - h) << 23
    sub = torch.where(h <= 149, 1 << (149 - h).clamp(0, 22), 0)
    return torch.where(h <= 126, normal, sub).view(torch.float32)


def _seq(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right sum over the last axis, from +0."""
    acc = x[..., 0] + 0.0
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _warp_fold(v: torch.Tensor) -> torch.Tensor:
    """Lane 0 of a shuffle-down tree over the last axis (32 lanes)."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def block_partials(w: torch.Tensor) -> torch.Tensor:
    """[R, m] weights → [R, ⌈m/BLOCK⌉] block sums in the kernel's order."""
    R, m = w.shape
    nb = -(-m // BLOCK)
    w = torch.nn.functional.pad(w, (0, nb * BLOCK - m))
    lanes = _seq(w.reshape(R, nb, ITEMS, THREADS).transpose(-1, -2))
    warps = _warp_fold(lanes.reshape(R, nb, THREADS // WARP, WARP))
    return _seq(warps)


def row_sums(partials: torch.Tensor) -> torch.Tensor:
    """[R, nb] block partials → [R] row sums in the kernel's order."""
    R, nb = partials.shape
    n32 = -(-nb // WARP)
    p = torch.nn.functional.pad(partials, (0, n32 * WARP - nb))
    return _warp_fold(_seq(p.reshape(R, n32, WARP).transpose(-1, -2)))


def mw_update_ref(hits: torch.Tensor, correct: torch.Tensor,
                  alive: torch.Tensor, shift: torch.Tensor | None = None):
    """hits int32 [R, m]; correct, alive bool [R, m]; shift int32 [R]
    (0 if None) → (new_hits = hits + 1[correct ∧ alive] int32 [R, m],
    wsum = Σ_alive 2^(shift − new_hits) float32 [R])."""
    new_hits = hits + (correct & alive).to(torch.int32)
    exp = new_hits if shift is None else new_hits - shift[:, None]
    w = torch.where(alive, pow2_neg(exp), 0.0)
    return new_hits, row_sums(block_partials(w))
