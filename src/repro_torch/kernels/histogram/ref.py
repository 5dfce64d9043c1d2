"""Plain PyTorch version of the weighted tree histogram (the kernel's
oracle), plus the split reductions that consume it.

Binning (defined once, as in the reference): features live in [0, 1)
and ``bin(x) = clip(floor(x·Q), 0, Q−1)``; NaN bins to 0, as XLA's
saturating float→int conversion does.

Summation order.  A histogram entry is a float32 sum of weights, and
the greedy grower's pinned argmin over the split errors turns its last
bit into a tree: the order is part of the function.  The reference
evaluates the one-hot contraction as an XLA:CPU ``dot``, batched over
tasks (or over tasks and players) in the engine's compiled step, with
the routed weights laid out [c, N] (``jnp.where(onnode, …).T``).  That
dot splits the c points into a few equal k-blocks — each summed left
to right from +0, the block sums added in order — and
:func:`xla_cpu_block` gives their width.  It was established by
comparing ``jax.jit(jax.vmap(...))`` of the reference's node-weight
construction and ``node_histograms_ref`` (jax 0.9.0 on an 8-core x86
host, the same with 1 and 4 cores) with every split on random
non-dyadic weights, for B = 2–16 tasks:

* one node (N = 1): left to right, at every c tried (100–800), for
  B ≥ 2 (a single task, B = 1, lowers to another order);
* N = 2, any F·Q from 32 to 256: left to right for c ≤ 384, two halves
  for c 400–640, four quarters at c = 800; at c = 1000 no split of
  this kind matched.

The engine's shapes are inside that range: the pooled coreset (k·c =
400 points, two halves at the second level) and the players' own
coresets (c = 100, left to right).  The CUDA kernel sums in exactly
this order, so the card and the CPU agree bit for bit whatever the rule
says; the rule only decides whether the port also equals the reference
on the CPU.  On dyadic weights every order is exact (the reference's
streaming contract), so there the rule cannot matter.  The split
surface's prefix sums over Q follow XLA:CPU's scan order
(:func:`repro_torch.core.fp32.cumsum`).
"""

from __future__ import annotations

import torch

from repro_torch.core import fp32
from repro_torch.core.pinned import pinned_argmin


def bin_index(x: torch.Tensor, bins: int) -> torch.Tensor:
    """[..., F] float32 → int64 bin ids in [0, bins)."""
    v = torch.floor(x * float(bins))
    v = torch.where(torch.isnan(v), 0.0, v.clamp(0.0, float(bins - 1)))
    return v.long()


def xla_cpu_block(c: int, nodes: int) -> int:
    """Width of the k-blocks XLA:CPU sums an [N, c]·[c, F·Q] histogram
    contraction in (module doc); ≥ c means left to right."""
    if nodes == 1 or c < 400:
        return c
    parts = 1 << ((c // 200).bit_length() - 1)
    return -(-c // parts)


def node_histograms_ref(x: torch.Tensor, w: torch.Tensor,
                        wy: torch.Tensor, bins: int, block: int):
    """Per-node weighted feature histograms.

    x [..., c, F] float32; w, wy [..., N, c] float32 (the same leading
    axes) → (hist_w, hist_wy) [..., N, F, Q] float32 with
    ``hist[n, f, q] = Σ_i w[n, i]·1[bin(x[i, f]) == q]``, summed over i
    in k-blocks of ``block`` (module doc).
    """
    c, F = x.shape[-2:]
    blk = max(1, min(int(block), c))
    nb = -(-c // blk)
    pad = nb * blk - c
    b = bin_index(x, bins)                                   # [..., c, F]
    if pad:
        b = torch.nn.functional.pad(b, (0, 0, 0, pad), value=-1)
        w = torch.nn.functional.pad(w, (0, pad))
        wy = torch.nn.functional.pad(wy, (0, pad))
    lead = b.shape[:-2]
    q = torch.arange(bins, device=x.device)
    # onehot [..., nb, blk, F, Q]; weights [..., N, nb, blk]
    onehot = (b.reshape(lead + (nb, blk, F))[..., None] == q)
    wb = w.reshape(w.shape[:-1] + (nb, blk))
    wyb = wy.reshape(wy.shape[:-1] + (nb, blk))
    out = []
    for v in (wb, wyb):
        part = torch.zeros(v.shape[:-1] + (F, bins), dtype=torch.float32,
                           device=x.device)                 # [..., N, nb, F, Q]
        for j in range(blk):
            hit = onehot[..., None, :, j, :, :]              # [..., 1, nb, F, Q]
            part = part + torch.where(hit, v[..., j, None, None], 0.0)
        total = torch.zeros_like(part[..., 0, :, :])
        for k in range(nb):
            total = total + part[..., k, :, :]
        out.append(total)
    return out[0], out[1]


def node_histograms_chunked_ref(x: torch.Tensor, w: torch.Tensor,
                                wy: torch.Tensor, bins: int,
                                chunk_size: int):
    """:func:`node_histograms_ref` accumulated over point tiles (the
    reference's streaming-tier histogram, ``lax.scan`` over tiles).

    Same arguments and result as :func:`node_histograms_ref` but for
    ``chunk_size`` in place of the order: the points are padded with
    zero rows and zero weights to a multiple of the tile, each tile's
    histogram is summed in the order ``xla_cpu_block(chunk_size, N)``
    gives, and the tiles fold in order into an accumulator that starts
    at +0.0 (so a tile sum of −0.0 becomes +0.0, and a padded row adds
    +0.0 into bin 0).  ``chunk_size ≥ c`` is the monolithic function.
    On dyadic weights every order is exact, so the result equals the
    monolithic one bit for bit.
    """
    c, F = x.shape[-2:]
    N = w.shape[-2]
    if chunk_size >= c:
        return node_histograms_ref(x, w, wy, bins, xla_cpu_block(c, N))
    t = chunk_size
    T = -(-c // t)
    pad = T * t - c
    lead = x.shape[:-2]
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
    wp = torch.nn.functional.pad(w, (0, pad))
    wyp = torch.nn.functional.pad(wy, (0, pad))
    # tiles as a leading axis: x [..., T, t, F], w [..., T, N, t]
    xt = xp.reshape(lead + (T, t, F))
    wt = wp.reshape(lead + (N, T, t)).transpose(-2, -3)
    wyt = wyp.reshape(lead + (N, T, t)).transpose(-2, -3)
    hw_t, hwy_t = node_histograms_ref(xt, wt, wyt, bins,
                                      xla_cpu_block(t, N))
    hw = torch.zeros(lead + (N, F, bins), dtype=torch.float32,
                     device=x.device)
    hwy = torch.zeros_like(hw)
    for k in range(T):
        hw = hw + hw_t[..., k, :, :, :]
        hwy = hwy + hwy_t[..., k, :, :, :]
    return hw, hwy


def split_err_surface(hist_w: torch.Tensor,
                      hist_wy: torch.Tensor) -> torch.Tensor:
    """Two-leaf weighted error of every (feature, bin) split:
    ``[..., N, F, Q]`` → ``[..., N, F, Q]``, with L = bins < q and
    R = bins ≥ q (q = 0 the everything-right split)."""
    cw = fp32.cumsum(hist_w)
    cwy = fp32.cumsum(hist_wy)
    left_w = cw - hist_w
    left_wy = cwy - hist_wy
    tot_w = cw[..., -1:]
    tot_wy = cwy[..., -1:]
    return (0.5 * (left_w - left_wy.abs())
            + 0.5 * ((tot_w - left_w) - (tot_wy - left_wy).abs()))


def best_splits_ref(hist_w: torch.Tensor, hist_wy: torch.Tensor):
    """Best (feature, bin) split per node: ``[..., N, F, Q]`` →
    (feat [..., N] int64, q [..., N] int64, err [..., N] float32), ties
    pinned to the lowest flat (feature, bin) index."""
    F, Q = hist_w.shape[-2:]
    err = split_err_surface(hist_w, hist_wy)
    flat = err.reshape(err.shape[:-2] + (F * Q,))
    j = pinned_argmin(flat)
    errmin = torch.gather(flat, -1, j[..., None])[..., 0]
    return j // Q, j % Q, errmin


def best_splits_per_feature(hist_w: torch.Tensor, hist_wy: torch.Tensor):
    """Best bin of every feature (the voting mode's local proposals):
    ``[..., N, F, Q]`` → (q [..., N, F] int64, err [..., N, F])."""
    err = split_err_surface(hist_w, hist_wy)
    return pinned_argmin(err), err.amin(dim=-1)
