"""Public wrappers of the tree histogram: route by the tensors' device.

A CPU tensor (or ``interpret=True`` on any device) goes to the plain
version in ``ref.py``; a CUDA tensor goes to the hand-written kernel
and nowhere else — a failed build or launch raises.  ``launches``
counts kernel launches (the plain version never adds to it), so a run
can show that its main path went through the kernel, and
``route_launches`` splits them by the kernel's route (``kernel.plan``:
``"sort"`` wherever a column's state fits in shared memory, the
engine's shapes included; ``"tiled"`` otherwise).  Both versions sum in
the order :func:`ref.xla_cpu_block` picks for the call's shape.

``chunk_size`` (the streaming tier) asks for the histogram accumulated
over point tiles, :func:`ref.node_histograms_chunked_ref`: on a CUDA
tensor the kernel's ``"chunked"`` route computes the whole function in
two launches (the tiles' partials, then their fold in tile order), and
``route_launches["chunked"]`` counts those calls.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.histogram import ref
from repro_torch.kernels.histogram.ref import (  # noqa: F401 (re-export)
    best_splits_per_feature, best_splits_ref, bin_index)

launches = 0
route_launches = {"sort": 0, "tiled": 0, "chunked": 0}


def node_histograms(x: torch.Tensor, w: torch.Tensor, wy: torch.Tensor,
                    bins: int, *, interpret: bool | None = None,
                    chunk_size: int | None = None):
    """(hist_w, hist_wy) [..., N, F, Q] float32 — see
    :func:`ref.node_histograms_ref`.

    x [..., c, F] float32; w, wy [..., N, c] float32 with the same
    leading axes (tasks, or tasks and players), all on one device.
    One kernel launch serves every (leading index, node) pair.
    ``chunk_size`` < c accumulates over point tiles of that many points
    (:func:`ref.node_histograms_chunked_ref`; two launches); ``None``
    or ≥ c is the monolithic function.
    """
    global launches
    if x.dtype != torch.float32 or w.dtype != torch.float32 \
            or wy.dtype != torch.float32:
        raise TypeError("node_histograms takes float32 x, w and wy")
    if x.ndim < 2 or w.shape != wy.shape or w.ndim != x.ndim \
            or w.shape[:-2] != x.shape[:-2] or w.shape[-1] != x.shape[-2]:
        raise ValueError(f"node_histograms shapes do not fit [..., c, F] "
                         f"and [..., N, c]: {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(wy.shape)}")
    if not (x.device == w.device == wy.device):
        raise ValueError("node_histograms inputs lie on different devices")
    if bins < 2 or bins & (bins - 1) or bins > 1 << 15:
        raise ValueError(f"bins must be a power of two in [2, 2^15], "
                         f"got {bins}")
    c, F = x.shape[-2:]
    N = w.shape[-2]
    if c == 0 or F == 0:
        raise ValueError("node_histograms needs c ≥ 1 points of F ≥ 1 "
                         "features")
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be ≥ 1, got {chunk_size}")
    chunked = chunk_size is not None and chunk_size < c
    block = ref.xla_cpu_block(chunk_size if chunked else c, N)
    if interpret or x.device.type == "cpu":
        if interpret is False:
            raise ValueError("the histogram kernel needs CUDA tensors")
        if chunked:
            return ref.node_histograms_chunked_ref(x, w, wy, bins,
                                                   chunk_size)
        return ref.node_histograms_ref(x, w, wy, bins, block)
    from repro_torch.kernels.histogram import kernel

    lead = x.shape[:-2]
    G = 1
    for s in lead:
        G *= s
    xc = x.reshape(G, c, F).contiguous()
    wc = w.reshape(G, N, c).contiguous()
    wyc = wy.reshape(G, N, c).contiguous()
    hw = torch.empty((G, N, F, bins), dtype=torch.float32, device=x.device)
    hwy = torch.empty_like(hw)
    stream = torch.cuda.current_stream(x.device)
    if chunked:
        part = torch.empty((2, G, -(-c // chunk_size), N, F, bins),
                           dtype=torch.float32, device=x.device)
        route = kernel.launch_chunked(xc, wc, wyc, part, hw, hwy, bins,
                                      chunk_size, block, stream)
    else:
        route = kernel.launch(xc, wc, wyc, hw, hwy, bins, block, stream)
    launches += 1
    route_launches[route] += 1
    shape = lead + (N, F, bins)
    return hw.reshape(shape), hwy.reshape(shape)


def best_node_splits(x: torch.Tensor, w: torch.Tensor, wy: torch.Tensor,
                     bins: int, *, interpret: bool | None = None,
                     chunk_size: int | None = None):
    """Histogram + reduce: (feat, q, err), each [..., N] — the split
    finding of one tree level in one call (``chunk_size`` as in
    :func:`node_histograms`)."""
    hw, hwy = node_histograms(x, w, wy, bins, interpret=interpret,
                              chunk_size=chunk_size)
    return best_splits_ref(hw, hwy)
