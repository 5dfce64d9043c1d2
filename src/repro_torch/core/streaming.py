"""The streaming tier's exact sort path (counterpart of
repro.core.streaming.sort_order).

Only the monolithic order is ported: the chunk-local runs, merges and
quantile sketches come with the streaming slice (ROADMAP queue 1,
item 10).
"""

from __future__ import annotations

import torch


def sort_order(x: torch.Tensor, chunk_size: int | None = None,
               n: int | None = None) -> torch.Tensor:
    """Stable argsort over the last axis (ties lower index first), of
    int32 points or float32 columns (NaN last), equal to
    ``jnp.argsort``.  ``n`` is accepted for signature parity
    with the reference; a set ``chunk_size`` raises."""
    del n
    if chunk_size is not None:
        raise NotImplementedError(
            "chunked sort orders (BoostConfig.chunk_size) come with the "
            "streaming slice, ROADMAP queue 1, item 10")
    return torch.argsort(x, dim=-1, stable=True)
