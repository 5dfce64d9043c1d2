"""Tie-pinned reductions — the port's replacements for bare
argmin/argmax (RL001).

Ties resolve to the LOWEST index along the reduced axis, spelled out
with min/where/arange as in ``repro.core.pinned``, so a selection on a
value surface that can tie (ERM candidate errors) picks the same index
on every device.
"""

from __future__ import annotations

import torch


def _pin_lowest(match: torch.Tensor, dim: int) -> torch.Tensor:
    """Lowest index along ``dim`` where ``match`` holds (int64)."""
    size = match.shape[dim]
    shape = [1] * match.ndim
    shape[dim] = size
    idx = torch.arange(size, device=match.device).reshape(shape)
    return torch.where(match, idx, size).amin(dim=dim)


def _as_ordered(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int32) if v.dtype == torch.bool else v


def pinned_argmin(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the minimum along ``dim``, ties pinned to the lowest
    index."""
    v = _as_ordered(v)
    dim = dim % v.ndim
    return _pin_lowest(v == v.amin(dim=dim, keepdim=True), dim)


def pinned_argmax(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the maximum along ``dim``, ties pinned to the lowest
    index."""
    v = _as_ordered(v)
    dim = dim % v.ndim
    return _pin_lowest(v == v.amax(dim=dim, keepdim=True), dim)
