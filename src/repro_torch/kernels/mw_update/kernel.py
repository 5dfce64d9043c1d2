"""Bind the hand-written Hopper mw_update kernel.

The source is ``csrc/mw_update.cu``, built by
:mod:`repro_torch.kernels._build` (nvcc, sm_90a, ctypes) at first use.
Nothing here runs at import: the CPU tests import this module on hosts
with no nvcc.

The kernel is one launch.  A row of more than 16 tiles is several
CTAs, and the row's last CTA, found through an arrival counter per row,
folds the row's tile partials.  The counters and the partials are a
workspace kept here per (device, stream), grown as needed and never
freed: the counters start at 0 and every launch leaves them at 0.  Two
launches that overlapped would count into the same counters, so a
workspace belongs to one stream, on which launches run one after
another.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mw_update.cu"

_workspaces: dict[tuple[torch.device, int], tuple[torch.Tensor,
                                                  torch.Tensor]] = {}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _build.load(SOURCE)
    fn = lib.mw_update_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mw_update_tiles.argtypes = [ctypes.c_int]
    lib.mw_update_tiles.restype = ctypes.c_int
    return lib


def workspace(rows: int, tiles: int, device: torch.device,
              stream) -> tuple[torch.Tensor, torch.Tensor]:
    """(arrivals int32 [≥ rows], partials float32 [≥ rows·tiles]) of
    ``stream``; a larger one replaces it when a call needs more."""
    key = (device, stream.cuda_stream)
    arrivals, partials = _workspaces.get(key, (None, None))
    if arrivals is None or arrivals.numel() < rows:
        arrivals = torch.zeros((rows,), dtype=torch.int32, device=device)
    if partials is None or partials.numel() < rows * tiles:
        partials = torch.empty((rows * tiles,), dtype=torch.float32,
                               device=device)
    _workspaces[key] = arrivals, partials
    return arrivals, partials


def launch(hits, correct, alive, shift, new_hits, wsum, stream) -> None:
    """Enqueue one launch on ``stream``; raises on a launch error.

    All tensors are contiguous CUDA tensors on one device: hits and
    new_hits int32 [R, m], correct and alive bool [R, m], shift int32
    [R], wsum float32 [R]."""
    R, m = hits.shape
    lib = library()
    arrivals, partials = workspace(R, lib.mw_update_tiles(m), hits.device,
                                   stream)
    _build.check(lib.mw_update_launch(
        hits.data_ptr(), correct.data_ptr(), alive.data_ptr(),
        shift.data_ptr(), new_hits.data_ptr(), wsum.data_ptr(),
        partials.data_ptr(), arrivals.data_ptr(), R, m, stream.cuda_stream),
        "mw_update")
