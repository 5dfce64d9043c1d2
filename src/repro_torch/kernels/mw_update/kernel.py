"""Bind the hand-written Hopper mw_update kernel.

The source is ``csrc/mw_update.cu``, built by
:mod:`repro_torch.kernels._build` (nvcc, sm_90a, ctypes) at first use.
Nothing here runs at import: the CPU tests import this module on hosts
with no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

from repro_torch.kernels import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mw_update.cu"


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _build.load(SOURCE)
    fn = lib.mw_update_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch(hits, correct, alive, shift, new_hits, partials, wsum,
           stream) -> None:
    """Enqueue both passes on ``stream``; raises on a launch error.

    All tensors are contiguous CUDA tensors on one device: hits and
    new_hits int32 [R, m], correct and alive bool [R, m], shift int32
    [R], partials float32 [R, ⌈m/BLOCK⌉], wsum float32 [R]."""
    R, m = hits.shape
    _build.check(library().mw_update_launch(
        hits.data_ptr(), correct.data_ptr(), alive.data_ptr(),
        shift.data_ptr(), new_hits.data_ptr(), partials.data_ptr(),
        wsum.data_ptr(), R, m, stream.cuda_stream), "mw_update")
