"""Bind the hand-written Hopper stump kernel.

The source is ``csrc/stump.cu``, built by
:mod:`repro_torch.kernels._build` (nvcc, sm_90a, ctypes) at first use.
Nothing here runs at import: the CPU tests import this module on hosts
with no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

from repro_torch.kernels import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "stump.cu"
MAX_GRID_YZ = 65535     # CUDA's limit on a grid's y (F) and z (B) sizes


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _build.load(SOURCE)
    fn = lib.stump_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch(x, wy, thetas, s, stream) -> None:
    """Enqueue one launch on ``stream``; raises on a launch error.

    Contiguous float32 CUDA tensors on one device: x [B, c, F],
    wy [B, c], thetas and s [B, F, Q], with B, F, Q ≥ 1."""
    B, c, F = x.shape
    Q = thetas.shape[2]
    _build.check(library().stump_launch(
        x.data_ptr(), wy.data_ptr(), thetas.data_ptr(), s.data_ptr(), B, c,
        F, Q, stream.cuda_stream), "stump")
