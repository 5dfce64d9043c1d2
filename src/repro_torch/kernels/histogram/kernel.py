"""Bind the hand-written Hopper histogram kernel.

The source is ``csrc/histogram.cu``, built by
:mod:`repro_torch.kernels._build` (nvcc, sm_90a, ctypes) at first use.
Nothing here runs at import: the CPU tests import this module on hosts
with no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

from repro_torch.kernels import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "histogram.cu"
SMEM_BYTES = 40 * 1024   # staged tile: int16 bins [T, F] + w, wy [T]
MAX_TILE = 256


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _build.load(SOURCE)
    fn = lib.histogram_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def tile_rows(F: int) -> int:
    """Points staged in shared memory per pass (int16 bins plus two
    float weights each), at most :data:`MAX_TILE`."""
    return max(1, min(MAX_TILE, SMEM_BYTES // (2 * F + 8)))


def launch(x, w, wy, hw, hwy, bins: int, block: int, stream) -> None:
    """Enqueue one launch on ``stream``; raises on a launch error.

    Contiguous float32 CUDA tensors on one device: x [G, c, F], w and
    wy [G, N, c], hw and hwy [G, N, F, bins]; ``block`` the k-block
    width of the summation order (ref.xla_cpu_block)."""
    G, c, F = x.shape
    N = w.shape[1]
    _build.check(library().histogram_launch(
        x.data_ptr(), w.data_ptr(), wy.data_ptr(), hw.data_ptr(),
        hwy.data_ptr(), G, N, c, F, bins, block, tile_rows(F),
        stream.cuda_stream), "histogram")
