"""Bind the hand-written Hopper flash-attention kernel.

The source is ``csrc/flash_attention.cu``, built by
:mod:`repro_torch.kernels._build` (nvcc, sm_90a, ctypes) at first use.
Nothing here runs at import: the CPU tests import this module on hosts
with no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import _build

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "flash_attention.cu")
# type code the C entry point takes for each input type
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base, as the kernel's
    vector loads need (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(q, k, v, out, window: int, stream) -> None:
    """Enqueue one launch on ``stream``; raises on a launch error.

    Contiguous CUDA tensors of one type on one device: q and out
    [B, S, H, hd], k and v [B, T, KV, hd]."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    _build.check(library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        H, KV, hd, window, hd ** -0.5, DTYPES[q.dtype],
        stream.cuda_stream), "flash_attention")
