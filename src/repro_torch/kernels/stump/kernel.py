"""Bind the hand-written Hopper stump kernel.

The source is ``csrc/stump.cu``, built by
:mod:`repro_torch.kernels._build` (nvcc, sm_90a, ctypes) at first use:
a key pass, a radix sort of every column by tiles, a float64 prefix of
wy, and a binary search per threshold.  :func:`plan` picks the search's
sample stride and the key pass's tile; the source sizes the scratch,
which the wrapper allocates.  Nothing here runs at import: the CPU
tests import this module on hosts with no nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

from repro_torch.kernels import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "stump.cu"
MAX_GRID_YZ = 65535     # CUDA's limit on a grid's y (F) and z (B) sizes
MAX_SAMPLES = 8192      # sampled keys of one column in shared memory (32 KB)
MIN_SAMPLE_LOG2 = 3     # every 8th key: one group of 8 records from L2
MAX_FEATURE_TILE_LOG2 = 5


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs: ``sample_log2`` (every 2^sl-th sorted key is
    a top level of the search, at most :data:`MAX_SAMPLES` of them),
    ``samples`` per column and ``feature_tile_log2`` (the key pass's
    tile width, a power of two ≥ F up to 32)."""

    sample_log2: int
    samples: int
    feature_tile_log2: int


def plan(B: int, c: int, F: int) -> Plan:
    """The plan of a call on x [B, c, F] (the C entry refuses others)."""
    sl = MIN_SAMPLE_LOG2
    while -(-c // (1 << sl)) > MAX_SAMPLES:
        sl += 1
    tf = 0
    while (1 << tf) < F and tf < MAX_FEATURE_TILE_LOG2:
        tf += 1
    return Plan(sl, -(-c // (1 << sl)), tf)


def scratch_bytes(B: int, c: int, F: int) -> int:
    """Scratch bytes of one call, as the source lays them out (on a
    host with nvcc: this builds the kernel)."""
    return library().stump_scratch_bytes(B, c, F, plan(B, c, F).sample_log2)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _build.load(SOURCE)
    fn = lib.stump_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.stump_scratch_bytes.argtypes = [ctypes.c_int] * 4
    lib.stump_scratch_bytes.restype = ctypes.c_int64
    return lib


def launch(x, wy, thetas, s, stream) -> None:
    """Enqueue the kernels on ``stream``; raises on a launch error.

    Contiguous float32 CUDA tensors on one device: x [B, c, F],
    wy [B, c], thetas and s [B, F, Q], with B, F, Q ≥ 1.  The scratch
    (:func:`scratch_bytes`) is allocated here, on the stream's
    allocator."""
    import torch

    B, c, F = x.shape
    Q = thetas.shape[2]
    p = plan(B, c, F)
    scratch = torch.empty((max(scratch_bytes(B, c, F), 128),),
                          dtype=torch.uint8, device=x.device)
    _build.check(library().stump_launch(
        x.data_ptr(), wy.data_ptr(), thetas.data_ptr(), s.data_ptr(),
        scratch.data_ptr(), B, c, F, Q, p.feature_tile_log2, p.sample_log2,
        stream.cuda_stream), "stump")
