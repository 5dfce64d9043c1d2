"""Bind the hand-written Hopper flash-attention kernel.

The source is ``csrc/flash_attention.cu``, built by
:mod:`repro_torch.kernels._build` (nvcc, sm_90a, ctypes) at first use.
Nothing here runs at import: the CPU tests import this module on hosts
with no nvcc.

The source has two routes, chosen by the input type: ``"wgmma"`` for
bf16 (TMA, a warp-specialised K/V ring and wgmma on the tensor cores;
the LM prefill's) and ``"cuda_cores"`` for float32 (float32 FMAs; wgmma
has no float32 form).  :func:`plan` holds each route's launch geometry
— tiles, ring stages, threads and shared-memory bytes — so that the
CPU tests reach it; the C entry point refuses a plan it does not build.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

import torch

from repro_torch.kernels import _build

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "flash_attention.cu")
# type code the C entry point takes for each input type, and its route
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "cuda_cores", torch.bfloat16: "wgmma"}
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448        # bytes of shared memory a block may use (sm_90)
# the wgmma route
TMA_COLUMNS = 64            # head-dim columns per TMA box: one 128-byte row
SMEM_ALIGN = 1024           # 128-byte swizzle atoms start 1024-aligned
BARRIER_BYTES = 128         # the Q barrier and a full/empty pair per stage
MAX_STAGES = 4
K_STEP = 16                 # wgmma's depth in bf16
# (b, h) pairs whose query tiles run together, longest first: their K/V
# (16 MiB at S = 2048, hd = 128) stay in the 50 MB L2 while every tile
# of the group reads them
HEAD_GROUP = 16
# the cuda_cores route
CORES_LDP = 64 + 4          # row stride of Pᵀ


@dataclasses.dataclass(frozen=True)
class TilePlan:
    route: str              # "wgmma" or "cuda_cores"
    block_q: int            # queries per CTA
    block_k: int            # keys per K/V tile
    stages: int             # K/V ring depth (1: staged through registers)
    threads: int
    smem_bytes: int
    head_dim_padded: int    # the head dim the products run over
    # wgmma shapes (m64 n k16) of S = QKᵀ and of O += P·V; () off wgmma
    mma_n: tuple[int, ...] = ()
    head_group: int = 1     # (b, h) pairs per group of the grid's order


def plan(hd: int, dtype: torch.dtype) -> TilePlan:
    """The launch geometry for head dim ``hd`` and input type ``dtype``.

    wgmma: BQ = 128 queries (two consumer warpgroups of 64), the head
    dim rounded up to whole TMA boxes of 64 columns, BK = 128 keys up
    to hd 128 and 64 above, each computed BC = 64 keys at a time (16 at
    hd 256, so that S and P fit in ptxas's 168 registers a thread beside
    O), and as many ring stages (at most 4) as fit beside the Q tile in
    the block's shared memory.  cuda_cores: 64
    queries and 64 keys, float32 tiles with padded rows; its grid is
    (B·H, query tiles), so ``head_group`` does not apply."""
    if dtype not in ROUTES:
        raise TypeError(f"the flash attention kernel takes "
                        f"{list(ROUTES)}, got {dtype}")
    if hd <= 0 or hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"the flash attention kernel takes a head_dim "
                         f"that is a multiple of 8 up to {MAX_HEAD_DIM}, "
                         f"got {hd}")
    if ROUTES[dtype] == "wgmma":
        hdp = -(-hd // TMA_COLUMNS) * TMA_COLUMNS
        bq, bk = 128, 128 if hdp <= 128 else 64
        bc = 64 if hdp <= 192 else 16
        q_bytes, stage_bytes = bq * hdp * 2, 2 * bk * hdp * 2
        room = SMEM_LIMIT - SMEM_ALIGN - q_bytes - BARRIER_BYTES
        stages = min(MAX_STAGES, room // stage_bytes)
        return TilePlan("wgmma", bq, bk, stages, 384,
                        SMEM_ALIGN + q_bytes + stages * stage_bytes
                        + BARRIER_BYTES, hdp, (bc, TMA_COLUMNS),
                        HEAD_GROUP)
    dpt = 1 << max(0, (-(-hd // 16) - 1).bit_length())   # columns a thread
    ld = hd + 4
    floats = 64 * ld + max(64 * ld, 64 * CORES_LDP) + 64 * 16 * dpt
    return TilePlan("cuda_cores", 64, 64, 1, 256, 4 * floats, 16 * dpt)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_longlong,
                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned base, as the kernel's
    vector loads and tensor maps need (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(q, k, v, out, window: int, stream) -> str:
    """Enqueue one launch on ``stream``; raises on a launch error.
    Returns the route it took.

    Contiguous CUDA tensors of one type on one device: q and out
    [B, S, H, hd], k and v [B, T, KV, hd]."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    p = plan(hd, q.dtype)
    _build.check(library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        H, KV, hd, window, hd ** -0.5, DTYPES[q.dtype], p.block_k,
        p.stages, p.head_group, p.smem_bytes, stream.cuda_stream),
        "flash_attention")
    return p.route
