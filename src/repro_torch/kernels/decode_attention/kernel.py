"""Bind the hand-written Hopper decode-attention kernel.

The source is ``csrc/decode_attention.cu``, built by
:mod:`repro_torch.kernels._build` (nvcc, sm_90a, ctypes) at first use.
Nothing here runs at import: the CPU tests import this module on hosts
with no nvcc.

:func:`plan` holds the launch geometry — the split of each sequence's
live slots over CTAs, the tile, the ring and the shared-memory bytes —
so that the CPU tests reach it; the C entry point refuses a plan it
does not build.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import pathlib

from repro_torch.kernels import _build

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "decode_attention.cu")
HEAD_DIMS = (64, 80, 128, 160)   # the head dims the source instantiates
MAX_GROUP = 8                    # query heads per KV head
BLOCK_N = 32                     # slots per tile (one a lane in the softmax)
STAGES = 4                       # cp.async ring depth
SMS = 132
# CTAs wanted at once: four an SM, so that the card holds enough loads
# in flight to reach its bandwidth and the last wave is short
TARGET_CTAS = 4 * SMS
MIN_SPLIT_SLOTS = 128            # slots a split reads at least


@dataclasses.dataclass(frozen=True)
class Plan:
    splits: int        # CTAs over one (sequence, KV head)'s live slots
    smem_bytes: int
    scratch_floats: int  # float32 partials of the splits (0 unsplit)


def smem_bytes(hd: int) -> int:
    """The ring of K and V tiles (rows padded by one 16-byte chunk, so
    eight rows at one column fall in eight bank groups), then the
    group's queries, a tile's weights and the running max, sum and
    rescale of each query head, all float32."""
    ring = STAGES * 2 * BLOCK_N * (hd // 8 + 1) * 16
    return ring + 4 * (MAX_GROUP * hd + MAX_GROUP * BLOCK_N + 3 * MAX_GROUP)


@functools.cache
def plan(B: int, KV: int, G: int, hd: int, C: int) -> Plan:
    """The launch for B sequences of KV heads with G query heads each,
    head dim ``hd`` and C cache slots.  The live length is read on the
    device, so the split is chosen from the shapes: as many splits of
    the C slots as bring the grid to ``TARGET_CTAS`` CTAs, each
    reading at least ``MIN_SPLIT_SLOTS`` of them."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the decode attention kernel takes a head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"the decode attention kernel takes 1 to "
                         f"{MAX_GROUP} query heads per KV head, got {G}")
    if B < 1 or KV < 1 or C < 1 or B > 65535 or KV > 65535:
        raise ValueError(f"the decode attention kernel takes 1 to 65535 "
                         f"sequences and KV heads and a cache of at least "
                         f"one slot, got B {B}, KV {KV}, C {C}")
    splits = max(1, min(math.ceil(TARGET_CTAS / (B * KV)),
                        C // MIN_SPLIT_SLOTS))
    scratch = B * KV * splits * G * (hd + 2) if splits > 1 else 0
    return Plan(splits, smem_bytes(hd), scratch)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _build.load(SOURCE)
    fn = lib.decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_longlong] * 2 + [ctypes.c_float, ctypes.c_longlong,
                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch(q, k_new, v_new, k_cache, v_cache, lens, out, scratch,
           window: int, p: Plan, stream) -> None:
    """Enqueue the plan's launches on ``stream``; raises on a launch
    error.  Tensors as the wrapper checked them: bf16 q [B, 1, H, hd],
    k_new and v_new [B, 1, KV, hd] and out [B, 1, H·hd], contiguous; the
    cache [B, C, KV, hd] with each slot's KV·hd values contiguous and
    k's strides equal to v's; lens int32 [B]; ``scratch`` float32 of
    ``p.scratch_floats`` (None unsplit)."""
    B, _, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    _build.check(library().decode_attention_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        B, C, H, KV, hd, window, p.splits, k_cache.stride(0),
        k_cache.stride(1), hd ** -0.5 * math.log2(math.e), p.smem_bytes,
        stream.cuda_stream), "decode_attention")
