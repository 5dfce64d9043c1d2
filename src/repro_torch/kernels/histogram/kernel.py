"""Bind the hand-written Hopper histogram kernel.

The source is ``csrc/histogram.cu``, built by
:mod:`repro_torch.kernels._build` (nvcc, sm_90a, ctypes) at first use.
Nothing here runs at import: the CPU tests import this module on hosts
with no nvcc.

The source has two routes, chosen by shape in :func:`plan`: ``"sort"``
(one CTA per (task, feature) column: a stable counting sort of the
column's points by bin, then one thread per (node, bin) output adding
its bin's points in index order) wherever the column's state fits in a
block's shared memory, which covers the engine's shapes; ``"tiled"``
(the kernel's first design: one thread per (feature, bin) output
walking every point) for the rest.  The streaming tier's chunked
histogram is a third route, ``"chunked"`` (:func:`chunk_plan`,
:func:`launch_chunked`): a tile's column sorted by bin as in ``"sort"``
per CTA, its partials written to a scratch, then folded in tile order
by a second launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import pathlib

from repro_torch.kernels import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "histogram.cu"
ROUTES = ("sort", "tiled", "chunked")   # "chunked" has its own C entry
SMEM_LIMIT = 232_448      # bytes of shared memory a block may use (sm_90)
SORT_WARPS = 8            # warps of one "sort" CTA
MAX_SORT_POINTS = 65535   # the sorted point indices are uint16
MAX_SORT_COLUMNS = 65535  # the grid's y (tasks) of the "sort" route
# the "tiled" route's staged tile: int16 bins [T, F] + w, wy [T]
TILED_SMEM_BYTES = 40 * 1024
MAX_TILE = 256


@dataclasses.dataclass(frozen=True)
class HistPlan:
    route: str              # "sort", "tiled" or "chunked"
    smem_bytes: int
    tile: int = 0           # points staged per pass ("tiled"), per tile
                            # ("chunked")


def sort_smem_bytes(N: int, c: int, bins: int) -> int:
    """Shared memory of one "sort" CTA: w and wy [N, c] float32, the
    per-warp bin slots and the bins' first slots int32, the points'
    bins and the sorted indices uint16 (``sorted::smem_bytes`` in the
    source; the C entry refuses any other size)."""
    return 4 * (2 * N * c + SORT_WARPS * bins + bins + 1) + 2 * 2 * c


def tile_rows(F: int) -> int:
    """Points the "tiled" route stages in shared memory per pass (int16
    bins plus two float weights each), at most :data:`MAX_TILE`."""
    return max(1, min(MAX_TILE, TILED_SMEM_BYTES // (2 * F + 8)))


@functools.lru_cache(maxsize=1024)
def plan(G: int, N: int, c: int, F: int, bins: int) -> HistPlan:
    """The route and launch geometry for G tasks (or task·player pairs)
    of N nodes, c points, F features and ``bins`` bins: "sort" wherever
    its CTA's state fits.  Memoized: a bucket program makes its plans
    ahead of its runs (``boost_attempt.prepare_kernels``)."""
    smem = sort_smem_bytes(N, c, bins)
    if c <= MAX_SORT_POINTS and G <= MAX_SORT_COLUMNS \
            and smem <= SMEM_LIMIT:
        return HistPlan("sort", smem)
    tile = tile_rows(F)
    return HistPlan("tiled", tile * (2 * F + 8), tile)


def chunk_smem_bytes(tile: int, bins: int) -> int:
    """Shared memory of one CTA of the "chunked" route's first launch:
    the per-warp bin slots and the bins' first slots int32, the tile's
    bins and sorted indices uint16 (``sorted::chunk_smem_bytes``)."""
    return 4 * (SORT_WARPS * bins + bins + 1) + 2 * 2 * tile


@functools.lru_cache(maxsize=1024)
def chunk_plan(G: int, c: int, tile: int, bins: int) -> HistPlan:
    """The "chunked" route for G columns of c points in tiles of
    ``tile``: its shared memory, or ValueError for a shape it does not
    take (a tile past 65535 points or past shared memory, or more than
    65535 tiles or task columns)."""
    smem = chunk_smem_bytes(tile, bins)
    if tile > MAX_SORT_POINTS or smem > SMEM_LIMIT \
            or -(-c // tile) > MAX_SORT_COLUMNS or G > MAX_SORT_COLUMNS:
        raise ValueError(
            f"the chunked histogram takes tiles of at most "
            f"{MAX_SORT_POINTS} points within {SMEM_LIMIT} bytes of "
            f"shared memory and at most {MAX_SORT_COLUMNS} tiles and "
            f"columns: tile {tile} ({smem} bytes), c {c}, G {G}")
    return HistPlan("chunked", smem, tile)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _build.load(SOURCE)
    fn = lib.histogram_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.histogram_chunked_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch(x, w, wy, hw, hwy, bins: int, block: int, stream) -> str:
    """Enqueue one launch on ``stream``; raises on a launch error.
    Returns the route it took.

    Contiguous float32 CUDA tensors on one device: x [G, c, F], w and
    wy [G, N, c], hw and hwy [G, N, F, bins]; ``block`` the k-block
    width of the summation order (ref.xla_cpu_block)."""
    G, c, F = x.shape
    N = w.shape[1]
    p = plan(G, N, c, F, bins)
    _build.check(library().histogram_launch(
        x.data_ptr(), w.data_ptr(), wy.data_ptr(), hw.data_ptr(),
        hwy.data_ptr(), G, N, c, F, bins, block, ROUTES.index(p.route),
        p.tile, p.smem_bytes, stream.cuda_stream), "histogram")
    return p.route


def launch_chunked(x, w, wy, part, hw, hwy, bins: int, tile: int,
                   block: int, stream) -> str:
    """Enqueue the "chunked" route on ``stream`` (two launches: the
    tiles' partials, then their fold in tile order); raises on a launch
    error.  Tensors as in :func:`launch`, plus ``part``, the partials'
    contiguous float32 scratch [2, G, T, N, F, bins] with T =
    ceil(c / tile); ``block`` the k-block width inside a tile
    (ref.xla_cpu_block(tile, N))."""
    G, c, F = x.shape
    N = w.shape[1]
    p = chunk_plan(G, c, tile, bins)
    _build.check(library().histogram_chunked_launch(
        x.data_ptr(), w.data_ptr(), wy.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), hw.data_ptr(), hwy.data_ptr(), G, N, c, F,
        bins, tile, block, p.smem_bytes, stream.cuda_stream),
        "histogram (chunked)")
    return p.route
