"""Mergeable streaming summaries, the large-m tier (counterpart of
repro.core.streaming).

Two constructions, both built from one primitive, a chunk-local sorted
run ``(values ascending, original index)`` merged by ranks:

1. :func:`sort_order`, the EXACT path.  Each ``chunk_size`` tile of
   the last axis is sorted on its own (the packed int32 single-operand
   sort when the domain certifies ``n·t < 2³¹``), and adjacent runs are
   merged pairwise by two searchsorted ranks and two scatters, ties
   lower index first.  The result is the stable argsort bit for bit,
   so ``BoostConfig.chunk_size`` changes nothing downstream in the three
   engines.  Every function works over leading axes (the engines pass
   ``[B, k, mloc]``, which the reference vmaps).
2. :class:`QuantileSketch`, the BOUNDED-MEMORY path: a capacity-``cap``
   summary of a weighted labelled stream whose entries each stand for a
   segment of the x-sorted sample, merged and compressed in a
   logarithmic level buffer (:func:`build_sketch`).  The sketch carries
   the price of each approximation it made (``err``/``gran``), and
   :func:`coreset_bound` turns that into the sup-loss ε of its coreset.

Floats follow the reference's rounding (core/fp32.py): prefix sums in
XLA:CPU's block-16 scan order, sums in its window-32 order, the MW
weights its exp2 values; so the sketch's ``err``/``gran`` fields and the
indices it selects equal the reference's bit for bit.  Ranks compare
order keys (:func:`_order_keys`): ``-0.0`` equals ``+0.0`` and every NaN
sorts last, as ``jnp.argsort`` and ``jnp.searchsorted`` order them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import fp32

# The reference's default tile: a chunk this size fits its packed int32
# single-operand sort for domains up to n = 2^16 (n·chunk < 2^31).
DEFAULT_CHUNK = 1 << 14

# ---------------------------------------------------------------------------
# The primitive: merge two sorted runs without a comparator sort.
# ---------------------------------------------------------------------------

def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in the order ``jnp.argsort`` sorts ``x`` in: integers
    as they are; floats by their bits made monotone, ``-0.0`` as
    ``+0.0`` and every NaN above ``+inf`` (all NaNs equal)."""
    if not torch.is_floating_point(x):
        return x.long()
    xf = x.float()
    xf = torch.where(xf == 0, torch.zeros_like(xf), xf)       # -0 → +0
    bits = xf.view(torch.int32).long()
    key = torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    return torch.where(torch.isnan(xf), torch.full_like(key, 1 << 31), key)


def merge_sorted(xa, ia, xb, ib):
    """Merge two sorted runs along the last axis; ties place a first.

    xa [..., na] and xb [..., nb] ascending, each with its payload
    (ia, ib) in the same order → (x, i) [..., na + nb] ascending, equal
    runs a before b (and within each input in input order).  When every
    a-index is below every b-index (adjacent chunks merged in chunk
    order, the only way :func:`merge_runs` builds runs) that tie rule
    is the stable sort's.  a[j] lands at ``j + rank_left(b, a[j])`` and
    b[j] at ``j + rank_right(a, b[j])``: distinct positions, no sort.
    """
    ka, kb = _order_keys(xa).contiguous(), _order_keys(xb).contiguous()
    na, nb = xa.shape[-1], xb.shape[-1]
    pa = torch.arange(na, device=xa.device) \
        + torch.searchsorted(kb, ka, side="left")
    pb = torch.arange(nb, device=xb.device) \
        + torch.searchsorted(ka, kb, side="right")
    shape = xa.shape[:-1] + (na + nb,)
    x = torch.empty(shape, dtype=xa.dtype, device=xa.device)
    i = torch.empty(shape, dtype=ia.dtype, device=ia.device)
    x.scatter_(-1, pa, xa).scatter_(-1, pb, xb)
    i.scatter_(-1, pa, ia).scatter_(-1, pb, ib)
    return x, i


def _chunk_order(xc: torch.Tensor, n: int | None) -> torch.Tensor:
    """Stable sort order of one tile along the last axis: the packed
    single-operand int32 sort (point·t + index, unique keys) when the
    caller certifies an integer domain [0, n) with n·t < 2³¹, else the
    stable argsort."""
    t = xc.shape[-1]
    if (n is not None and 0 < n * t < 2 ** 31
            and not torch.is_floating_point(xc)):
        keys = xc.to(torch.int32) * t \
            + torch.arange(t, dtype=torch.int32, device=xc.device)
        return (torch.sort(keys, dim=-1).values % t).long()
    return torch.argsort(xc, dim=-1, stable=True)


def chunk_runs(x: torch.Tensor, chunk_size: int, n: int | None = None):
    """Chunk-local sorted runs of ``x`` [..., m] in chunk order: a list
    of (values ascending, original int64 indices), one per tile."""
    m = x.shape[-1]
    runs = []
    for s in range(0, m, chunk_size):
        xc = x[..., s:min(s + chunk_size, m)]
        o = _chunk_order(xc, n)
        runs.append((torch.gather(xc, -1, o), o + s))
    return runs


def merge_runs(runs):
    """Pairwise reduction of adjacent sorted runs, in order (adjacency
    keeps the lower-index-first tie rule global, see merge_sorted)."""
    while len(runs) > 1:
        runs = [merge_sorted(*runs[i], *runs[i + 1])
                if i + 1 < len(runs) else runs[i]
                for i in range(0, len(runs), 2)]
    return runs[0]


def sort_order(x: torch.Tensor, chunk_size: int | None = None,
               n: int | None = None) -> torch.Tensor:
    """Stable argsort over the last axis (ties lower index first), of
    int32 points or float32 columns (NaN last), equal to
    ``jnp.argsort``; int64 indices.

    ``chunk_size=None`` (or ≥ m) is the monolithic stable argsort.  With
    a chunk size no sort larger than one tile runs: tiles are sorted
    apart (packed under the ``n`` certificate) and merged by ranks, and
    the result is the same order bit for bit."""
    m = x.shape[-1]
    if chunk_size is None or chunk_size >= m:
        return torch.argsort(x, dim=-1, stable=True)
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be ≥ 1, got {chunk_size}")
    return merge_runs(chunk_runs(x, chunk_size, n))[1]


# ---------------------------------------------------------------------------
# Bounded-memory quantile-coreset sketch.
# ---------------------------------------------------------------------------

class QuantileSketch(NamedTuple):
    """Capacity-bounded mergeable summary of a weighted labelled sample
    (the reference's fields and meaning).

    Entry j stands for a contiguous segment of the x-sorted sample:
    ``x[j]`` is the segment's last member (the merge key), ``wp[j]`` /
    ``wn[j]`` its positive / negative label mass, ``ip[j]`` / ``i_n[j]``
    the global index of a genuinely positive / negative member whose
    label rank equals the segment end's cumulative label mass (−1 while
    the label has not appeared).  ``err_*`` bounds how far a recorded
    cumulative label mass may sit from its true rank (merging adds the
    partner's granularity), ``gran_*`` is the largest segment mass per
    label (set by compression)."""

    x: torch.Tensor       # [cap] segment-end points, ascending
    wp: torch.Tensor      # [cap] float32 segment mass with label +1
    wn: torch.Tensor      # [cap] float32 segment mass with label −1
    ip: torch.Tensor      # [cap] int64 positive representative (−1 none)
    i_n: torch.Tensor     # [cap] int64 negative representative (−1 none)
    err_p: torch.Tensor   # float32 rank-error bound, positive mass
    err_n: torch.Tensor   # float32 rank-error bound, negative mass
    gran_p: torch.Tensor  # float32 largest positive segment mass
    gran_n: torch.Tensor  # float32 largest negative segment mass


def sketch_weights(hits: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The engines' unnormalised MW weights (quantile levels are
    scale-free): 2^−(hits − least alive hits), clipped to [0, 126], 0 on
    dead rows — the reference's exp2 bits (:func:`fp32.exp2_neg`)."""
    big = torch.iinfo(torch.int64).max
    hmin = torch.where(alive, hits.long(), big).amin(dim=-1, keepdim=True)
    shift = (hits.long() - hmin).clamp(0, 126)
    return torch.where(alive, fp32.exp2_neg(shift), 0.0)


def _rep_floor(dtype: torch.dtype):
    """Key of an absent representative: below every real point, so a
    forward-fill max never picks it."""
    if dtype.is_floating_point:
        return -torch.inf
    return torch.iinfo(dtype).min


def _ffill_max(xv: torch.Tensor, iv: torch.Tensor):
    """Running max-by-key forward fill along the last axis: position e
    gets the (key, payload) pair with the largest key among entries ≤ e,
    ties to the later entry (the reference's associative scan; a running
    max is exact, so its order does not matter).  Keys and positions
    pack into one int64 so that ``cummax`` breaks the ties."""
    t = xv.shape[-1]
    pos = torch.arange(t, device=xv.device)
    packed = _order_keys(xv) * (1 << 31) + pos
    _, at = torch.cummax(packed, dim=-1)
    return torch.gather(xv, -1, at), torch.gather(iv, -1, at)


def sketch_from_chunk(x, y, w, start, n: int | None = None) -> QuantileSketch:
    """Exact single-point-segment sketch of one chunk: x [t] points,
    y [t] ±1 labels, w [t] ≥ 0 weights, ``start`` the chunk's offset in
    the whole sample (indices are global).  Sorted locally (packed
    under the same ``n`` certificate as :func:`sort_order`); err and
    gran are zero."""
    o = _chunk_order(x, n)
    xs, ws = x[o], w[o].float()
    pos = y[o] > 0
    gi = o + int(start)
    floor = torch.full_like(xs, _rep_floor(xs.dtype))
    none = torch.full_like(gi, -1)
    _, ip = _ffill_max(torch.where(pos, xs, floor), torch.where(pos, gi, none))
    _, i_n = _ffill_max(torch.where(pos, floor, xs),
                        torch.where(pos, none, gi))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return QuantileSketch(
        x=xs, wp=torch.where(pos, ws, 0.0), wn=torch.where(pos, 0.0, ws),
        ip=ip, i_n=i_n, err_p=zero, err_n=zero, gran_p=zero, gran_n=zero)


def merge_sketches(a: QuantileSketch, b: QuantileSketch) -> QuantileSketch:
    """Associative merge: interleave the segment lists by key (a before
    b on ties) and refresh the representatives.  Each side's cumulative
    masses pick up at most one partner segment of rank error, so
    ``err := err_a + err_b + gran_a + gran_b`` per label (free between
    exact sketches)."""
    na, nb = a.x.shape[0], b.x.shape[0]
    dev = a.x.device
    x, j = merge_sorted(a.x, torch.arange(na, device=dev),
                        b.x, torch.arange(nb, device=dev) + na)

    def pick(fa, fb):
        return torch.cat([fa, fb])[j]

    floor = torch.full_like(x, _rep_floor(x.dtype))
    ip, i_n = pick(a.ip, b.ip), pick(a.i_n, b.i_n)
    # a representative is a real point ≤ its segment key, so the key
    # stands in for it: "latest label point at or before here"
    _, ip = _ffill_max(torch.where(ip >= 0, x, floor), ip)
    _, i_n = _ffill_max(torch.where(i_n >= 0, x, floor), i_n)
    return QuantileSketch(
        x=x, wp=pick(a.wp, b.wp), wn=pick(a.wn, b.wn), ip=ip, i_n=i_n,
        err_p=a.err_p + b.err_p + a.gran_p + b.gran_p,
        err_n=a.err_n + b.err_n + a.gran_n + b.gran_n,
        gran_p=torch.maximum(a.gran_p, b.gran_p),
        gran_n=torch.maximum(a.gran_n, b.gran_n))


def compress_sketch(s: QuantileSketch, cap: int) -> QuantileSketch:
    """Fold a sketch down to ``cap`` mass-balanced segments: bucket j
    ends at the first entry whose cumulative mass reaches
    ``(j+1)/cap·W``, keeps that entry's cumulative masses and
    representatives (err unchanged), and the largest folded bucket mass
    per label becomes the granularity.  No-op when it already fits."""
    m = s.x.shape[0]
    if m <= cap:
        return s
    cwp, cwn = fp32.cumsum(s.wp), fp32.cumsum(s.wn)
    cw = cwp + cwn
    levels = (torch.arange(1, cap + 1, dtype=torch.float32,
                           device=cw.device) / cap) * cw[-1]
    ends = torch.searchsorted(cw, levels, side="left").clamp(0, m - 1)
    ends[-1] = m - 1                         # the total mass is kept
    zero = cw.new_zeros(1)
    seg_wp = torch.diff(cwp[ends], prepend=zero)
    seg_wn = torch.diff(cwn[ends], prepend=zero)
    return QuantileSketch(
        x=s.x[ends], wp=seg_wp, wn=seg_wn, ip=s.ip[ends], i_n=s.i_n[ends],
        err_p=s.err_p, err_n=s.err_n,
        gran_p=torch.maximum(s.gran_p, seg_wp.amax()),
        gran_n=torch.maximum(s.gran_n, seg_wn.amax()))


def build_sketch(chunks, cap: int, n: int | None = None) -> QuantileSketch:
    """One-pass bounded-memory sketch of a chunked stream.

    ``chunks`` yields ``(x [t], y [t], w [t], start)`` in index order
    (``repro_torch.data.chunks.iter_shard_chunks`` is the double-
    buffered feed); the sketch lives on the tiles' device.  A
    logarithmic level buffer merges two sketches of one level into the
    next (older side first), so error grows with the merge tree's depth,
    O(log(m/chunk)·W/cap), and state stays O(cap·log(m/chunk))."""
    levels: list[QuantileSketch | None] = []
    seen = False
    for x, y, w, start in chunks:
        seen = True
        s = compress_sketch(sketch_from_chunk(
            torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(w),
            start, n), cap)
        i = 0
        while i < len(levels) and levels[i] is not None:
            s = compress_sketch(merge_sketches(levels[i], s), cap)
            levels[i] = None
            i += 1
        if i == len(levels):
            levels.append(s)
        else:
            levels[i] = s
    if not seen:
        raise ValueError("empty chunk stream")
    acc = None
    for s in reversed(levels):                      # oldest level first
        if s is not None:
            acc = s if acc is None else merge_sketches(acc, s)
    return compress_sketch(acc, cap)


def sketch_coreset(s: QuantileSketch, c: int) -> torch.Tensor:
    """[c] global int64 indices: the quantile coreset's per-label
    weighted-quantile selection run on sketch segments (c± ∝ W± slots,
    levels (j+½)/c± of each label's mass, the landing segment's
    representative of that label).  Uncompressed, it selects exactly
    the monolithic ``approximation.quantile_coreset``'s points."""
    cum = fp32.cumsum(torch.stack([s.wp, s.wn]))            # [2, cap]
    w_pos, w_neg = cum[0, -1], cum[1, -1]
    has_pos = (w_pos > 1e-12).to(torch.int32)
    has_neg = (w_neg > 1e-12).to(torch.int32)
    c_pos = torch.round(c * w_pos / torch.clamp(w_pos + w_neg, min=1e-30))
    c_pos = torch.minimum(torch.maximum(c_pos.to(torch.int32), has_pos),
                          c - has_neg)
    j = torch.arange(c, dtype=torch.float32, device=cum.device)
    c_posf = torch.clamp(c_pos.float(), min=1.0)
    c_negf = torch.clamp((c - c_pos).float(), min=1.0)
    lvls = torch.stack([(j + 0.5) * w_pos / c_posf,
                        (j - c_posf + 0.5) * w_neg / c_negf])  # [2, c]
    i2 = torch.searchsorted(cum.contiguous(), lvls.contiguous())
    i2 = i2.clamp(0, s.x.shape[0] - 1)
    pos_sel = torch.arange(c, device=cum.device) < c_pos
    return torch.where(pos_sel, s.ip[i2[0]], s.i_n[i2[1]])


def coreset_bound(s: QuantileSketch, c: int) -> torch.Tensor:
    """Sup-loss ε the sketch guarantees for a size-c coreset: the
    monolithic quantile coreset's 4/c plus 2·(err + gran)/W per label
    (each selected point's label rank sits within err + gran of its
    level); float32, in the reference's order."""
    w_pos, w_neg = fp32.sum_(s.wp), fp32.sum_(s.wn)
    rel = ((s.err_p + s.gran_p) / torch.clamp(w_pos, min=1e-30)
           + (s.err_n + s.gran_n) / torch.clamp(w_neg, min=1e-30))
    four_c = torch.tensor(4.0 / c, dtype=torch.float32, device=rel.device)
    return four_c + 2.0 * rel
