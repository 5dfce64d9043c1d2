"""The port's hand-written kernels against their plain versions on the
card: mw_update and the histogram (its chunked route too) bit for bit, the stump contraction
bit for bit on ±1 and dyadic weights and within rtol 1e-5 plus atol
1e-6·Σ|wy| on float weights, flash attention at the reference's
tolerances (2e-5 in float32 on its CUDA-core route, 2e-2 in bf16 on its
wgmma route, where the inputs and the output are bf16 and the kernel
sums in another order), and within 1e-4 on rows built so that P's
rounding would show (the wgmma route keeps P at float32 precision, as
the reference does); and the streaming tier's pinned chunk feed.  Every test here needs a CUDA device and skips on
a host without one; the file imports no JAX, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import math

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.histogram import kernel as hist_kernel
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.histogram import ref as hist_ref
from repro_torch.kernels.mw_update import ops as mw_ops
from repro_torch.kernels.stump import ops as stump_ops

HIST_SHAPES = [  # G, N, c, F, Q
    (16, 1, 400, 8, 32), (16, 2, 400, 8, 32), (64, 2, 100, 8, 32),
    (5, 4, 77, 3, 8), (3, 2, 1000, 3, 8), (2, 2, 300, 40, 64)]
# B, S, H, KV, hd: the reference's sweep (tests/test_kernels.py), the
# deepseek-7b slice, qwen3-32b's attention widths (GQA, G = 8, hd 80),
# a ragged S, S under 64, hd 256 (the widest plan) and G = 8 at hd 128
FLASH_SHAPES = [(1, 64, 4, 2, 32), (2, 128, 8, 8, 64), (1, 200, 4, 1, 16),
                (1, 256, 2, 2, 128), (4, 2048, 32, 32, 128),
                (1, 2048, 64, 8, 80), (1, 2000, 8, 2, 128),
                (2, 40, 4, 2, 64), (1, 300, 4, 2, 256),
                (1, 384, 16, 2, 128)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# B, c, F, Q: the reference's stump cases (tests/test_kernels.py), a
# ragged c, F and Q, the scenario slice's OPT at m = 2^14, c across the
# sort's 4096-key tiles with F past the key pass's 32-wide tile, c past
# 16·8192 (a sampled key every 32nd) and Q past 65535
STUMP_SHAPES = [(1, 32, 1, 8), (1, 257, 9, 130), (3, 129, 9, 127),
                (4, 33, 3, 17), (2, 3001, 5, 1001), (1, 1, 1, 1),
                (4, 1 << 14, 8, (1 << 14) + 1), (2, 4097, 33, 100),
                (1, 140001, 2, 300), (1, 5000, 2, 70000)]
STUMP_SPECIALS = (0.0, -0.0, math.inf, -math.inf, math.nan, 3.4e38,
                  -3.4e38, 1.0, -1.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a hand-written kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _hist_case(card, G, N, c, F, Q, seed, one_bin=False):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.rand((G, c, F), generator=g, device=card) * 1.6 - 0.3
    x[0, 0, 0] = math.nan
    if one_bin:                  # every point of a column in one bin
        x = x[:, :1].expand(G, c, F).contiguous()
    w = torch.rand((G, N, c), generator=g, device=card) / c
    w[:, :, ::3] = 0.0
    wy = torch.where(torch.rand((G, N, c), generator=g, device=card) < 0.5,
                     -w, w)
    return x, w, wy


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HIST_SHAPES, ids=str)
def test_histogram_kernel_matches_plain_version(card, shape):
    G, N, c, F, Q = shape
    x, w, wy = _hist_case(card, G, N, c, F, Q, seed=G * c)
    before = hist_ops.launches
    kw, kwy = hist_ops.node_histograms(x, w, wy, Q)
    torch.cuda.synchronize()
    assert hist_ops.launches == before + 1
    rw, rwy = hist_ops.node_histograms(x, w, wy, Q, interpret=True)
    assert torch.equal(kw, rw) and torch.equal(kwy, rwy)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,one_bin", [
    ((4, 2, 400, 8, 32), True), ((3, 1, 1000, 2, 8), True),
    ((4, 2, 399, 8, 32), False), ((4, 2, 400, 8, 32), False),
    ((4, 2, 401, 8, 32), False), ((3, 2, 1000, 5, 16), False),
    ((6, 2, 500, 3, 2), False), ((5, 4, 600, 3, 32), False),
    ((2, 1, 300, 3, 8192), False), ((1, 64, 500, 2, 8), False)], ids=str)
def test_histogram_kernel_edges_and_routes(card, shape, one_bin):
    """Bitwise against the plain version where a bin's chain is all c
    points, at c across k-block edges (399, 400, 401 at N = 2; 1000),
    at Q = 2, at N = 4, and on the second route, whose shapes do not
    fit a column's state in shared memory; each launch counted on the
    route ``kernel.plan`` names."""
    G, N, c, F, Q = shape
    x, w, wy = _hist_case(card, G, N, c, F, Q, seed=c + Q, one_bin=one_bin)
    route = hist_kernel.plan(G, N, c, F, Q).route
    assert route == ("tiled" if Q == 8192 or N == 64 else "sort")
    before = dict(hist_ops.route_launches)
    kw, kwy = hist_ops.node_histograms(x, w, wy, Q)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in hist_ops.route_launches.items()} \
        == {r: int(r == route) for r in hist_kernel.ROUTES}
    rw, rwy = hist_ops.node_histograms(x, w, wy, Q, interpret=True)
    assert torch.equal(kw, rw) and torch.equal(kwy, rwy)
    if one_bin:
        assert int((kw != 0).sum()) <= G * N * F
    if hist_ref.xla_cpu_block(c, N) < c:
        rows = hist_ref.node_histograms_ref(x, w, wy, Q, c)
        assert not (torch.equal(rows[0], rw) and torch.equal(rows[1], rwy))


# G, N, c, F, Q, tile: a tile edge (c a multiple of the tile), ragged
# last tiles (one point, and 1000 = 7·128 + 104), tiles of 400 and 800
# points with two nodes (two and four k-blocks a tile), the tree run's
# pooled coreset (400 points in tiles of 128), and tiles past the sort
# route's shared memory (16384 points at N = 4: 590 KB of column state)
CHUNK_SHAPES = [(2, 2, 512, 8, 32, 128), (3, 1, 257, 5, 16, 64),
                (2, 2, 1000, 3, 8, 128), (2, 2, 2000, 4, 32, 400),
                (1, 2, 4000, 3, 32, 800), (16, 2, 400, 8, 32, 128),
                (1, 4, 50_000, 8, 32, 1 << 14)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHUNK_SHAPES, ids=str)
def test_chunked_histogram_matches_plain_version(card, shape):
    """The "chunked" route against its plain version, one call of two
    launches counted on its route; on dyadic weights also against the
    monolithic kernel."""
    G, N, c, F, Q, tile = shape
    x, w, wy = _hist_case(card, G, N, c, F, Q, seed=c + tile)
    before, routes = hist_ops.launches, dict(hist_ops.route_launches)
    kw, kwy = hist_ops.node_histograms(x, w, wy, Q, chunk_size=tile)
    torch.cuda.synchronize()
    assert hist_ops.launches == before + 1
    assert {r: n - routes[r] for r, n in hist_ops.route_launches.items()} \
        == {r: int(r == "chunked") for r in hist_kernel.ROUTES}
    rw, rwy = hist_ops.node_histograms(x, w, wy, Q, interpret=True,
                                       chunk_size=tile)
    assert torch.equal(kw, rw) and torch.equal(kwy, rwy)
    dw = torch.floor(w * (c * 256)) / 256        # 8-bit dyadic in [0, 1)
    dwy = torch.where(wy < 0, -dw, dw)
    a = hist_ops.node_histograms(x, dw, dwy, Q, chunk_size=tile)
    b = hist_ops.node_histograms(x, dw, dwy, Q, interpret=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if c <= hist_kernel.MAX_SORT_POINTS:
        m = hist_ops.node_histograms(x, dw, dwy, Q)
        assert torch.equal(a[0], m[0]) and torch.equal(a[1], m[1])


@pytest.mark.cuda
def test_chunked_histogram_folds_negative_zero_tiles(card):
    """A tile whose sums are all −0.0 (weights −0.0) folds into +0.0, and
    so do the padded rows of the ragged last tile."""
    x, w, _ = _hist_case(card, 2, 2, 300, 4, 16, seed=3)
    w = torch.full_like(w, -0.0)
    w[:, 1, 150:170] = -0.125
    kw, kwy = hist_ops.node_histograms(x, w, -w, 16, chunk_size=128)
    rw, rwy = hist_ops.node_histograms(x, w, -w, 16, interpret=True,
                                       chunk_size=128)
    torch.cuda.synchronize()
    for k, r in ((kw, rw), (kwy, rwy)):
        assert torch.equal(k.view(torch.int32), r.view(torch.int32))
    assert not torch.signbit(kw[:, 0]).any()


@pytest.mark.cuda
def test_chunked_histogram_same_bits_over_50_launches(card):
    x, w, wy = _hist_case(card, 4, 4, 20_000, 8, 32, seed=7)
    first = hist_ops.node_histograms(x, w, wy, 32, chunk_size=4096)
    for _ in range(50):
        again = hist_ops.node_histograms(x, w, wy, 32, chunk_size=4096)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1],
                                                           again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_to_device_equals_its_input(card, depth):
    """The pinned double buffer on the card: tiles in order, equal to
    their host slices, on the card, the consumer reading each while the
    next copies are in flight."""
    import numpy as np
    from repro_torch.data import chunks

    rng = np.random.default_rng(depth)
    x = rng.integers(0, 1 << 16, 100_003).astype(np.int32)
    w = rng.random(100_003).astype(np.float32)
    got = []
    for xt, wt, start in chunks.prefetch_to_device(
            chunks.iter_chunks((x, w), 8192), depth=depth):
        assert xt.device.type == "cuda" and wt.device.type == "cuda"
        got.append((start, (xt.long() * 2).cpu(), (wt + 0.0).cpu()))
    assert [s for s, _, _ in got] == list(range(0, 100_003, 8192))
    np.testing.assert_array_equal(
        torch.cat([t for _, t, _ in got]).numpy(), x.astype(np.int64) * 2)
    np.testing.assert_array_equal(
        torch.cat([t for _, _, t in got]).numpy(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("R,m", [(64, 1 << 18), (5, 3001), (2, 7), (3, 1),
                                 (3, 15), (4, 16), (3, 17), (2, 2049),
                                 (64, 1 << 14), (3, 16 * 2048 + 3)])
def test_mw_update_kernel_matches_plain_version(card, R, m):
    g = torch.Generator(device=card).manual_seed(m)
    hits = torch.randint(0, 127, (R, m), generator=g, device=card,
                         dtype=torch.int32)
    correct = torch.rand((R, m), generator=g, device=card) < 0.7
    alive = torch.rand((R, m), generator=g, device=card) < 0.95
    alive[0] = False
    before = mw_ops.launches
    kh, kw = mw_ops.mw_update(hits, correct, alive)
    torch.cuda.synchronize()
    assert mw_ops.launches == before + 1
    rh, rw = mw_ops.mw_update(hits, correct, alive, interpret=True)
    assert torch.equal(kh, rh) and torch.equal(kw, rw)


@pytest.mark.cuda
def test_mw_update_same_bits_over_50_launches(card):
    """50 launches back to back on one stream give the plain version's
    bits: rows of 21 tiles are three CTAs (8, 8 and 5 tiles), each
    row's arrival count is reset by the launch that used it, and the
    row's last CTA folds the partials in tile order whichever CTA
    arrives last."""
    R, m = 64, 20 * 2048 + 16
    g = torch.Generator(device=card).manual_seed(50)
    hits = torch.randint(0, 120, (R, m), generator=g, device=card,
                         dtype=torch.int32)
    correct = torch.rand((R, m), generator=g, device=card) < 0.7
    alive = torch.rand((R, m), generator=g, device=card) < 0.95
    shift = torch.where(alive, hits, torch.iinfo(torch.int32).max).amin(-1)
    before = mw_ops.launches
    runs = [mw_ops.mw_update(hits, correct, alive, shift)
            for _ in range(50)]
    torch.cuda.synchronize()
    assert mw_ops.launches == before + 50
    rh, rw = mw_ops.mw_update(hits, correct, alive, shift, interpret=True)
    for kh, kw in runs:
        assert torch.equal(kh, rh) and torch.equal(kw, rw)


@pytest.mark.cuda
def test_shifted_mw_update_past_126_hits(card):
    """The tree path's [64, 2^14] with hits in 120–420 and each row's
    least alive hit count as the shift (a dead row keeps int32 max),
    bitwise against the plain version."""
    R, m = 64, 1 << 14
    g = torch.Generator(device=card).manual_seed(126)
    base = torch.randint(120, 300, (R, 1), generator=g, device=card,
                         dtype=torch.int32)
    hits = base + torch.randint(0, 121, (R, m), generator=g, device=card,
                                dtype=torch.int32)
    correct = torch.rand((R, m), generator=g, device=card) < 0.7
    alive = torch.rand((R, m), generator=g, device=card) < 0.95
    alive[0] = False
    shift = torch.where(alive, hits, torch.iinfo(torch.int32).max).amin(-1)
    before = mw_ops.launches
    kh, kw = mw_ops.mw_update(hits, correct, alive, shift)
    torch.cuda.synchronize()
    assert mw_ops.launches == before + 1
    rh, rw = mw_ops.mw_update(hits, correct, alive, shift, interpret=True)
    assert torch.equal(kh, rh) and torch.equal(kw, rw)
    assert bool((kw[1:] >= 0.5).all()) and float(kw[0]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", list(FLASH_TOL), ids=str)
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_attention_kernel_matches_plain_version(card, shape, dtype,
                                                      window):
    B, S, H, KV, hd = shape
    g = torch.Generator(device=card).manual_seed(S + H + window)
    q = torch.randn((B, S, H, hd), generator=g, device=card).to(dtype)
    k = torch.randn((B, S, KV, hd), generator=g, device=card).to(dtype)
    v = torch.randn((B, S, KV, hd), generator=g, device=card).to(dtype)
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    want = flash_ops.flash_attention(q, k, v, window=window, interpret=True)
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _cancelling_pairs(B, S, H, KV, hd, card, seed):
    """q, k, v bf16 [B, S, ·, hd] whose keys come in pairs (2t, 2t + 1):
    the partner's score is lower by a gap of 0.0025–0.0225 (after the
    1/√hd scale) and its V row is the negative of the first's.  On an
    odd row every visible key has its partner, so |O| is about the gap
    times |v|, far below Σ|p·v|, while the softmax weights are not bf16
    values: P rounded to bf16 errs there by about 2^−9 of Σ|p·v|."""
    g = torch.Generator().manual_seed(seed)
    T = S // 2
    x = torch.rand((B, T, KV), generator=g) * 24
    gap = (torch.rand((B, T, KV), generator=g) + 0.5) * 0.01 * hd ** 0.5
    k = torch.zeros((B, S, KV, hd))
    k[:, 0::2, :, 0] = x
    k[:, 1::2, :, 0] = x
    k[:, 1::2, :, 1] = -gap
    q = torch.zeros((B, S, H, hd))
    q[..., :2] = (torch.rand((B, 1, H, 1), generator=g) + 0.5)
    u = torch.rand((B, T, KV, hd), generator=g) * 2 - 1
    v = torch.stack([u, -u], dim=2).reshape(B, S, KV, hd)
    return [t.to(torch.bfloat16).to(card) for t in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 192, 256])
def test_flash_bf16_keeps_p_in_float32(card, hd):
    """The wgmma route against the plain version (P in float32) within
    1e-4 on rows where the V rows cancel, one tile plan per hd; every
    row at the bf16 bar.  With P rounded to bf16 before P·V the odd
    rows err by about 1e-3."""
    B, S, H, KV = 2, 256, 4, 2
    q, k, v = _cancelling_pairs(B, S, H, KV, hd, card, seed=hd)
    got = flash_ops.flash_attention(q, k, v).float()
    torch.cuda.synchronize()
    want = flash_ops.flash_attention(q, k, v, interpret=True).float()
    odd = slice(1, None, 2)
    # the rows cancel: |O| stays under 2^−6, where one bf16 step of the
    # output is under 1e-4
    assert float(want[:, odd].abs().max()) < 2 ** -6
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    err = float((got[:, odd] - want[:, odd]).abs().max())
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_flash_attention_counts_each_route(card):
    """bf16 launches take the wgmma route, float32 the CUDA-core one;
    the plain version adds to neither."""
    counts = []
    for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
        q = torch.randn((1, 130, 4, 64), device=card).to(dtype)
        before = dict(flash_ops.route_launches), flash_ops.launches
        flash_ops.flash_attention(q, q, q)
        flash_ops.flash_attention(q, q, q, interpret=True)
        counts.append({r: n - before[0][r]
                       for r, n in flash_ops.route_launches.items()})
        assert flash_ops.launches == before[1] + 1
    torch.cuda.synchronize()
    assert counts == [{"wgmma": 1, "cuda_cores": 0},
                      {"wgmma": 0, "cuda_cores": 1},
                      {"wgmma": 1, "cuda_cores": 0}]


# the MoE and vision-prefix families' prefill shapes on the wgmma route:
# granite-moe-3b-a800m (GQA 24/8, hd 64) and pixtral-12b (1024 prefix
# positions + 2048 prompt tokens, GQA 32/8, hd 160: padded to 192)
FAMILY_FLASH_SHAPES = [(4, 2048, 24, 8, 64), (4, 3072, 32, 8, 160),
                       (1, 300, 32, 8, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FAMILY_FLASH_SHAPES, ids=str)
def test_flash_wgmma_at_family_widths(card, shape):
    """bf16 flash at hd 64 and hd 160 against its plain version at
    2e-2, one launch on the wgmma route each."""
    B, S, H, KV, hd = shape
    g = torch.Generator(device=card).manual_seed(S + hd)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=card)
               .to(torch.bfloat16) for n in (H, KV, KV))
    before = dict(flash_ops.route_launches), flash_ops.launches
    got = flash_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = flash_ops.flash_attention(q, k, v, interpret=True)
    assert flash_ops.launches == before[1] + 1
    assert {r: n - before[0][r] for r, n in
            flash_ops.route_launches.items()} == {"wgmma": 1,
                                                  "cuda_cores": 0}
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["pm1", "dyadic", "float"])
@pytest.mark.parametrize("shape", STUMP_SHAPES, ids=str)
def test_stump_kernel_matches_plain_version(card, shape, weights):
    B, c, F, Q = shape
    g = torch.Generator(device=card).manual_seed(c + F + Q)
    x = torch.randn((B, c, F), generator=g, device=card) * 10
    x[..., ::7, :] = torch.round(x[..., ::7, :])        # ties with θ
    th = torch.randn((B, F, Q), generator=g, device=card) * 10
    th[..., ::5] = 3.4e38                               # the pad
    th[..., 1::5] = torch.round(th[..., 1::5])
    sign = torch.where(torch.rand((B, c), generator=g, device=card) < 0.5,
                       -1.0, 1.0)
    if weights == "pm1":
        wy = sign
    elif weights == "dyadic":
        wy = sign * torch.ldexp(torch.ones_like(sign), -torch.randint(
            0, 7, (B, c), generator=g, device=card))
    else:
        wy = sign * torch.rand((B, c), generator=g, device=card)
    before = stump_ops.launches
    got = stump_ops.stump_scores(x, wy, th)
    torch.cuda.synchronize()
    assert stump_ops.launches == before + 1
    want = stump_ops.stump_scores(x, wy, th, interpret=True)
    if weights == "float":
        atol = 1e-6 * wy.abs().sum(-1).max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    else:
        assert torch.equal(got, want)
    one = stump_ops.stump_scores(x[0], wy[0], th[0])
    assert torch.equal(one, got[0])


def _stump_weights(g, B, c, kind, card):
    sign = torch.where(torch.rand((B, c), generator=g, device=card) < 0.5,
                       -1.0, 1.0)
    if kind == "pm1":
        return sign
    if kind == "dyadic":
        return sign * torch.ldexp(torch.ones_like(sign), -torch.randint(
            0, 7, (B, c), generator=g, device=card))
    return sign * torch.rand((B, c), generator=g, device=card)


def _held_to_plain_version(x, wy, th, weights):
    before = stump_ops.launches
    got = stump_ops.stump_scores(x, wy, th)
    torch.cuda.synchronize()
    assert stump_ops.launches == before + 1
    want = stump_ops.stump_scores(x, wy, th, interpret=True)
    if weights == "float":
        atol = 1e-6 * wy.abs().sum(-1).max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    else:
        assert torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["pm1", "dyadic", "float"])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 300, 5, 40),
                                   (3, 5000, 8, 257)], ids=str)
def test_stump_kernel_special_values(card, shape, weights):
    """±0.0, ±inf, NaN and ±3.4e38 among the points and the thresholds:
    −0.0 ≥ +0.0, NaN counts for no threshold and a NaN threshold counts
    nothing, −inf counts every point but NaN, the pad counts +inf."""
    B, c, F, Q = shape
    g = torch.Generator(device=card).manual_seed(c + Q)
    sp = torch.tensor(STUMP_SPECIALS, device=card)
    x = torch.randn((B, c, F), generator=g, device=card)
    pick = torch.randint(0, len(sp), (B, c, F), generator=g, device=card)
    x = torch.where(torch.rand((B, c, F), generator=g, device=card) < 0.4,
                    sp[pick], x)
    th = sp[torch.randint(0, len(sp), (B, F, Q), generator=g, device=card)]
    th[..., -1] = 3.4e38
    _held_to_plain_version(x, _stump_weights(g, B, c, weights, card), th,
                           weights)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 4096, 4097, 20000])
def test_stump_kernel_constant_columns(card, c):
    """Every point of a column equal (every radix pass skipped): the
    thresholds at the value count all points, one float step above it
    none."""
    B, F, Q = 2, 3, 9
    g = torch.Generator(device=card).manual_seed(c)
    v = torch.randint(-3, 4, (B, 1, F), generator=g, device=card).float()
    x = v.expand(B, c, F).contiguous()
    col = v.transpose(1, 2)
    th = torch.cat([col, torch.nextafter(col, col - 1),
                    torch.nextafter(col, col + 1)], dim=-1).repeat(1, 1, 3)
    wy = _stump_weights(g, B, c, "pm1", card)
    got = _held_to_plain_version(x, wy, th, "pm1")
    total = wy.sum(-1)[:, None]
    assert torch.equal(got[..., 0], total.expand(B, F))
    assert bool((got[..., 2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 12288, 8, 12289),
                                   (2, 140001, 2, 300)], ids=str)
def test_stump_kernel_gives_the_same_bits_twice(card, shape):
    B, c, F, Q = shape
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn((B, c, F), generator=g, device=card) * 100
    th = torch.randn((B, F, Q), generator=g, device=card) * 100
    wy = _stump_weights(g, B, c, "float", card)
    first = stump_ops.stump_scores(x, wy, th)
    second = stump_ops.stump_scores(x, wy, th)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
