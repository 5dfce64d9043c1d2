"""The port's hand-written kernels against their plain versions on the
card: mw_update and the histogram bit for bit, the stump contraction
bit for bit on ±1 and dyadic weights and within rtol 1e-5 plus atol
1e-6·Σ|wy| on float weights, flash attention at the reference's
tolerances (2e-5 in float32 on its CUDA-core route, 2e-2 in bf16 on its
wgmma route; the kernel sums in another order, and the wgmma route
rounds P to bf16 before P·V).  Every test here needs a CUDA device and
skips on a host without one; the file imports no JAX, so it runs where
only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import math

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.histogram import ops as hist_ops
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HIST_SHAPES, ids=str)
def test_histogram_kernel_matches_plain_version(card, shape):
    G, N, c, F, Q = shape
    g = torch.Generator(device=card).manual_seed(G * c)
    x = torch.rand((G, c, F), generator=g, device=card) * 1.6 - 0.3
    x[0, 0, 0] = math.nan
    w = torch.rand((G, N, c), generator=g, device=card) / c
    w[:, :, ::3] = 0.0
    wy = torch.where(torch.rand((G, N, c), generator=g, device=card) < 0.5,
                     -w, w)
    before = hist_ops.launches
    kw, kwy = hist_ops.node_histograms(x, w, wy, Q)
    torch.cuda.synchronize()
    assert hist_ops.launches == before + 1
    rw, rwy = hist_ops.node_histograms(x, w, wy, Q, interpret=True)
    assert torch.equal(kw, rw) and torch.equal(kwy, rwy)


@pytest.mark.cuda
@pytest.mark.parametrize("R,m", [(64, 1 << 18), (5, 3001), (2, 7)])
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
