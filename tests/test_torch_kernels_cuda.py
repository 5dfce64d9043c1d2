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
# ragged c, F and Q, and the scenario slice's OPT at m = 2^14
STUMP_SHAPES = [(1, 32, 1, 8), (1, 257, 9, 130), (3, 129, 9, 127),
                (4, 33, 3, 17), (2, 3001, 5, 1001), (1, 1, 1, 1),
                (4, 1 << 14, 8, (1 << 14) + 1)]


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
