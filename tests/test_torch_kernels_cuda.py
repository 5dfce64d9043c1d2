"""The port's hand-written kernels against their plain versions on the
card: mw_update and the histogram bit for bit, flash attention at the
reference's tolerances (2e-5 in float32, 2e-2 in bf16; the kernel sums
in another order).  Every test here needs a CUDA device and skips on a
host without one; the file imports no JAX, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import math

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.mw_update import ops as mw_ops

HIST_SHAPES = [  # G, N, c, F, Q
    (16, 1, 400, 8, 32), (16, 2, 400, 8, 32), (64, 2, 100, 8, 32),
    (5, 4, 77, 3, 8), (3, 2, 1000, 3, 8), (2, 2, 300, 40, 64)]
# B, S, H, KV, hd: the reference's sweep (tests/test_kernels.py), the
# deepseek-7b slice, qwen3-32b's attention widths (GQA, G = 8, hd 80)
# and a ragged S
FLASH_SHAPES = [(1, 64, 4, 2, 32), (2, 128, 8, 8, 64), (1, 200, 4, 1, 16),
                (1, 256, 2, 2, 128), (4, 2048, 32, 32, 128),
                (1, 2048, 64, 8, 80), (1, 2000, 8, 2, 128)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
