"""The port's flash attention against the JAX kernel and its oracle.

On the CPU the wrapper runs its plain version (``ref.py``, full softmax
in float32); tests/test_torch_kernels_cuda.py holds the CUDA kernel to
it on the card.  Here the plain version is held to the JAX oracle
``flash_attention_ref`` and the wrapper to the Pallas kernel in
interpret mode, over the reference's own sweep
(tests/test_kernels.py::test_flash_attention_sweep) at its tolerances:
2e-5 in float32, 2e-2 in bf16.  The kernel's routes and tile plans,
which are Python, are checked here too.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro.kernels.flash_attention.ref import flash_attention_ref as j_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref

torch.set_num_threads(1)

SWEEP = [(1, 64, 4, 2, 32), (2, 128, 8, 8, 64), (1, 200, 4, 1, 16),
         (1, 256, 2, 2, 128)]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, S, H, KV, hd, window, dtype):
    """q [B, S, H, hd], k/v [B, S, KV, hd] in both frameworks, from the
    reference test's seed; bf16 is rounded from the same float32."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(S + H + window)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SWEEP, ids=str)
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ref_matches_jax_oracle(shape, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(*shape, window, dtype)
    got = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  window=window)
    want = j_ref(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                 jv.transpose(0, 2, 1, 3), causal=True, window=window)
    assert got.dtype == q.dtype
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("shape", SWEEP, ids=str)
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrapper_on_cpu_matches_pallas_interpret(shape, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(*shape, window, dtype)
    before = ops.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert ops.launches == before            # the plain version ran
    want = j_ops.flash_attention(jq, jk, jv, causal=True, window=window,
                                 interpret=True)
    assert got.shape == q.shape and got.dtype == q.dtype
    _close(got, want, DTYPES[dtype][2])


def test_window_and_gqa_semantics():
    """Query i sees keys (i − window, i]; head h reads KV head h // G."""
    B, S, H, KV, hd, window = 1, 10, 4, 2, 8, 3
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, S, H, hd), generator=g)
    k = torch.randn((B, S, KV, hd), generator=g)
    v = torch.randn((B, S, KV, hd), generator=g)
    got = ops.flash_attention(q, k, v, window=window)
    for h in range(H):
        for i in range(S):
            keys = list(range(max(0, i - window + 1), i + 1))
            kk, vv = k[0, keys, h // 2], v[0, keys, h // 2]
            w = torch.softmax(kk @ q[0, i, h] / hd ** 0.5, dim=0)
            torch.testing.assert_close(got[0, i, h], w @ vv, rtol=1e-5,
                                       atol=1e-6)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q, q, q, interpret=False)
    with pytest.raises(ValueError, match="causal attention only"):
        ops.flash_attention(q, q, q, causal=False)
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, torch.zeros((1, 8, 3, 16)),
                            torch.zeros((1, 8, 3, 16)))
    out = ops.flash_attention(q, q, q, interpret=True)
    assert out.shape == q.shape


# the CUDA kernel's launch geometry, which the CPU reaches: the route
# each type takes and the tile plan of every head dim the wrapper takes

HEAD_DIMS = list(range(8, kernel.MAX_HEAD_DIM + 1, 8))


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "cuda_cores")],
                         ids=str)
def test_route_follows_the_input_type(dtype, route):
    assert kernel.ROUTES[dtype] == route
    assert {kernel.plan(hd, dtype).route for hd in HEAD_DIMS} == {route}


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_wgmma_tile_plan_fits_the_card(hd):
    p = kernel.plan(hd, torch.bfloat16)
    assert p.smem_bytes <= kernel.SMEM_LIMIT == 232_448
    assert p.threads == 384 and p.block_q == 128     # producer + 2 × 64 rows
    assert p.head_dim_padded >= hd and p.head_dim_padded % 64 == 0
    assert p.head_dim_padded - hd < 64
    assert 2 <= p.stages <= kernel.MAX_STAGES
    # wgmma m64nNk16: N a multiple of 8 up to 256, a K step of 16 bf16
    assert kernel.K_STEP == 16
    assert p.mma_n == (64 if p.head_dim_padded <= 192 else 16, 64)
    assert p.block_k % p.mma_n[0] == 0                  # whole S steps
    for n in p.mma_n:
        assert n % 8 == 0 and 8 <= n <= 256
    assert p.head_dim_padded % kernel.K_STEP == 0       # QKᵀ's depth
    assert p.block_k % kernel.K_STEP == 0               # PV's depth
    q_bytes = p.block_q * p.head_dim_padded * 2
    stage_bytes = 2 * p.block_k * p.head_dim_padded * 2
    assert p.smem_bytes == (kernel.SMEM_ALIGN + q_bytes + kernel.BARRIER_BYTES
                            + p.stages * stage_bytes)
    # one more stage would not fit, unless the ring is at its cap
    assert (p.stages == kernel.MAX_STAGES
            or p.smem_bytes + stage_bytes > kernel.SMEM_LIMIT)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_core_tile_plan_fits_the_card(hd):
    p = kernel.plan(hd, torch.float32)
    assert p.smem_bytes <= kernel.SMEM_LIMIT
    assert (p.block_q, p.block_k, p.threads, p.mma_n) == (64, 64, 256, ())
    assert hd <= p.head_dim_padded < 2 * hd or p.head_dim_padded == 16
    assert p.head_dim_padded in (16, 32, 64, 128, 256)


def test_the_source_builds_every_wgmma_plan():
    """The C entry point refuses a plan it has no instance of: each
    padded head dim's (HDP, BK, stages) is one ``launch_plan`` there."""
    src = kernel.SOURCE.read_text()
    built = {tuple(int(x) for x in m) for m in re.findall(
        r"launch_plan<(\d+), (\d+), (\d+)>", src)}
    wanted = {(p.head_dim_padded, p.block_k, p.stages)
              for p in (kernel.plan(hd, torch.bfloat16) for hd in HEAD_DIMS)}
    assert built == wanted


def test_plan_refuses_what_the_kernel_does_not_take():
    for hd in (0, 12, 260, 264):
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError, match="multiple of 8 up to 256"):
                kernel.plan(hd, dtype)
    with pytest.raises(TypeError, match="flash attention kernel takes"):
        kernel.plan(128, torch.float16)
