"""The decode attention kernel's plain version, wrapper and plan on the
CPU, and the CUDA kernel against the plain version on the card.

On the CPU the wrapper runs ``ref.py``, which must be the model's
einsum core (``models.attention._decode_core``, kept for DTensor
caches) over the live slots, bit for bit, with the same slot write; a
DTensor cache must still take the einsum route.  The CUDA kernel keeps
the softmax's weights in float32 where the plain version rounds them to
bf16, so on the card it is held to the plain version at the bf16
tolerance (2e-2) and to a float64 evaluation with float32 weights
within 8e-3.  The card-only tests skip on a host without a CUDA device;
the file imports no JAX, so they run where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_decode_attention.py
"""

import math

import pytest
import torch

from repro_torch.configs import base
from repro_torch.core import prng
from repro_torch.kernels.decode_attention import kernel, ops, ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention, build

torch.set_num_threads(1)


def _inputs(B, C, KV, G, hd, lens, seed, device="cpu"):
    """q, k_new, v_new, k_cache, v_cache in bf16 (every slot filled, live
    or not) and lens int32 [B]."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(B, 1, KV * G, hd), (B, 1, KV, hd), (B, 1, KV, hd),
              (B, C, KV, hd), (B, C, KV, hd)]
    ts = [torch.randn(s, generator=g).to(torch.bfloat16).to(device)
          for s in shapes]
    return (*ts, torch.tensor(lens, dtype=torch.int32, device=device))


def _core_and_write(q, k_new, v_new, k_cache, v_cache, lens, window):
    """The einsum path as the model ran it before the kernel: the mask,
    ``_decode_core`` and the indexed slot write."""
    B, C = k_cache.shape[:2]
    out = attention._decode_core(q, k_new, v_new, k_cache, v_cache,
                                 ref.live_slots(lens, C, window))
    rows, widx = torch.arange(B), (lens % C).long()
    k_cache[rows, widx] = k_new[:, 0]
    v_cache[rows, widx] = v_new[:, 0]
    return out


# C = 16 slots; len below, at and past C (a wrapped ring), per row
LENS = {"short": [5, 11], "full": [16, 16], "wrapped": [21, 40]}


@pytest.mark.parametrize("lens", list(LENS))
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("G", [1, 3, 4])
def test_ref_equals_decode_core(G, hd, window, lens):
    """The plain version and the wrapper on the CPU are the einsum core
    over the live slots, and write the same slot, bit for bit."""
    args = _inputs(2, 16, 2, G, hd, LENS[lens], seed=G * hd + window)
    want_cache = [t.clone() for t in args[3:5]]
    want = _core_and_write(*args[:3], *want_cache, args[5], window)
    got_cache = [t.clone() for t in args[3:5]]
    got = ref.decode_attention_ref(*args[:3], *got_cache, args[5], window)
    before = ops.launches
    via_ops = ops.decode_attention(*args, window)
    assert ops.launches == before                 # the plain version ran
    assert got.shape == (2, 1, 2 * G * hd) and got.dtype == torch.bfloat16
    for g, w in ((got, want), (via_ops, want), (got_cache[0], want_cache[0]),
                 (got_cache[1], want_cache[1]), (args[3], want_cache[0])):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("C", [1, 7, 16])
def test_live_slots_are_the_kernels_positions(C):
    """The kernel reads positions [len − n, len) at slots p mod C, n =
    min(len, C, window − 1 with a window): the plain version's mask,
    through the ring's wrap and the window, at every len up to 3C."""
    for window in (0, 1, 2, 5, 40):
        for ln in range(3 * C + 2):
            n = min(ln, C) if window == 0 else min(ln, C, window - 1)
            want = torch.zeros(C, dtype=torch.bool)
            want[[p % C for p in range(ln - n, ln)]] = True
            got = ref.live_slots(torch.tensor([ln], dtype=torch.int32), C,
                                 window)[0]
            assert torch.equal(got, want), (C, window, ln)


def test_wrapper_refuses_wrong_shapes_types_and_devices():
    q, kn, vn, kc, vc, lens = _inputs(2, 8, 2, 2, 64, [3, 4], seed=0)
    with pytest.raises(ValueError, match="takes q"):
        ops.decode_attention(q.expand(2, 2, 4, 64), kn, vn, kc, vc, lens)
    with pytest.raises(ValueError, match="takes q"):
        ops.decode_attention(q, kn, vn, kc[:, :, :1], vc, lens)
    with pytest.raises(ValueError, match="takes q"):
        ops.decode_attention(q, kn, vn, kc, vc, lens[:1])
    with pytest.raises(ValueError, match="takes q"):
        ops.decode_attention(q[..., :3, :], kn, vn, kc, vc, lens)
    with pytest.raises(TypeError, match="int32 lens"):
        ops.decode_attention(q, kn, vn, kc, vc, lens.long())
    with pytest.raises(ValueError, match="different devices"):
        ops.decode_attention(q, kn, vn, kc, vc, lens.to("meta"))
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention(q, kn, vn, kc, vc, lens, -1)
    with pytest.raises(ValueError, match="needs CUDA"):
        ops.decode_attention(q, kn, vn, kc, vc, lens, interpret=False)


def test_dtensor_cache_takes_the_einsum_route(monkeypatch):
    """A DTensor cache (the dry run's) runs ``_decode_core`` and the
    slot-mask write, never the wrapper: the plain cache's output and
    cache, on a 1-rank gloo mesh."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils import _pytree as pytree

    cfg = base.reduced(base.get_config("granite-moe-3b-a800m"))
    p = attention.init(prng.key(0, "cpu"), cfg)
    B, C = 2, 8
    x = torch.randn(B, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).to(torch.bfloat16)
    *_, kc, vc, lens = _inputs(B, C, cfg.num_kv_heads, 1, cfg.hd, [5, 11],
                               seed=2)
    plain = {"k": kc.clone(), "v": vc.clone(), "len": lens.clone()}
    want, plain = attention.decode_attention(p, cfg, x, plain)

    def refuse(*args, **kw):
        raise AssertionError("a DTensor cache reached the kernel's wrapper")

    monkeypatch.setattr(attention.decode_ops, "decode_attention", refuse)
    with mesh_lib.make_host_mesh(device="cpu") as mesh, \
            implicit_replication():     # the slot mask's arange is plain
        rep = (Replicate(),) * mesh.ndim

        def place(t):
            return distribute_tensor(t.clone(), mesh, rep)

        cache = {"k": place(kc), "v": place(vc), "len": place(lens)}
        got, cache = attention.decode_attention(
            pytree.tree_map(place, p), cfg, place(x), cache)
        got = got.full_tensor()
        k_after, v_after = cache["k"].full_tensor(), cache["v"].full_tensor()
        len_after = cache["len"].full_tensor()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(k_after, plain["k"], rtol=0, atol=0)
    torch.testing.assert_close(v_after, plain["v"], rtol=0, atol=0)
    assert torch.equal(len_after, plain["len"])


def test_plan_split_counts():
    """Splits from the shapes: deepseek-7b's decode cell (32 sequences,
    32/32 heads of 128, 2048 slots) fills the card unsplit; granite at
    B = 32 (24/8 heads of 64) takes 3; B = 4 takes many, each split at
    least MIN_SPLIT_SLOTS of the slots; a short cache never splits."""
    assert kernel.plan(32, 32, 1, 128, 2048).splits == 1
    assert kernel.plan(32, 8, 3, 64, 2048).splits == 3
    assert kernel.plan(4, 32, 1, 128, 2048).splits == 5
    assert kernel.plan(4, 8, 3, 64, 2048).splits == 16
    assert kernel.plan(2, 4, 1, 64, 200).splits == 1
    unsplit = kernel.plan(32, 32, 1, 128, 2048)
    assert unsplit.scratch_floats == 0
    split = kernel.plan(4, 8, 3, 64, 2048)
    assert split.scratch_floats == 4 * 8 * 16 * 3 * (64 + 2)
    for B, KV, C in ((1, 1, 4096), (4, 8, 2048), (2, 4, 300)):
        s = kernel.plan(B, KV, 1, 64, C).splits
        assert s == 1 or C // s >= kernel.MIN_SPLIT_SLOTS


def test_plan_fits_the_card():
    """Three CTAs share an SM at hd 128 (with the 1 KiB each CTA's system
    share takes of the SM's 228 KiB), two at hd 160; other widths and
    groups are refused."""
    sm = 228 * 1024
    assert 3 * (kernel.smem_bytes(128) + 1024) <= sm
    assert 2 * (kernel.smem_bytes(160) + 1024) <= sm
    with pytest.raises(ValueError, match="head_dim"):
        kernel.plan(1, 1, 1, 96, 16)
    with pytest.raises(ValueError, match="query heads"):
        kernel.plan(1, 1, 9, 64, 16)


# ---------------------------------------------------------------------------
# the CUDA kernel, on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a hand-written kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def _float_weights(q, k_new, v_new, k_cache, v_cache, lens, window):
    """The same attention in float64 with unrounded weights."""
    B, _, H, hd = q.shape
    C, KV = k_cache.shape[1], k_cache.shape[2]
    live = ref.live_slots(lens, C, window)
    qg = q.reshape(B, KV, H // KV, hd).double()
    k = torch.cat([k_cache, k_new], 1).double()             # [B, C + 1, KV, hd]
    v = torch.cat([v_cache, v_new], 1).double()
    s = torch.einsum("bkgh,btkh->bkgt", qg, k) / math.sqrt(hd)
    keep = torch.cat([live, torch.ones_like(live[:, :1])], 1)
    s = torch.where(keep[:, None, None], s, -math.inf)
    o = torch.einsum("bkgt,btkh->bkgh", torch.softmax(s, -1), v)
    return o.reshape(B, 1, H * hd)


# B, C, KV, G, hd, lens, window: each head dim; split (2 to 8) and
# unsplit plans; a wrapped ring (len past C), len 0, a window, rows of
# one batch at different lengths; deepseek-7b's and granite's widths
CUDA_CASES = [
    (2, 512, 2, 1, 64, [300, 511], 0),
    (3, 256, 4, 3, 80, [256, 700, 5], 0),
    (2, 1024, 2, 4, 128, [1500, 1023], 100),
    (1, 300, 1, 8, 160, [900], 0),
    (40, 64, 8, 1, 64, list(range(0, 200, 5)), 0),
    (4, 100, 8, 6, 128, [99, 100, 350, 0], 40),
    (8, 2048, 32, 1, 128, [1536 + 50 * i for i in range(8)], 0),
    (8, 2048, 8, 3, 64, [2047 + 100 * i for i in range(8)], 0),
    (2, 160, 2, 8, 160, [170, 33], 17),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
def test_kernel_matches_plain_version(card, case):
    B, C, KV, G, hd, lens, window = case
    args = _inputs(B, C, KV, G, hd, lens, seed=B + C + G, device=card)
    plain_cache = [t.clone() for t in args[3:5]]
    want = ops.decode_attention(*args[:3], *plain_cache, args[5], window,
                                interpret=True)
    exact = _float_weights(*args[:3], *[t.clone() for t in args[3:5]],
                           args[5], window)
    before = ops.launches
    got = ops.decode_attention(*args, window)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    err = (got.double() - exact).abs().max().item()
    assert err <= 8e-3, f"{err} from the float-weight evaluation"
    assert torch.equal(args[3], plain_cache[0])       # the slot write
    assert torch.equal(args[4], plain_cache[1])


@pytest.mark.cuda
def test_kernel_refuses_float32_and_strided_caches(card):
    args = _inputs(2, 64, 2, 2, 64, [3, 70], seed=0, device=card)
    with pytest.raises(TypeError, match="bf16"):
        ops.decode_attention(args[0].float(), *args[1:])
    wide = torch.zeros(2, 64, 2, 128, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(*args[:3], wide[..., :64], wide[..., 64:],
                             args[5])


@pytest.mark.cuda
def test_launches_one_per_layer_per_step(card):
    """A reduced deepseek-7b decodes through the kernel: one call per
    attention layer a step, and logits within 2e-2 of the CPU's."""
    cfg = base.reduced(base.get_config("deepseek-7b"))
    model = build(cfg, use_flash=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 36),
                         generator=torch.Generator().manual_seed(3))
    logits = {}
    for dev in ("cpu", card):
        params = model.init(seed=0, device=dev)
        t = toks.to(dev)
        _, caches = model.make_prefill_step()(params, {"tokens": t[:, :32]})
        before, steps = ops.launches, []
        for i in range(32, 36):
            out, caches = model.make_decode_step()(params, caches,
                                                   t[:, i:i + 1])
            steps.append(out.float().cpu())
        calls = ops.launches - before
        assert calls == (cfg.num_layers * 4 if dev == card else 0)
        logits[str(dev)] = torch.stack(steps)
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=2e-2,
                               atol=2e-2)
