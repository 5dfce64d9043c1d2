"""The port's LM substrate (dense family) against the JAX package.

The reference's parameters (``repro.models`` init, numpy leaves) are
carried into the port by ``convert.lm_params_from_jax``, so both
compute the same model.  Tolerances: float32 layers (RMS norm, RoPE) at
rtol 1e-5; anything that passes through a bf16 product at 2e-2, the
reference's own model-path tolerance
(tests/test_kernels.py::test_flash_matches_model_attention_path).  The
reduced configurations are ``reduced()`` deepseek-7b (MHA) and
qwen3-32b (GQA, qk-norm, RoPE θ 10^6).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import attention as j_attn
from repro.models import build as j_build
from repro.models import layers as j_L
from repro_torch import configs, convert, models
from repro_torch.models import attention, layers as L

torch.set_num_threads(1)

TOL = 2e-2
ARCHS = ["deepseek-7b", "qwen3-32b"]
DENSE = ["deepseek-7b", "qwen3-32b", "internlm2-20b", "command-r-35b"]


@functools.cache
def _model(arch):
    """(reference config, port config, reference params, port params)
    for reduced(arch), the reference's params from key 0."""
    jcfg = j_base.reduced(j_base.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    jparams = j_build(jcfg).init(jax.random.key(0))
    params = convert.lm_params_from_jax(jax.device_get(jparams), cfg, "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float().numpy()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_reference(arch):
    ref, port = j_base.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(configs.reduced(port)) == dataclasses.asdict(
        j_base.reduced(ref))
    assert (port.hd, port.padded_vocab, port.param_count()) == (
        ref.hd, ref.padded_vocab, ref.param_count())


def test_unported_archs_raise_with_their_queue_item():
    assert set(configs.all_configs()) == set(DENSE)
    with pytest.raises(NotImplementedError, match="queue 1, item 15"):
        configs.get_config("jamba-v0.1-52b")
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    cfg = dataclasses.replace(configs.reduced(configs.get_config(
        "deepseek-7b")), block_pattern=(("attn", "moe"),))
    with pytest.raises(NotImplementedError, match="queue 1, item 15"):
        models.build(cfg)


def test_init_matches_reference_layout_and_scale():
    _, cfg, _, carried = _model("qwen3-32b")
    params = models.build(cfg).init(seed=3, device="cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                            carried)
    w = params["blocks"][1]["mixer"]["wq"]["w"]
    assert w.dtype == torch.float32 and w.abs().max() <= 0.04
    # a normal truncated at ±2σ has σ·0.880 standard deviation
    assert abs(w.std().item() - 0.02 * 0.880) < 5e-4
    assert torch.equal(params["blocks"][0]["mixer"]["q_norm"]["scale"],
                       torch.ones(cfg.hd))


@pytest.mark.parametrize("name", ["linear", "rms_norm", "rope", "mlp",
                                  "embed", "unembed"])
def test_layers_match_jax(name):
    _, cfg, jparams, params = _model("deepseek-7b")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jblk = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"][0])
    blk = params["blocks"][0]
    if name == "linear":
        _close(L.linear(blk["mixer"]["wq"], tx),
               j_L.linear(jblk["mixer"]["wq"], jx))
    elif name == "rms_norm":
        scale = rng.standard_normal(cfg.d_model).astype(np.float32)
        _close(L.rms_norm({"scale": torch.from_numpy(scale)}, tx),
               j_L.rms_norm({"scale": jnp.asarray(scale)}, jx), 1e-5)
    elif name == "rope":
        xr = x.reshape(2, 5, cfg.num_heads, cfg.hd)
        pos = np.array([[0, 1, 2, 3, 4], [7, 9, 11, 500, 4095]], np.int32)
        _close(L.rope(torch.from_numpy(xr), torch.from_numpy(pos), 1e6),
               j_L.rope(jnp.asarray(xr), jnp.asarray(pos), 1e6), 1e-5)
    elif name == "mlp":
        _close(L.mlp(blk["ffn"], tx), j_L.mlp(jblk["ffn"], jx))
    elif name == "embed":
        tok = _tokens(cfg, (2, 5))
        got = L.embed(params["embed"], torch.from_numpy(tok))
        want = j_L.embed(jparams["embed"], jnp.asarray(tok))
        assert got.dtype == torch.bfloat16
        _close(got, want, 0.0)
    else:
        _close(L.unembed(params["embed"], tx),
               j_L.unembed(jparams["embed"], jx))


@pytest.mark.parametrize("use_flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_full_attention_matches_jax(arch, use_flash):
    jcfg, cfg, jparams, params = _model(arch)
    x = np.random.default_rng(2).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)[None]
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"][0]["mixer"])
    want, wk, wv = j_attn.full_attention(jp, jcfg, jnp.asarray(x),
                                         jnp.asarray(pos), causal=True,
                                         use_flash=use_flash)
    got, k, v = attention.full_attention(
        params["blocks"][1]["mixer"], cfg, torch.from_numpy(x),
        torch.from_numpy(pos), causal=True, use_flash=use_flash)
    for g, w in ((got, want), (k, wk), (v, wv)):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_attention_matches_jax(arch):
    """Two decode steps against a full cache: the second writes over
    slot 1 of the ring, and the caches must agree after each."""
    jcfg, cfg, jparams, params = _model(arch)
    rng = np.random.default_rng(3)
    B, C = 2, 12
    x = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"][0]["mixer"])
    p = params["blocks"][0]["mixer"]
    pos = np.arange(C, dtype=np.int32)[None]
    _, jk, jv = j_attn.full_attention(jp, jcfg, jnp.asarray(x),
                                      jnp.asarray(pos))
    jcache = {"k": jk, "v": jv, "len": jnp.full((B,), C, jnp.int32)}
    cache = {"k": torch.from_numpy(np.asarray(jk, np.float32)).bfloat16(),
             "v": torch.from_numpy(np.asarray(jv, np.float32)).bfloat16(),
             "len": torch.full((B,), C, dtype=torch.int32)}
    for step in range(2):
        xt = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jcache = j_attn.decode_attention(jp, jcfg, jnp.asarray(xt),
                                               jcache)
        got, cache = attention.decode_attention(p, cfg, torch.from_numpy(xt),
                                                cache)
        _close(got, want)
        _close(cache["k"], jcache["k"])
        _close(cache["v"], jcache["v"])
        assert cache["len"].tolist() == [C + step + 1] * B


def _serve(arch, n_decode, P=16, B=2, seed=1):
    """Prefill P prompt tokens and decode n_decode teacher-forced tokens
    through both models; returns (port logits, reference logits, the
    token grid [B, P + n_decode]), logits stacked [n_decode + 1, B, V]."""
    jcfg, cfg, jparams, params = _model(arch)
    toks = _tokens(cfg, (B, P + n_decode), seed)
    jm, tm = j_build(jcfg, use_flash=True), models.build(cfg, use_flash=True)
    jl, jc = jax.jit(jm.make_prefill_step())(
        jparams, {"tokens": jnp.asarray(toks[:, :P])})
    tl, tc = tm.make_prefill_step()(params,
                                    {"tokens": torch.from_numpy(toks[:, :P])})
    jdec, tdec = jax.jit(jm.make_decode_step()), tm.make_decode_step()
    got, want = [tl], [np.asarray(jl)]
    for t in range(P, P + n_decode):
        tok = toks[:, t:t + 1]
        jl, jc = jdec(jparams, jc, jnp.asarray(tok))
        tl, tc = tdec(params, tc, torch.from_numpy(tok))
        got.append(tl)
        want.append(np.asarray(jl))
    return torch.stack(got).numpy(), np.stack(want), toks


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill and 4 teacher-forced decode steps, port (flash on the
    prefill) against ``repro.models.build(cfg, use_flash=True)``;
    greedy tokens compared where the reference's top-1/top-2 gap is
    wider than twice the tolerance."""
    got, want, _ = _serve(arch, 4)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * TOL
    assert clear.sum() >= clear.size // 2
    assert (np.argmax(got, -1)[clear] == np.argmax(want, -1)[clear]).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, cfg, jparams, params = _model(arch)
    toks = _tokens(cfg, (2, 24))
    want, _ = j_build(jcfg).logits(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = models.build(cfg).logits(params,
                                        {"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    _close(got, want)


def test_decode_overwrites_the_oldest_prompt_position():
    """The reference's decode writes token P at slot P % C = 0 of a
    prefill cache of capacity C = P, so from the second decode step on
    position 0 is gone (ROADMAP queue 3).  The port reproduces it:
    port and reference agree on the second step, and both differ from
    a full forward of the same tokens by far more than the tolerance,
    while the first step agrees with it.  A cache with room for the new
    tokens agrees with the forward on both steps, which pins the
    difference on the overwrite."""
    arch, P = "deepseek-7b", 8
    jcfg, cfg, jparams, params = _model(arch)
    got, want, toks = _serve(arch, 2, P=P)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    full, _ = models.build(cfg).logits(params,
                                       {"tokens": torch.from_numpy(toks)})
    full = full.numpy()
    step1 = np.abs(got[1] - full[:, P]).max()
    step2 = np.abs(got[2] - full[:, P + 1]).max()
    ref_step2 = np.abs(want[2] - full[:, P + 1]).max()
    assert step1 < TOL, step1
    assert step2 > 4 * TOL and ref_step2 > 4 * TOL, (step2, ref_step2)
    # the same decode with two free slots after the prompt
    tm = models.build(cfg, use_flash=True)
    _, caches = tm.make_prefill_step()(
        params, {"tokens": torch.from_numpy(toks[:, :P])})
    for c in caches:
        pad = torch.zeros_like(c["k"][:, :2])
        c["k"], c["v"] = (torch.cat([c[n], pad], dim=1) for n in "kv")
    for t in (P, P + 1):
        logits, caches = tm.make_decode_step()(
            params, caches, torch.from_numpy(toks[:, t:t + 1]))
        assert np.abs(logits.numpy() - full[:, t]).max() < TOL


def test_init_cache_matches_reference_layout():
    """An empty (or filled) serving cache: the reference stacks one per
    pattern position on [num_superblocks]; the port keeps one per
    layer, with the same per-layer shapes, types and lengths."""
    from repro.models import transformer as j_transformer
    from repro_torch.models import transformer

    jcfg, cfg, _, _ = _model("qwen3-32b")
    for filled in (False, True):
        (want,) = j_transformer.init_cache(jcfg, 3, 16, filled=filled)
        got = transformer.init_cache(cfg, 3, 16, "cpu", filled=filled)
        assert len(got) == cfg.num_layers
        for i, c in enumerate(got):
            for n in ("k", "v", "len"):
                assert tuple(c[n].shape) == want[n].shape[1:]
                np.testing.assert_array_equal(c[n].float().numpy(),
                                              np.asarray(want[n][i],
                                                         np.float32))
            assert c["k"].dtype == torch.bfloat16
            assert c["len"].dtype == torch.int32
