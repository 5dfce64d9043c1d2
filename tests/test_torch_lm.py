"""The port's LM substrate against the JAX package: the dense family
here, and the helpers the other families' files use
(tests/test_torch_moe.py, test_torch_ssm.py, test_torch_xlstm.py,
test_torch_encdec.py).

The reference's parameters (``repro.models`` init, numpy leaves) are
carried into the port by ``convert.lm_params_from_jax``, so both
compute the same model.  Tolerances: float32 layers (RMS norm, RoPE) at
rtol 1e-5; anything that passes through a bf16 product at 2e-2, the
reference's own model-path tolerance
(tests/test_kernels.py::test_flash_matches_model_attention_path).  The
reduced configurations are ``reduced()`` deepseek-7b (MHA) and
qwen3-32b (GQA, qk-norm, RoPE θ 10^6).
"""

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import attention as j_attn
from repro.models import build as j_build
from repro.models import frontend as j_frontend
from repro.models import layers as j_L
from repro_torch import configs, convert, models
from repro_torch.core import prng
from repro_torch.models import attention, frontend, layers as L

torch.set_num_threads(1)

TOL = 2e-2
ARCHS = ["deepseek-7b", "qwen3-32b"]
DENSE = ["deepseek-7b", "qwen3-32b", "internlm2-20b", "command-r-35b"]
ALL = list(j_base.ASSIGNED_ARCHS)


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


def frontend_inputs(jcfg, cfg, B, S):
    """The stub frontend's inputs for a batch of B prompts of S tokens,
    as both packages' serve draw them from key 1: ``prefix_embeds``
    (vision prefix) or ``frames`` (encoder); {} for a text-only arch."""
    if cfg.frontend == "vit_stub":
        n = cfg.frontend_tokens
        return ({"prefix_embeds": j_frontend.synth_embeds(
                    jax.random.key(1), jcfg, B, n)},
                {"prefix_embeds": frontend.synth_embeds(prng.key(1), cfg,
                                                        B, n)})
    if cfg.encoder_layers:
        return ({"frames": j_frontend.synth_embeds(jax.random.key(1), jcfg,
                                                   B, S)},
                {"frames": frontend.synth_embeds(prng.key(1), cfg, B, S)})
    return {}, {}


class _Float32Numpy:
    """``jax.numpy`` whose ``bfloat16`` is float32: the reference's MoE
    experts name bf16 outright (``moe.py:86-134``)."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def float32_products(*modules):
    """Run the modules' products in float32, the reference's and the
    port's alike: the ``layers`` modules' ``dtype`` defaults, and the
    MoE experts' bf16 (the reference's ``jnp.bfloat16``, the port's
    ``moe.BF16``).  The bf16 rounding noise leaves, the model's
    structure stays.  Trace jitted functions inside."""
    from repro.models import moe as j_moe
    from repro_torch.models import moe

    fns = [(getattr(m, n), jnp.float32 if m is j_L else torch.float32)
           for m in modules if m in (j_L, L)
           for n in ("linear", "mlp", "embed", "unembed")]
    saved = [f.__defaults__ for f, _ in fns]
    for f, dtype in fns:
        f.__defaults__ = (dtype,)
    if j_moe in modules:
        j_moe.jnp = _Float32Numpy()
    if moe in modules:
        moe.BF16 = torch.float32
    try:
        yield
    finally:
        for (f, _), d in zip(fns, saved):
            f.__defaults__ = d
        j_moe.jnp, moe.BF16 = jnp, torch.bfloat16


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float().numpy()),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _close_state(got, want, tol=TOL):
    """``_close`` with the absolute part scaled to the reference's
    largest magnitude: a recurrent state far below 1 (a Mamba ``h`` of
    about 2e-4 at these widths, an mLSTM ``C`` of about 1e-2) is then
    held at 2e-2 of its own scale, not within 2e-2 of zero."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.float().numpy()), want,
                               rtol=tol, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("arch", ALL)
def test_configs_match_reference(arch):
    ref, port = j_base.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(configs.reduced(port)) == dataclasses.asdict(
        j_base.reduced(ref))
    assert (port.hd, port.padded_vocab, port.param_count()) == (
        ref.hd, ref.padded_vocab, ref.param_count())


def test_unported_archs_raise_with_their_queue_item():
    """Every assigned arch is registered and builds (the families of
    ROADMAP queue 1, item 15, are ported); an unknown arch is a
    KeyError, and a block kind the reference lacks raises."""
    assert set(configs.all_configs()) == set(ALL) == set(
        configs.ASSIGNED_ARCHS)
    for arch in ALL:
        models.build(configs.reduced(configs.get_config(arch)))
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    base = configs.reduced(configs.get_config("deepseek-7b"))
    for pattern in ((("attn", "moe"),), (("mamba", "none"),)):
        models.build(dataclasses.replace(base, block_pattern=pattern))
    for pattern in ((("rwkv", "mlp"),), (("attn", "glu"),)):
        with pytest.raises(ValueError, match="not a block"):
            models.build(dataclasses.replace(base, block_pattern=pattern))


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
                                  "embed", "unembed", "layer_norm",
                                  "rms_norm_scaleless"])
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
    elif name == "layer_norm":
        p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
             "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
        init = L.layernorm_init(cfg.d_model, "cpu")
        assert {k: v.tolist() for k, v in init.items()} == {
            k: np.asarray(v).tolist()
            for k, v in j_L.layernorm_init(cfg.d_model).items()}
        _close(L.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            tx + 3.0),
               j_L.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jx + 3.0), 1e-5)
    elif name == "rms_norm_scaleless":
        _close(L.rms_norm_scaleless(tx), j_L.rms_norm_scaleless(jx), 1e-5)
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
    """Prefill P prompt tokens (after the stub frontend's prefix or
    frames, where the arch has one) and decode n_decode teacher-forced
    tokens through both models; returns (port logits, reference logits,
    the token grid [B, P + n_decode]), logits stacked
    [n_decode + 1, B, V]."""
    jcfg, cfg, jparams, params = _model(arch)
    toks = _tokens(cfg, (B, P + n_decode), seed)
    jm, tm = j_build(jcfg, use_flash=True), models.build(cfg, use_flash=True)
    jextra, extra = frontend_inputs(jcfg, cfg, B, P)
    jl, jc = jax.jit(jm.make_prefill_step())(
        jparams, {"tokens": jnp.asarray(toks[:, :P]), **jextra})
    tl, tc = tm.make_prefill_step()(
        params, {"tokens": torch.from_numpy(toks[:, :P]), **extra})
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


# ---------------------------------------------------------------------------
# helpers of the other families' files
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_serve_cache_matches(arch, shape):
    """``Model.init_serve_cache(shape)`` of the port against the
    reference's: the same leaves per layer, in shape and type (the
    reference stacks each pattern position's layers on a leading axis,
    the encoder-decoder's layers on one), and the same values where the
    port allocates (``device`` "meta" for the large decode shapes, whose
    reference layout comes from ``jax.eval_shape``)."""
    jcfg, cfg, _, _ = _model(arch)
    jm, tm = j_build(jcfg), models.build(cfg)
    assert tm.decode_window(shape) == jm.decode_window(shape)
    small = shape.seq_len * shape.global_batch <= 1 << 12
    want = (jm.init_serve_cache(shape) if small
            else jax.eval_shape(lambda: jm.init_serve_cache(shape)))
    got = tm.init_serve_cache(shape, device="cpu" if small else "meta")
    if cfg.encoder_layers:
        pairs = [(want[part][n], [c[n] for c in got[part]])
                 for part in (0, 1) for n in want[part]]
        assert [set(c) for c in got[1]] == [set(want[1])] * cfg.num_layers
    else:
        P = cfg.pattern_len
        assert len(got) == cfg.num_layers
        assert [set(c) for c in got] == [set(want[i % P])
                                         for i in range(cfg.num_layers)]
        pairs = [(leaf, [got[i][n] for i in range(pos, cfg.num_layers, P)])
                 for pos in range(P) for n, leaf in want[pos].items()]
    for leaf, layers in pairs:
        assert leaf.shape == (len(layers),) + tuple(layers[0].shape)
        assert {str(t.dtype).split(".")[-1] for t in layers} == {
            str(leaf.dtype)}
        if small:
            np.testing.assert_array_equal(
                np.stack([t.float().numpy() for t in layers]),
                np.asarray(leaf, np.float32))


def cli_lm(arch, *flags):
    """``python -m repro_torch.launch.serve --workload lm --device cpu
    --arch <arch>``: its one JSON line."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "lm", "--device", "cpu", "--arch", arch, "--batch", "2",
         "--prompt-len", "16", "--gen", "3", *flags], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["arch"] == arch + "-smoke" and out["device"] == "cpu"
    assert out["kernel_launches"] == {"flash_attention": 0,
                                      "decode_attention": 0}
    assert out["tokens_finite"] and len(out["sample"]) == 4
    return out


def loss_both(arch, B=2, St=12, seed=4):
    """``Model.loss_fn`` of both packages on one weighted batch:
    ((loss, aux) of the port, of the reference)."""
    jcfg, cfg, jparams, params = _model(arch)
    rng = np.random.default_rng(seed)
    toks = _tokens(cfg, (B, St), seed)
    labels = _tokens(cfg, (B, St), seed + 1)
    mask = (rng.random((B, St)) < 0.8).astype(np.float32)
    w = rng.random(B).astype(np.float32)
    alive = np.array([1.0] * (B - 1) + [0.0], np.float32)
    jextra, extra = frontend_inputs(jcfg, cfg, B, St)
    jb = {"tokens": toks, "labels": labels, "loss_mask": mask,
          "weights": w, "alive": alive}
    jloss, jm = jax.jit(j_build(jcfg).loss_fn)(
        jparams, {**{k: jnp.asarray(v) for k, v in jb.items()}, **jextra})
    loss, m = models.build(cfg).loss_fn(
        params, {**{k: torch.from_numpy(v) for k, v in jb.items()}, **extra})
    return ((float(loss), float(m["aux_loss"])),
            (float(jloss), float(jm["aux_loss"])))


def layerwise(arch, S=40, B=2, seed=1):
    """Each layer of reduced(arch) on the reference's own activations:
    the reference's stack runs layer by layer (its ``_apply_block``,
    jitted) and every port layer gets the reference layer's input, so
    the bf16 rounding of one layer does not compound through the next.
    Holds each layer's output and aux at 2e-2, its cache at 2e-2 of its
    scale (``_close_state``), and each MoE router's ids on the
    reference's FFN input to the reference's.
    Returns the number of layers checked."""
    from repro.models import moe as j_moe
    from repro.models import transformer as j_tr
    from repro_torch.models import moe, transformer

    jcfg, cfg, jparams, params = _model(arch)
    toks = _tokens(cfg, (B, S), seed)
    h = j_L.embed(jparams["embed"], jnp.asarray(toks))
    jpos = jnp.arange(S, dtype=jnp.int32)[None]
    pos = torch.arange(S, dtype=torch.int32)[None]
    P = cfg.pattern_len
    for i, (mixer, ffn) in enumerate(transformer.layer_kinds(cfg)):
        jp = jax.tree_util.tree_map(lambda a: a[i // P],
                                    jparams["blocks"][i % P])

        def block(p, x, ffn=ffn, mixer=mixer):
            return j_tr._apply_block(p, jcfg, mixer, ffn, x, jpos, window=0,
                                     use_flash=False, collect_cache=True)

        jh, jaux, jc = jax.jit(block)(jp, h)
        got, aux, c = transformer._apply_block(
            params["blocks"][i], cfg, mixer, ffn,
            torch.from_numpy(np.asarray(h, np.float32)).bfloat16(), pos,
            window=0, use_flash=False)
        _close(got, jh)
        _close(aux, jaux)
        for n in jc:
            _close_state(c[n], jc[n])
        if ffn == "moe":
            mid, _, _ = jax.jit(functools.partial(block, ffn="none"))(jp, h)
            x = j_L.rms_norm(jp["norm2"], mid, jcfg.norm_eps)
            _, jidx, _ = jax.jit(lambda x: j_moe._route(jp["ffn"], jcfg, x))(
                x.reshape(-1, cfg.d_model))
            _, idx, _ = moe._route(
                params["blocks"][i]["ffn"], cfg,
                torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                .reshape(-1, cfg.d_model))
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        h = jh
    return cfg.num_layers


def depth_divergence(arch, B=2, S=20, seed=1):
    """Reduced(arch)'s forward logits: (max |port − reference|, max
    |reference − reference with float32 products|) — the second is the
    reference's own bf16 rounding noise at this depth."""
    jcfg, cfg, jparams, params = _model(arch)
    toks = _tokens(cfg, (B, S), seed)

    def ref():
        return np.asarray(jax.jit(lambda p, t: j_build(jcfg).logits(
            p, {"tokens": t})[0])(jparams, jnp.asarray(toks)))

    want = ref()
    with float32_products(j_L):
        want_f32 = ref()
    got = models.build(cfg).logits(params,
                                   {"tokens": torch.from_numpy(toks)})[0]
    return (float(np.abs(got.numpy() - want).max()),
            float(np.abs(want - want_f32).max()))


def _reference_decode_by_layer(arch, P, n, B, seed):
    """The reference's serve prefill of P tokens (jitted, flash on) and
    n teacher-forced decode steps run layer by layer: its
    ``decode_step`` body for one layer, jitted.  Yields, for every step
    and layer, ("layer", i, (mixer, ffn), the layer's params, its input,
    its cache, its output, its new cache, its FFN input), and after each
    step ("step", the last layer's output, the logits of the
    reference's whole jitted ``decode_step`` at that step)."""
    from repro.models import moe as j_moe
    from repro.models import ssm as j_ssm
    from repro.models import xlstm as j_xlstm
    from repro_torch.models import transformer

    jcfg, cfg, jparams, _ = _model(arch)
    eps, Pl = cfg.norm_eps, cfg.pattern_len
    toks = _tokens(cfg, (B, P + n), seed)
    jm = j_build(jcfg, use_flash=True)
    _, jcaches = jax.jit(jm.make_prefill_step())(
        jparams, {"tokens": jnp.asarray(toks[:, :P])})
    caches = [jax.tree_util.tree_map(lambda a, s=i // Pl: a[s],
                                     jcaches[i % Pl])
              for i in range(cfg.num_layers)]

    def layer(p, hh, cache, mixer, ffn):
        hn = j_L.rms_norm(p["norm1"], hh, eps)
        if mixer == "attn":
            out, nc = j_attn.decode_attention(p["mixer"], jcfg, hn, cache,
                                              window=0)
        elif mixer == "mamba":
            out, nc = j_ssm.decode_step(p["mixer"], jcfg, hn, cache)
        elif mixer == "mlstm":
            out, nc = j_xlstm.mlstm_decode(p["mixer"], jcfg, hn, cache)
        else:
            st = tuple(cache[k] for k in ("h", "c", "n", "m"))
            out, st = j_xlstm.slstm_decode(p["mixer"], jcfg, hn, st)
            nc = dict(zip(("h", "c", "n", "m"), st))
        hh = hh + out
        x = j_L.rms_norm(p["norm2"], hh, eps) if ffn != "none" else hh
        if ffn == "mlp":
            hh = hh + j_L.mlp(p["ffn"], x)
        elif ffn == "moe":
            hh = hh + j_moe.apply(p["ffn"], jcfg, x)[0]
        return hh, nc, x

    kinds = transformer.layer_kinds(cfg)
    steps = {k: jax.jit(functools.partial(layer, mixer=k[0], ffn=k[1]))
             for k in set(kinds)}
    jdec = jax.jit(jm.make_decode_step())
    for t in range(P, P + n):
        tok = jnp.asarray(toks[:, t:t + 1])
        want, jcaches = jdec(jparams, jcaches, tok)
        h = j_L.embed(jparams["embed"], tok)
        for i, kind in enumerate(kinds):
            jp = jax.tree_util.tree_map(lambda a: a[i // Pl],
                                        jparams["blocks"][i % Pl])
            jh, jc, jx = steps[kind](jp, h, caches[i])
            yield "layer", i, kind, jp, h, caches[i], jh, jc, jx
            h, caches[i] = jh, jc
        yield "step", h, want


def _reference_head(jcfg, jparams, h):
    """The reference's ``decode_step`` tail: final norm and head."""
    h = j_L.rms_norm(jparams["final_norm"], h, jcfg.norm_eps)
    if jcfg.tie_embeddings:
        return j_L.unembed(jparams["embed"], h)[:, 0]
    return j_L.linear(jparams["lm_head"], h).astype(jnp.float32)[:, 0]


def reference_decode_self_divergence(arch, P=40, n=4, B=2, seed=1):
    """max |logits of the reference's decode run one jitted layer at a
    time − logits of its whole jitted ``decode_step``| over n steps, in
    bf16: the reference's own rounding noise between two jit
    boundaries."""
    jcfg, _, jparams, _ = _model(arch)
    head = jax.jit(functools.partial(_reference_head, jcfg))
    return max(float(np.abs(np.asarray(head(jparams, item[1]))
                            - np.asarray(item[2])).max())
               for item in _reference_decode_by_layer(arch, P, n, B, seed)
               if item[0] == "step")


def layerwise_decode(arch, P=40, n=4, B=2, seed=1):
    """Each layer's one-token decode of reduced(arch) on the reference's
    own inputs and caches (``_reference_decode_by_layer``): at every
    layer and step the port's ``transformer._decode_block`` gets that
    layer's input and the reference's cache.  Holds each layer's output
    at 2e-2, its new cache at 2e-2 of its scale (``_close_state``; an
    attention cache's ``len`` exactly, every leaf's dtype equal), each
    MoE router's ids on the reference's FFN input equal, and the port's
    head on the reference's last activation at 2e-2.  With float32
    products (no bf16 noise between the two jit boundaries) the chained
    reference layers give its whole ``decode_step``'s logits, which
    pins the layer body on the reference's.  Returns the (layer, step)
    pairs checked."""
    from repro.models import moe as j_moe
    from repro_torch.models import moe, transformer

    jcfg, cfg, jparams, params = _model(arch)
    D = cfg.d_model
    port = lambda a: (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                      if a.dtype == jnp.bfloat16
                      else torch.from_numpy(np.array(a)))
    route = jax.jit(lambda p, x: j_moe._route(p, jcfg, x)[1])
    head = jax.jit(functools.partial(_reference_head, jcfg))
    checked = 0
    for item in _reference_decode_by_layer(arch, P, n, B, seed):
        if item[0] == "step":
            h = item[1]
            _close(transformer._logits(params, cfg, port(h))[:, 0],
                   head(jparams, h))
            continue
        _, i, (mixer, ffn), jp, h, cache, jh, jc, jx = item
        got, c = transformer._decode_block(
            params["blocks"][i], cfg, mixer, ffn, port(h),
            {k: port(v) for k, v in cache.items()}, window=0)
        _close(got, jh)
        assert set(c) == set(jc)
        for k in jc:
            assert c[k].dtype == port(jc[k]).dtype, (i, k)
            if k == "len":
                np.testing.assert_array_equal(c[k].numpy(), jc[k])
            else:
                _close_state(c[k], jc[k])
        if ffn == "moe":
            np.testing.assert_array_equal(
                moe._route(params["blocks"][i]["ffn"], cfg,
                           port(jx).reshape(-1, D))[1].numpy(),
                np.asarray(route(jp["ffn"], jx.reshape(-1, D))))
        checked += 1
    with float32_products(j_L, j_moe):
        for item in _reference_decode_by_layer(arch, P, n, B, seed):
            if item[0] == "step":
                _close(torch.from_numpy(np.array(jax.jit(functools.partial(
                    _reference_head, jcfg))(jparams, item[1]))), item[2])
    return checked


def float32_logits(arch, mode):
    """Reduced(arch) with float32 products on both sides, the MoE
    experts' too: (port logits, reference logits) of ``forward`` on a
    [2, 24] token grid ("forward"), or of a serve prefill of 20 tokens
    and 4 teacher-forced decode steps, stacked [5, 2, Vp] ("serve")."""
    from repro.models import moe as j_moe
    from repro_torch.models import moe

    jcfg, cfg, jparams, params = _model(arch)
    with float32_products(j_L, L, j_moe, moe):
        if mode == "serve":
            got, want, _ = _serve(arch, 4, P=20)
            return got, want
        toks = _tokens(cfg, (2, 24))
        want = jax.jit(lambda p, t: j_build(jcfg).logits(
            p, {"tokens": t})[0])(jparams, jnp.asarray(toks))
        got = models.build(cfg).logits(params,
                                       {"tokens": torch.from_numpy(toks)})[0]
    return got.numpy(), np.asarray(want)


@functools.cache
def _span_counts(arch, traced):
    """Ranges of each name in a CPU profiler capture of one prefill and
    one decode step of reduced(arch), under a trace recorder or not."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace as obs_trace

    _, cfg, _, params = _model(arch)
    model = models.build(cfg)
    toks = torch.from_numpy(_tokens(cfg, (2, 8)))
    with (obs_trace.recording() if traced else contextlib.nullcontext()), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        _, caches = model.make_prefill_step()(params, {"tokens": toks[:, :7]})
        model.make_decode_step()(params, caches, toks[:, 7:])
    return cfg, {e.key: e.count for e in prof.key_averages()}


@pytest.mark.parametrize("span", ["prefill_step", "decode_step", "attention",
                                  "mlp", "moe_ffn"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-3b-a800m"])
def test_lm_spans_frame_each_step_and_layer(arch, span):
    """Under a trace recorder a profiler capture of a prefill and a
    decode step shows ``prefill_step`` and ``decode_step`` once each,
    ``attention`` once per layer and step, and the layer's FFN span
    (``mlp`` dense, ``moe_ffn`` MoE) once per layer and step; with no
    recorder it shows none of them."""
    cfg, counts = _span_counts(arch, True)
    per_layer = 2 * cfg.num_layers
    want = {"prefill_step": 1, "decode_step": 1, "attention": per_layer,
            "mlp": 0 if cfg.num_experts else per_layer,
            "moe_ffn": per_layer if cfg.num_experts else 0}[span]
    assert counts.get(span, 0) == want
    assert _span_counts(arch, False)[1].get(span, 0) == 0
