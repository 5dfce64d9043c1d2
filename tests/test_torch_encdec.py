"""The port's encoder-decoder (seamless-m4t-medium), the vision prefix
(pixtral-12b), cross-attention and the stub frontend against the JAX
package.

The same seeded numpy inputs go through the reference's jitted
functions and the port's, at 2e-2 wherever a bf16 product is on the
path (tests/test_torch_lm.py), bit for bit for the parameters from a
seed and for the frontend's embeddings (``jax.random.normal``:
``√2·erf_inv(uniform(nextafter(−1, 0), 1))``, scaled by 0.02 and cast to
bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import attention as j_attn
from repro.models import build as j_build
from repro.models import encdec as j_encdec
from repro.models import frontend as j_frontend
from repro_torch import configs, models
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.models import attention, encdec, frontend
from test_torch_lm import (TOL, _close, _model, _serve, _tokens,
                           assert_serve_cache_matches, cli_lm,
                           frontend_inputs, loss_both)
from test_torch_lm_init import _assert_params_equal, _bits, _ref_params

torch.set_num_threads(1)

ENCDEC = "seamless-m4t-medium"
PREFIX = "pixtral-12b"
ARCHS = [ENCDEC, PREFIX]


@pytest.mark.parametrize("seed", [0, 1, 9])
def test_normal_equals_jax_bitwise(seed):
    for shape in [(), (7,), (3, 50, 64), (2, 1000, 33)]:
        np.testing.assert_array_equal(
            _bits(prng.normal(prng.key(seed), shape)),
            _bits(jax.random.normal(jax.random.key(seed), shape)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_synth_embeds_equal_reference_bitwise(arch, full):
    cfg, jcfg = configs.get_config(arch), j_base.get_config(arch)
    if not full:
        cfg, jcfg = configs.reduced(cfg), j_base.reduced(jcfg)
    got = frontend.synth_embeds(prng.key(1), cfg, 2, 24)
    want = j_frontend.synth_embeds(jax.random.key(1), jcfg, 2, 24)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 24, cfg.d_model)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_cross_attention_init_skips_qk_norm():
    """``init(cross=True)`` has no q/k norms even on a qk-norm arch
    (reduced qwen3-32b), and draws the reference's weights."""
    jcfg, cfg, _, _ = _model("qwen3-32b")
    for cross in (False, True):
        want = jax.device_get(j_attn.init(jax.random.key(3), jcfg,
                                          cross=cross))
        got = attention.init(prng.key(3), cfg, cross=cross)
        assert set(got) == set(want)
        assert ("q_norm" in got) is (not cross)
        _assert_params_equal(got, jax.tree_util.tree_map(
            lambda a: torch.from_numpy(np.array(a)), want))


def _dec_layer(i=0):
    jcfg, cfg, jparams, params = _model(ENCDEC)
    jp = jax.tree_util.tree_map(lambda a: a[i], jparams["decoder"])
    return jcfg, cfg, jp, params["decoder"][i], jparams, params


def test_cross_decode_attention_matches_reference():
    jcfg, cfg, jp, p, _, _ = _dec_layer()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kv = [rng.standard_normal((2, 37, cfg.num_kv_heads, cfg.hd))
          .astype(np.float32) for _ in range(2)]
    want = jax.jit(lambda x, k, v: j_attn.cross_decode_attention(
        jp["cross_attn"], jcfg, x, {"k": k, "v": v}))(
        jnp.asarray(x, jnp.bfloat16), *(jnp.asarray(a, jnp.bfloat16)
                                        for a in kv))
    got = attention.cross_decode_attention(
        p["cross_attn"], cfg, torch.from_numpy(x).bfloat16(),
        {"k": torch.from_numpy(kv[0]).bfloat16(),
         "v": torch.from_numpy(kv[1]).bfloat16()})
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, cfg.d_model)
    _close(got, want)


def test_encoder_and_cross_cache_match_reference():
    """The bidirectional encoder's output and each decoder layer's cross
    K/V at 2e-2; the empty self cache's layout and length."""
    jcfg, cfg, _, _, jparams, params = _dec_layer()
    jx, tx = frontend_inputs(jcfg, cfg, 2, 30)
    jenc = jax.jit(lambda p, f: j_encdec.encode(p, jcfg, f))(
        jparams, jx["frames"])
    enc = encdec.encode(params, cfg, tx["frames"])
    _close(enc, jenc)
    jcross = jax.jit(lambda p, e: j_encdec.build_cross_cache(p, jcfg, e))(
        jparams, jenc)
    cross = encdec.build_cross_cache(params, cfg, enc)
    assert len(cross) == cfg.num_layers
    for i, c in enumerate(cross):
        for n in "kv":
            assert c[n].shape == jcross[n].shape[1:]
            _close(c[n], jcross[n][i])
    jself = j_encdec.init_self_cache(jcfg, 2, 31)
    self_cache = encdec.init_self_cache(cfg, 2, 31, "cpu")
    for i, c in enumerate(self_cache):
        for n in ("k", "v", "len"):
            np.testing.assert_array_equal(c[n].float().numpy(),
                                          np.asarray(jself[n][i], np.float32))


def test_queue3_property_encdec_prefill_leaves_self_cache_empty():
    """ROADMAP queue 3, "the enc-dec prefill leaves the decoder's self
    cache empty": the prefill scores the prompt teacher-forced but hands
    decode a self cache of St + 1 slots with len 0, in the reference and
    the port.  So decode attends to the generated tokens and the encoder
    only: two different prompts over the same frames give the same first
    decode step, in both packages."""
    jcfg, cfg, _, _, jparams, params = _dec_layer()
    jx, tx = frontend_inputs(jcfg, cfg, 2, 12)
    jm, tm = j_build(jcfg), models.build(cfg)
    jpre, jdec = jax.jit(jm.make_prefill_step()), jax.jit(
        jm.make_decode_step())
    nxt = _tokens(cfg, (2, 1), seed=9)
    steps = []
    for seed in (1, 2):
        toks = _tokens(cfg, (2, 12), seed)
        _, (jcross, jself) = jpre(jparams, {"tokens": jnp.asarray(toks),
                                            **jx})
        _, (cross, self_cache) = tm.make_prefill_step()(
            params, {"tokens": torch.from_numpy(toks), **tx})
        assert np.asarray(jself["len"]).tolist() == [[0, 0]] * cfg.num_layers
        assert [c["len"].tolist() for c in self_cache] == [[0, 0]] * len(
            self_cache)
        assert self_cache[0]["k"].shape[1] == jself["k"].shape[2] == 13
        jl, _ = jdec(jparams, (jcross, jself), jnp.asarray(nxt))
        tl, _ = tm.make_decode_step()(params, (cross, self_cache),
                                      torch.from_numpy(nxt))
        _close(tl, jl)
        steps.append((tl, np.asarray(jl)))
    assert torch.equal(steps[0][0], steps[1][0])
    np.testing.assert_array_equal(steps[0][1], steps[1][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, cfg, jparams, params = _model(arch)
    toks = _tokens(cfg, (2, 20))
    jx, tx = frontend_inputs(jcfg, cfg, 2, 20)
    want, jaux = jax.jit(lambda p, b: j_build(jcfg).logits(p, b))(
        jparams, {"tokens": jnp.asarray(toks), **jx})
    got, aux = models.build(cfg).logits(
        params, {"tokens": torch.from_numpy(toks), **tx})
    assert got.shape == want.shape
    assert got.shape[1] == 20 + cfg.frontend_tokens
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill (the encoder and the cross caches; or the prefix and the
    prompt through flash) and 4 decode steps."""
    got, want, _ = _serve(arch, 4)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    """``Model.loss_fn``: seamless over its frames, pixtral over the
    token tail after its prefix."""
    got, want = loss_both(arch)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_equals_reference_bitwise(arch, seed):
    cfg, want = _ref_params(arch, seed)
    _assert_params_equal(models.build(cfg).init(seed, "cpu"), want)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k", "tiny"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cache_matches_reference(arch, shape):
    shapes = dict(j_base.INPUT_SHAPES,
                  tiny=j_base.ShapeConfig("tiny", 64, 2, "decode"))
    assert_serve_cache_matches(arch, shapes[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_lm_prints_its_json_line(arch):
    cli_lm(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_lm_feeds_the_reference_frontend_batch(arch):
    """``serve.run_lm`` draws the stub frontend's input from key 1, as
    the reference's ``run``: the prefix (B × frontend_tokens) or the
    frames (B × prompt length), bit for bit."""
    args = serve.build_parser().parse_args(
        ["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len",
         "8", "--gen", "1"])
    _, run = serve.run_lm(args)
    jcfg = j_base.reduced(j_base.get_config(arch))
    name, n = (("frames", 8) if jcfg.encoder_layers
               else ("prefix_embeds", jcfg.frontend_tokens))
    want = j_frontend.synth_embeds(jax.random.key(1), jcfg, 2, n)
    np.testing.assert_array_equal(run.batch[name].float().numpy(),
                                  np.asarray(want, np.float32))
    assert run.generated.shape == (2, 2)
