"""The port's Mamba block and the hybrid arch (jamba-v0.1-52b) against
the JAX package.

The same seeded numpy inputs go through the reference's jitted
functions and the port's, at 2e-2 wherever a bf16 product is on the
path (tests/test_torch_lm.py) and bit for bit for the parameters from a
seed: ``dt_bias`` is the reference's eager ``log(expm1(exp(u)))``, its
bounds XLA ``log``s, and ``A_log`` is ``log(1..d_state)``, each an
XLA:CPU transcendental that ``repro_torch.core.fp32`` spells out.

The full reduced stack (8 layers: 7 Mamba, 1 attention, 4 MoE FFNs) is
held layer by layer on the reference's own activations and caches, in
the prefill and in four decode steps; with float32 products on both
sides (the MoE experts' too) it matches end to end, forward and a
prefill plus four decode steps.  In bf16, end to end, its logits differ
from the reference's by more than 2e-2, as the reference's differ from
its own float32-product evaluation — ROADMAP queue 3, "bf16 noise at
depth".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import ssm as j_ssm
from repro_torch import models
from repro_torch.core import fp32, prng
from repro_torch.models import ssm
from test_torch_lm import (TOL, _close, _close_state, _model,
                           assert_serve_cache_matches, cli_lm,
                           depth_divergence, float32_logits, layerwise,
                           layerwise_decode)
from test_torch_lm_init import _assert_params_equal, _bits, _ref_params

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"


def _mamba(layer=0):
    """(reference config, port config, reference Mamba params of layer
    ``layer``, the port's), reduced jamba (Mamba at every position but
    4)."""
    jcfg, cfg, jparams, params = _model(ARCH)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["blocks"][layer]["mixer"])
    return jcfg, cfg, jp, params["blocks"][layer]["mixer"]


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def test_tanh_and_expm1_equal_xla_cpu():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-20, 20, 100_000),
                        rng.uniform(-1e-3, 1e-3, 10_000),
                        np.exp(rng.uniform(np.log(1e-3), np.log(0.1),
                                           50_000)),
                        [0.0, -0.0, 0.5, -0.5, 0.0004, 9.0]]
                       ).astype(np.float32)
    tx = torch.from_numpy(x)
    for fn, jfn in [(fp32.tanh, jnp.tanh), (fp32.expm1, jnp.expm1)]:
        np.testing.assert_array_equal(_bits(fn(tx)), _bits(jax.jit(jfn)(x)))
        np.testing.assert_array_equal(_bits(fn(tx[:64])), _bits(jfn(x[:64])))


def test_softplus_is_logaddexp():
    """jax.nn.softplus is logaddexp(x, 0): no switch to x above 20 (at
    −100 XLA:CPU flushes the subnormal result to 0)."""
    x = np.array([-100, -20, -1, 0, 1e-3, 1, 19.9, 20, 20.1, 25, 100],
                 np.float32)
    np.testing.assert_allclose(ssm._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6,
                               atol=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("seed", [0, 5])
def test_mamba_init_equals_reference_bitwise(seed):
    """``ssm.init`` on its own (eager, as the reference's model init
    runs it), dt_bias and A_log included."""
    jcfg, cfg, _, _ = _mamba()
    want = jax.device_get(j_ssm.init(jax.random.key(seed), jcfg))
    got = ssm.init(prng.key(seed), cfg)
    assert set(got) == set(want)
    for name in ("dt_bias", "A_log", "conv_w", "D"):
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]),
                                      err_msg=name)
    _assert_params_equal(
        got, jax.tree_util.tree_map(lambda a: torch.from_numpy(
            np.array(a, np.float32)), want))


@pytest.mark.parametrize("S", [5, 128, 200])
def test_mamba_forward_matches_reference(S):
    """The chunked prefill (S = 200 crosses the 128-step chunk edge and
    pads the second chunk) and its final state: y and h at 2e-2, the
    conv ring (the last cw − 1 pre-conv inputs) at 2e-2; h float32, the
    ring bf16, as the reference's."""
    jcfg, cfg, jp, p = _mamba()
    jx, tx = _x((2, S, cfg.d_model), seed=S)
    jy, jst = jax.jit(lambda x: j_ssm.forward(jp, jcfg, x))(jx)
    y, st = ssm.forward(p, cfg, tx)
    assert y.dtype == torch.bfloat16 and y.shape == tx.shape
    _close(y, jy)
    assert st["h"].dtype == torch.float32 and jst["h"].dtype == jnp.float32
    assert st["conv"].dtype == torch.bfloat16
    assert jst["conv"].dtype == jnp.bfloat16
    _close_state(st["h"], jst["h"])
    _close(st["conv"], jst["conv"])


def test_mamba_decode_matches_reference():
    """Four decode steps from the reference's prefill state (carried
    into the port), y and state at 2e-2 after each; the ring stays
    bf16."""
    jcfg, cfg, jp, p = _mamba()
    jx, tx = _x((2, 200, cfg.d_model), seed=1)
    _, jst = jax.jit(lambda x: j_ssm.forward(jp, jcfg, x))(jx)
    st = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if k == "conv" else torch.float32)
        for k, v in jst.items()}
    step = jax.jit(lambda x, s: j_ssm.decode_step(jp, jcfg, x, s))
    for t in range(4):
        jxt, txt = _x((2, 1, cfg.d_model), seed=10 + t)
        jy, jst = step(jxt, jst)
        y, st = ssm.decode_step(p, cfg, txt, st)
        _close(y, jy)
        _close_state(st["h"], jst["h"])
        _close(st["conv"], jst["conv"])
        assert st["conv"].dtype == torch.bfloat16


def test_mamba_prefill_then_decode_equals_longer_prefill():
    """The chunked scan's state is the recurrence's: a prefill of S
    then one decode step gives the last output of a prefill of S + 1."""
    _, cfg, _, p = _mamba()
    _, tx = _x((2, 130, cfg.d_model), seed=3)
    y_all, st_all = ssm.forward(p, cfg, tx)
    _, st = ssm.forward(p, cfg, tx[:, :129])
    y_last, st = ssm.decode_step(p, cfg, tx[:, 129:], st)
    _close(y_last, y_all[:, 129:].float().numpy())
    _close_state(st["h"], st_all["h"].numpy())


def test_layers_match_reference_on_its_activations():
    assert layerwise(ARCH) == 8


def test_layers_decode_on_reference_caches():
    """Four decode steps, each of the 8 layers on the reference's input
    and cache: the Mamba state handed over from the prefill, the bf16
    conv ring, the attention cache's length, the MoE's drop-free
    decode."""
    assert layerwise_decode(ARCH) == 8 * 4


@pytest.mark.parametrize("mode", ["forward", "serve"])
def test_float32_products_match_reference(mode):
    """With float32 products on both sides (layers and MoE experts) the
    reduced stack matches end to end: forward logits, and a prefill
    plus four decode steps."""
    got, want = float32_logits(ARCH, mode)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_queue3_reproducer_bf16_noise_at_depth():
    """ROADMAP queue 3, "bf16 noise at depth": end to end the reduced
    stack's logits differ from the reference's by more than 2e-2 —
    bf16 rounding in two orders, compounded over 8 layers and flipping
    near-tied MoE routes — and the reference's own logits differ as much
    from its float32-product evaluation: the port's distance stays
    within twice that."""
    port, noise = depth_divergence(ARCH)
    assert port > TOL and noise > TOL, (port, noise)
    assert port <= 2 * noise, (port, noise)


@pytest.mark.parametrize("seed", [0, 1])
def test_init_equals_reference_bitwise(seed):
    cfg, want = _ref_params(ARCH, seed)
    _assert_params_equal(models.build(cfg).init(seed, "cpu"), want)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k", "tiny"])
def test_serve_cache_matches_reference(shape):
    shapes = dict(j_base.INPUT_SHAPES,
                  tiny=j_base.ShapeConfig("tiny", 64, 2, "decode"))
    assert_serve_cache_matches(ARCH, shapes[shape])


def test_cli_lm_prints_its_json_line():
    cli_lm(ARCH)
