"""The port's LM parameters from a seed against the reference's.

The reference draws every weight as ``0.02 × truncated_normal(key, −2,
2, shape)`` along the key tree of ``repro.models.transformer`` and
``repro.models.attention``.  The port spells out jax's jitted
``_truncated_normal`` (``prng.truncated_normal``: XLA:CPU's erf, log1p
and erf_inv polynomials with their FMAs) and walks the same tree, so
every leaf is bit-equal: no ULP tolerance is used anywhere here.

The served sample (greedy decoding, bf16 products) equals the
reference's wherever the reference's two best logits are not a near
tie; where they are (seed 2), every token the port picks is within the
LM tolerance (2e-2, ``tests/test_torch_lm.py``) of the reference's best
logit at that position, the reference teacher-forced on the port's
tokens.
"""

import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import serve as j_serve
from repro.models import build as j_build
from repro_torch import configs, convert, models
from repro_torch.core import fp32, prng
from repro_torch.launch import serve

torch.set_num_threads(1)

DENSE = ["deepseek-7b", "qwen3-32b", "internlm2-20b", "command-r-35b"]
TOL = 2e-2


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-1.0, 3.0),
                                    (0.5, 4.5)])
@pytest.mark.parametrize("seed", [0, 7])
def test_truncated_normal_equals_jax_bitwise(seed, bounds):
    lo, hi = bounds
    for shape in [(), (5,), (37, 129), (3, 256, 64)]:
        want = jax.random.truncated_normal(jax.random.key(seed), lo, hi,
                                           shape)
        got = prng.truncated_normal(prng.key(seed), lo, hi, shape)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bounds", [(0.3, 2.7), (-5.5, 1000.0),
                                    (0.0, 1.0)])
def test_uniform_contracts_like_xla_cpu(bounds):
    """``f·(hi − lo) + lo`` is one FMA in the reference's compiled
    uniform; a span of 1 hides it, the other spans do not."""
    lo, hi = bounds
    for seed in (0, 2):
        want = jax.random.uniform(jax.random.key(seed), (4000,),
                                  minval=lo, maxval=hi)
        got = prng.uniform(prng.key(seed), (4000,), lo, hi)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_truncated_normal_slices_do_not_change_the_bits():
    keys = prng.split(prng.key(3), 4)
    whole = prng.truncated_normal(keys, -2.0, 2.0, (50, 41))
    for chunk in (1, 97, 2048):
        np.testing.assert_array_equal(
            prng.truncated_normal(keys, -2.0, 2.0, (50, 41),
                                  chunk=chunk).numpy(), whole.numpy())
    jkeys = jax.random.split(jax.random.key(3), 4)
    want = jax.vmap(lambda k: jax.random.truncated_normal(
        k, -2.0, 2.0, (50, 41)))(jkeys)
    np.testing.assert_array_equal(_bits(whole), _bits(want))


def test_erf_log1p_erf_inv_equal_xla_cpu():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-0.999, 0.999, 200_000),
                        rng.uniform(-1e-3, 1e-3, 10_000),
                        [0.0, -0.0, 0.41421354, -0.41421354, 0.5]]
                       ).astype(np.float32)
    tx = torch.from_numpy(x)
    for fn, jfn in [(fp32.erf_inv, jax.lax.erf_inv),
                    (fp32.log1p, jnp.log1p)]:
        np.testing.assert_array_equal(_bits(fn(tx)),
                                      _bits(jax.jit(jfn)(x)))
    xe = (x * 5).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(fp32.erf(torch.from_numpy(xe))),
        _bits(jax.jit(jax.lax.erf)(xe)))


@functools.cache
def _ref_params(arch, seed):
    jcfg = j_base.reduced(j_base.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    tree = jax.device_get(j_build(jcfg).init(jax.random.key(seed)))
    return cfg, convert.lm_params_from_jax(tree, cfg, "cpu")


def _assert_params_equal(got, want):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype == torch.float32, path
        np.testing.assert_array_equal(
            a.numpy().view(np.int32), b.numpy().view(np.int32),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("arch", DENSE)
def test_init_equals_reference_bitwise(arch, seed):
    cfg, want = _ref_params(arch, seed)
    _assert_params_equal(models.build(cfg).init(seed, "cpu"), want)


def test_queue3_reproducer_lm_params_from_seed():
    """ROADMAP queue 3, "LM parameters from a seed" (closed): reduced
    deepseek-7b, ``Model.init(0, "cpu")`` against the reference."""
    cfg, want = _ref_params("deepseek-7b", 0)
    params = models.build(cfg).init(0, "cpu")
    _assert_params_equal(params, want)
    # and the forward on them equals the carried-over weights' forward
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 8)), dtype=torch.int32)
    model = models.build(cfg)
    torch.testing.assert_close(model.logits(params, {"tokens": tok})[0],
                               model.logits(want, {"tokens": tok})[0],
                               rtol=0, atol=0)


def _serve_both(arch, seed):
    argv = ["--workload", "lm", "--arch", arch, "--seed", str(seed)]
    with contextlib.redirect_stdout(io.StringIO()):
        ref = j_serve.run(j_serve.build_parser().parse_args(argv))
    out, run = serve.run_lm(serve.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    return ref, out, run


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", DENSE)
def test_serve_sample_equals_reference(arch, seed):
    ref, out, _ = _serve_both(arch, seed)
    assert out["sample"] == ref["sample"]
    assert out["kernel_launches"] == {"flash_attention": 0,
                                      "decode_attention": 0}


@pytest.mark.parametrize("arch", ["deepseek-7b", "command-r-35b"])
def test_serve_sample_near_ties_within_lm_tolerance(arch):
    """Seed 2 decodes through a near tie of the reference's two best
    logits (one bf16 step apart), where the bf16 products' summation
    order decides the greedy pick.  Teacher-force the reference's own
    prefill and decode steps on the port's tokens: each pick of the port
    is within ``TOL`` of the reference's best logit there."""
    ref, out, run = _serve_both(arch, 2)
    assert out["sample"] != ref["sample"]          # the near tie shows
    jcfg = j_base.reduced(j_base.get_config(arch))
    model = j_build(jcfg)
    jparams = model.init(jax.random.key(2))
    prefill = jax.jit(model.make_prefill_step())
    decode = jax.jit(model.make_decode_step())
    gen = run.generated.numpy()
    logits, caches = prefill(jparams, {"tokens": jnp.asarray(
        run.tokens.numpy())})
    steps = [np.asarray(logits, np.float32)]
    for j in range(gen.shape[1] - 1):
        logits, caches = decode(jparams, caches, jnp.asarray(gen[:, j:j + 1]))
        steps.append(np.asarray(logits, np.float32))
    lg = np.stack(steps, 1)                                  # [B, gen, Vp]
    # decode keeps argmax % vocab: a token's logit is its residue class's
    V = jcfg.vocab_size
    n = -(-lg.shape[-1] // V)
    folded = np.pad(lg, [(0, 0), (0, 0), (0, n * V - lg.shape[-1])],
                    constant_values=-np.inf).reshape(*lg.shape[:2], n, V)
    picked = np.take_along_axis(folded.max(-2), gen[..., None], -1)[..., 0]
    best = lg.max(-1)
    assert ((best - picked) <= TOL * np.maximum(1.0, np.abs(best))).all()
