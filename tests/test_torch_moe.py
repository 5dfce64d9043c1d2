"""The port's Mixture-of-Experts FFN and the MoE archs
(granite-moe-3b-a800m, phi3.5-moe-42b-a6.6b) against the JAX package.

The same seeded numpy inputs go through the reference's jitted
functions and the port's.  The router is float32: its expert ids are
equal and its gates and aux within 1e-5; everything that passes through
a bf16 product is held at 2e-2 (tests/test_torch_lm.py).  Which (token,
k) choices a dispatch drops past capacity is held equal, the reference's
set read off its own slot arithmetic (``moe.py``'s per-k cumulative
positions for ``einsum``, the sorted ranks for ``sort``) on its own
router ids.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.models import build as j_build
from repro.models import moe as j_moe
from repro_torch import models
from repro_torch.models import moe
from test_torch_lm import (TOL, _close, _model, _serve, _tokens,
                           assert_serve_cache_matches, cli_lm, loss_both)
from test_torch_lm_init import _assert_params_equal, _ref_params

torch.set_num_threads(1)

ARCHS = ["granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b"]


def _ffn(arch="granite-moe-3b-a800m", **changes):
    """(reference config, port config, reference FFN params of layer 0,
    port FFN params of layer 0) of reduced(arch), with ``changes``."""
    jcfg, cfg, jparams, params = _model(arch)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"][0]["ffn"])
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(cfg, **changes), jp, params["blocks"][0]["ffn"])


def _x(shape, seed, skew=()):
    """bf16 activations in both frameworks; ``skew`` names experts whose
    unit router columns are added to every token (8×, then 4×), so that
    they win the first (and second) choice nearly everywhere and their
    capacity overflows."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w = np.asarray(_ffn()[2]["router"]["w"])
    for e, scale in zip(skew, (8.0, 4.0)):
        x = x + scale * w[:, e] / np.linalg.norm(w[:, e])
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _ref_einsum_dropped(idx, Ep, C):
    """The reference's dropped (group, token, k) choices: its per-k
    cumulative positions (moe.py ``_einsum_moe``) on its router ids."""
    G, Tg, K = idx.shape
    offset = jnp.zeros((G, Ep), jnp.int32)
    kept = []
    for kk in range(K):
        oh = jax.nn.one_hot(idx[..., kk], Ep, dtype=jnp.int32)
        pos = jnp.cumsum(oh, axis=1) - 1 + offset[:, None, :]
        offset = offset + oh.sum(axis=1)
        kept.append(np.asarray(((pos < C) & (oh > 0)).any(-1)))
    return ~np.stack(kept, -1)


def _ref_sort_dropped(idx, Ep, C):
    """The reference's dropped (token, k) choices of its sort dispatch
    (moe.py ``_sort_moe``): ranks within each expert's sorted run."""
    T, K = idx.shape
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    start = jnp.searchsorted(e_sorted, jnp.arange(Ep, dtype=jnp.int32))
    pos = jnp.arange(T * K, dtype=jnp.int32) - start[e_sorted]
    dropped = np.zeros(T * K, bool)
    dropped[np.asarray(order)[np.asarray(pos >= C)]] = True
    return dropped.reshape(T, K)


def _port_dropped(cfg, dispatch, idx, C):
    Ep = moe._num_experts(cfg)
    if dispatch == "einsum":
        return ~moe.einsum_slots(idx, Ep, C)[1].numpy()
    order, _, keep = moe.sort_slots(idx, Ep, C)
    dropped = np.zeros(idx.numel(), bool)
    dropped[order[~keep].numpy()] = True
    return dropped.reshape(idx.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    """Router ids equal, gates and the aux (Switch + z-loss) at 1e-5,
    on three groups of tokens (the reference vmaps ``_route`` over
    groups)."""
    jcfg, cfg, jp, p = _ffn(arch)
    jx, tx = _x((3, 200, cfg.d_model), seed=1)
    jg, jidx, jaux = jax.jit(jax.vmap(lambda g: j_moe._route(jp, jcfg, g)))(
        jx)
    g, idx, aux = moe._route(p, cfg, tx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(g, jg, 1e-5)
    _close(aux, jaux, 1e-5)


def test_route_breaks_ties_to_the_lowest_expert():
    """Equal probabilities pick the lowest expert id first (a stable
    argsort of −probs), in both: all-zero tokens tie every expert, and a
    router with column 2 a copy of column 0 ties experts 0 and 2."""
    jcfg, cfg, jp, p = _ffn()
    jx, tx = _x((40, cfg.d_model), seed=2)
    jx, tx = jx.at[:8].set(0), tx.clone()
    tx[:8] = 0
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 2] = w[:, 0]
    jp = dict(jp, router={"w": jnp.asarray(w)})
    p = dict(p, router={"w": torch.from_numpy(w)})
    _, jidx, _ = jax.jit(lambda x: j_moe._route(jp, jcfg, x))(jx)
    _, idx, _ = moe._route(p, cfg, tx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx[:8] == torch.tensor([0, 1])).all()
    assert ((idx == 2).any(-1) <= (idx == 0).any(-1)).all()


@pytest.mark.parametrize("exact", [False, True], ids=["capacity", "exact"])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_dispatch_matches_reference(dispatch, exact):
    """y at 2e-2 and aux at 1e-5 for both dispatches, at the capacity
    factor and exact; the dropped (token, k) choices equal the
    reference's, and at the capacity factor some are dropped."""
    jcfg, cfg, jp, p = _ffn(moe_dispatch=dispatch)
    jx, tx = _x((2, 150, cfg.d_model), seed=3, skew=(1,))
    jy, jaux = jax.jit(lambda x: j_moe.apply(jp, jcfg, x, exact=exact))(jx)
    y, aux = moe.apply(p, cfg, tx, exact=exact)
    assert y.dtype == torch.bfloat16 and y.shape == tx.shape
    _close(y, jy)
    _close(aux, jaux, 1e-5)
    T = tx.shape[0] * tx.shape[1]
    C = moe.capacity(cfg, T, exact)
    assert C == (T * 2 if exact else int(T * 2 / 4 * 1.25))
    _, idx, _ = moe._route(p, cfg, tx.reshape(T, -1))
    if dispatch == "einsum":        # T < GROUP_SIZE: one group
        jidx = jax.jit(jax.vmap(lambda g: j_moe._route(jp, jcfg, g)[1]))(
            jx.reshape(1, T, -1))
        want = _ref_einsum_dropped(jidx, 4, C)[0]
        got = _port_dropped(cfg, dispatch, idx[None], C)[0]
    else:
        jidx = jax.jit(lambda x: j_moe._route(jp, jcfg, x)[1])(
            jx.reshape(T, -1))
        want = _ref_sort_dropped(jidx, 4, C)
        got = _port_dropped(cfg, dispatch, idx, C)
    np.testing.assert_array_equal(got, want)
    assert got.any() != exact


def test_einsum_groups_of_1024_match_reference():
    """T = 2048 tokens split into two groups of GROUP_SIZE, each with
    its own capacity and aux."""
    jcfg, cfg, jp, p = _ffn()
    jx, tx = _x((2, 1024, cfg.d_model), seed=5)
    jy, jaux = jax.jit(lambda x: j_moe.apply(jp, jcfg, x))(jx)
    y, aux = moe.apply(p, cfg, tx)
    _close(y, jy)
    _close(aux, jaux, 1e-5)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_queue3_property_prefill_drops_decode_does_not(dispatch):
    """ROADMAP queue 3, "MoE capacity differs between prefill and
    decode": a prefill (S > 1) keeps at most int(Tg·K/E·1.25) choices per
    expert and group and drops the rest — tokens whose every choice is
    dropped get a zero FFN output, in both packages — while a decode
    step (S = 1) runs ``exact`` and drops nothing: its output equals
    the same tokens' ``exact=True`` result."""
    jcfg, cfg, jp, p = _ffn(moe_dispatch=dispatch)
    jx, tx = _x((1, 64, cfg.d_model), seed=6, skew=(0, 1))
    jy, _ = jax.jit(lambda x: j_moe.apply(jp, jcfg, x))(jx)
    y, _ = moe.apply(p, cfg, tx)
    C = moe.capacity(cfg, 64, False)
    _, idx, _ = moe._route(p, cfg, tx[0])
    dropped = _port_dropped(cfg, dispatch,
                            idx[None] if dispatch == "einsum" else idx, C)
    dropped = dropped.reshape(64, 2)
    assert dropped.sum() > 0
    lost = dropped.all(-1)
    assert lost.any()
    assert (y[0, torch.from_numpy(lost)] == 0).all()
    assert (np.asarray(jy, np.float32)[0, lost] == 0).all()
    # the same 64 tokens as 64 decode steps of one token each: drop-free
    jdec, _ = jax.jit(lambda x: j_moe.apply(jp, jcfg, x))(
        jx.reshape(64, 1, -1))
    dec, _ = moe.apply(p, cfg, tx.reshape(64, 1, -1))
    exact, _ = moe.apply(p, cfg, tx.reshape(64, 1, -1), exact=True)
    assert torch.equal(dec, exact)
    _close(dec, jdec)
    assert (dec.reshape(64, -1)[torch.from_numpy(lost)] != 0).any(-1).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_reference(arch):
    jcfg, cfg, jparams, params = _model(arch)
    toks = _tokens(cfg, (2, 24))
    want, jaux = jax.jit(lambda p, t: j_build(jcfg).logits(
        p, {"tokens": t}))(jparams, jnp.asarray(toks))
    got, aux = models.build(cfg).logits(params,
                                        {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert float(aux) > 0
    _close(aux, jaux, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill (flash, capacity factor) and 4 decode steps (exact)."""
    got, want, _ = _serve(arch, 4)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_equals_reference_bitwise(arch, seed):
    cfg, want = _ref_params(arch, seed)
    _assert_params_equal(models.build(cfg).init(seed, "cpu"), want)


def test_loss_matches_reference():
    """``Model.loss_fn`` on reduced granite-moe: the weighted loss plus
    the MoE aux, and the aux alone, within 2e-2 of the reference's."""
    (loss, aux), (jloss, jaux) = loss_both("granite-moe-3b-a800m")
    assert aux > 0
    np.testing.assert_allclose([loss, aux], [jloss, jaux], rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k", "tiny"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cache_matches_reference(arch, shape):
    shapes = dict(j_base.INPUT_SHAPES,
                  tiny=j_base.ShapeConfig("tiny", 64, 2, "decode"))
    assert_serve_cache_matches(arch, shapes[shape])


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_lm_prints_its_json_line(arch):
    cli_lm(arch)


def test_moe_ffn_span_frames_each_moe_layer():
    """Under an active trace recorder a profiler capture of a prefill
    and a decode step shows one ``moe_ffn`` region per MoE layer and
    step (what ``chip_smoke.py`` reads the MoE's device share from);
    with no recorder the span is the no-op and shows nothing."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace as obs_trace

    _, cfg, _, params = _model("granite-moe-3b-a800m")
    model = models.build(cfg)
    toks = torch.from_numpy(_tokens(cfg, (2, 8)))

    def regions():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, caches = model.make_prefill_step()(params,
                                                  {"tokens": toks[:, :7]})
            model.make_decode_step()(params, caches, toks[:, 7:])
        return sum(e.count for e in prof.key_averages() if e.key == "moe_ffn")

    assert regions() == 0
    with obs_trace.recording():
        assert regions() == 2 * cfg.num_layers
