"""The port's protocol modules against the JAX reference, module by
module, on seeded numpy inputs.

Integer outputs (round bounds, ledger bits, coreset indices, ERM
hypotheses, quarantine matches) must match bit for bit.  The float32
sums, prefix sums, log2 and exp2 the port spells out in the
reference's rounding order (repro_torch.core.fp32) must match bit for
bit as well.  Float diagnostics whose inputs differ by design (the
mixture and log weight sums, computed by torch from another summation)
get rtol 1e-5: torch's and XLA's float32 sum/log2/exp2 differ by an ulp.
"""

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approximation as j_approx
from repro.core import batched as j_batched
from repro.core import classify as j_classify
from repro.core import ledger as j_ledger
from repro.core import weak as j_weak
from repro.core import weights as j_weights
from repro.core.types import BoostConfig as JConfig
from repro_torch.core import approximation, batched, classify, fp32
from repro_torch.core import ledger, prng, streaming, tasks, weak, weights
from repro_torch.core.types import BoostConfig
from repro_torch.weak_tree import HistogramTrees

CLASSES = ("thresholds", "intervals", "singletons")


def _wide_floats(rng, shape):
    return (rng.uniform(0.5, 1.0, shape)
            * 2.0 ** rng.integers(-30, 5, shape)).astype(np.float32)


@pytest.mark.parametrize("n", [3, 16, 33, 100, 400, 1000, 5000])
def test_fp32_sums_follow_xla_order(n):
    x = _wide_floats(np.random.default_rng(n), (7, n))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        fp32.sum_(xt).numpy(), np.asarray(jax.jit(
            lambda v: jnp.sum(v, axis=-1))(x)))
    np.testing.assert_array_equal(
        fp32.cumsum(xt).numpy(), np.asarray(jax.jit(
            lambda v: jnp.cumsum(v, axis=-1))(x)))


def test_fp32_transcendentals_follow_xla():
    rng = np.random.default_rng(1)
    pos = rng.uniform(1e-3, 1e7, 50000).astype(np.float32)
    np.testing.assert_array_equal(fp32.log2(torch.from_numpy(pos)).numpy(),
                                  np.asarray(jnp.log2(pos)))
    arg = rng.uniform(-80.0, 0.0, 50000).astype(np.float32)
    np.testing.assert_array_equal(fp32.exp2(torch.from_numpy(arg)).numpy(),
                                  np.asarray(jnp.exp2(arg)))
    np.testing.assert_array_equal(
        fp32.EXP2_NEG.numpy(),
        np.asarray(jnp.exp2(-jnp.arange(127, dtype=jnp.float32))))


def test_num_rounds_every_m_host_and_traced():
    m = np.arange(2, 2 ** 21 + 1)
    mt = torch.from_numpy(m).float()
    cfg, jcfg = BoostConfig(k=4), JConfig(k=4)
    # the reference's host path: eager float32 ops, one at a time
    with jax.ensure_compile_time_eval():
        host = np.asarray(jnp.ceil(cfg.rounds_factor * jnp.log2(
            jnp.asarray(m, jnp.float32)))).astype(np.int32)
    np.testing.assert_array_equal(
        fp32.num_rounds(6, mt, traced=False).numpy(), host)
    traced = np.asarray(jax.jit(lambda v: j_batched.num_rounds_dynamic(
        jcfg, v))(m.astype(np.int32)))
    np.testing.assert_array_equal(
        batched.num_rounds_dynamic(cfg, torch.from_numpy(m)).numpy(),
        traced)
    # where the two reference paths disagree, each port path follows
    # its own (ROADMAP queue 3)
    split = m[host != traced]
    assert split.size > 0
    for v in split[:4].tolist() + [2, 3, 512, 4096, 2 ** 20, 2 ** 21]:
        assert cfg.num_rounds(v) == jcfg.num_rounds(v), v


def _ledger_dict(led):
    return {f.name: getattr(led, f.name) for f in dataclasses.fields(led)}


@pytest.mark.parametrize("clsname", CLASSES)
def test_ledger_formulas_equal_reference(clsname):
    for n in (2, 100, 4096, 65536, 65537):
        cls, jcls = weak.make_class(clsname, n=n), j_weak.make_class(
            clsname, n=n)
        assert cls.hypothesis_bits() == jcls.hypothesis_bits(), n
    cls = weak.make_class(clsname, n=4096)
    jcls = j_weak.make_class(clsname, n=4096)
    for k, c in ((1, 16), (4, 100)):
        cfg = BoostConfig(k=k, coreset_size=c, domain_size=4096)
        jcfg = JConfig(k=k, coreset_size=c, domain_size=4096)
        for m, rounds, stuck in itertools.product(
                (2, 100, 512, 46341, 2 ** 20), (0, 5, 54), (False, True)):
            assert _ledger_dict(ledger.boost_attempt_ledger(
                cfg, cls, m, rounds, stuck)) == _ledger_dict(
                j_ledger.boost_attempt_ledger(jcfg, jcls, m, rounds, stuck))
            wire = rounds + stuck
            for pr, ph, pl in ((wire * k, rounds * k, k),
                               (max(wire * k - 3, 0), max(rounds * k - 2, 0),
                                max(k - 1, 0))):
                assert _ledger_dict(ledger.boost_attempt_ledger_masked(
                    cfg, cls, m, rounds, stuck, pr, ph, pl)) == _ledger_dict(
                    j_ledger.boost_attempt_ledger_masked(
                        jcfg, jcls, m, rounds, stuck, pr, ph, pl))
            for opt in (0, 3):
                assert ledger.theorem_41_bound(cfg, cls, m, opt, 1.5) == \
                    j_ledger.theorem_41_bound(jcfg, jcls, m, opt, 1.5)


def _player_inputs(seed, B=3, k=4, mloc=128, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, n, (B, k, mloc)).astype(np.int32)
    y = np.where(rng.random((B, k, mloc)) < 0.4, 1, -1).astype(np.int8)
    hits = rng.integers(0, 60, (B, k, mloc)).astype(np.int32)
    alive = rng.random((B, k, mloc)) < 0.9
    alive[0, 1] = False                      # an all-dead shard
    y[1, 2] = 1                              # a one-label shard
    return x, y, hits, alive


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantile_coreset_indices_equal_reference(seed):
    x, y, hits, alive = _player_inputs(seed)
    c = 100
    ref = np.asarray(jax.jit(jax.vmap(jax.vmap(
        lambda a, b, h, al: j_approx.quantile_coreset(a, b, h, al, c))))(
        x, y, hits, alive))
    t = [torch.from_numpy(v) for v in (x, y, hits, alive)]
    order = streaming.sort_order(t[0])
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(x, axis=-1, kind="stable"))
    got = approximation.select_coreset(*t, c, True, order=order)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("clsname", CLASSES)
def test_erm_params_equal_reference(clsname):
    rng = np.random.default_rng(7)
    n = 512
    B, K = 6, 400
    xs = rng.integers(0, n, (B, K)).astype(np.int32)
    xs[1] = np.repeat(xs[1, :40], 10)                 # heavy duplicates
    ys = np.where(rng.random((B, K)) < 0.5, 1, -1).astype(np.int8)
    mix = rng.dirichlet(np.ones(4), B).astype(np.float32)
    w = np.repeat(mix / np.float32(100), 100, axis=1).astype(np.float32)
    w[2] = np.float32(1.0 / K)                        # tie-rich weights
    jcls, cls = j_weak.make_class(clsname, n=n), weak.make_class(
        clsname, n=n)
    jp, jl = jax.jit(jax.vmap(jcls.erm))(xs, ys, w)
    p, loss = cls.erm(torch.from_numpy(xs), torch.from_numpy(ys),
                      torch.from_numpy(w))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-5)
    pts = torch.from_numpy(xs[:, :50])
    np.testing.assert_array_equal(
        cls.predict(p, pts).numpy(),
        np.stack([np.asarray(jcls.predict(jp[b], xs[b, :50]))
                  for b in range(B)]))


def test_quarantine_primitives_equal_reference():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 300, (3, 4, 64)).astype(np.int32)
    pts = rng.integers(0, 300, (3, 40)).astype(np.int32)
    valid = rng.random((3, 40)) < 0.7
    masked = classify.mask_invalid_points(torch.from_numpy(pts),
                                          torch.from_numpy(valid))
    for b in range(3):
        jm = j_classify.mask_invalid_points(pts[b], valid[b])
        np.testing.assert_array_equal(masked[b].numpy(), np.asarray(jm))
        np.testing.assert_array_equal(
            classify.match_points(torch.from_numpy(x), masked)[b].numpy(),
            np.asarray(j_classify.match_points(x[b], jm)))
        assert int(classify.distinct_count_masked(
            torch.from_numpy(pts), torch.from_numpy(valid))[b]) == int(
            j_classify.distinct_count_masked(pts[b], valid[b]))
    y = np.where(rng.random((4, 64)) < 0.5, 1, -1).astype(np.int8)
    disputed = np.isin(x[0], pts[0, :10])
    for got, want in zip(
            classify.dispute_table(x[0], y, np.ones((4, 64), bool), disputed),
            j_classify.dispute_table(x[0], y, np.ones((4, 64), bool),
                                     disputed)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_weights_within_stated_tolerance():
    _, _, hits, alive = _player_inputs(5)
    ht, at = torch.from_numpy(hits), torch.from_numpy(alive)
    jl = np.array(jax.vmap(jax.vmap(j_weights.log_weight_sum))(hits,
                                                               alive))
    pl = weights.log_weight_sum(ht, at).numpy()
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert np.isneginf(pl[0, 1]) and np.isneginf(jl[0, 1])
    # the engine's form, from the kernel's unshifted sum
    wsum = torch.where(at, torch.exp2(-ht.double()), 0.0).sum(-1).float()
    hmin = weights.least_alive_hits(ht, at)
    np.testing.assert_allclose(
        weights.log_wsums_from_sums(wsum, hmin).numpy(), jl, rtol=1e-5)
    np.testing.assert_allclose(
        weights.mixture_weights(torch.from_numpy(jl)).numpy(),
        np.asarray(jax.vmap(j_weights.mixture_weights)(jl)), rtol=1e-5)
    np.testing.assert_array_equal(
        weights.update_hits(ht, at, at).numpy(),
        np.asarray(j_weights.update_hits(hits, alive, alive)))


def test_slice_boundaries_raise_with_their_queue_item(monkeypatch, capsys):
    """Item 10 (the streaming tier) is ported: the three places that
    refused ``chunk_size`` now run it and equal the monolithic path,
    the engine through ``BoostConfig.chunk_size`` included; item 13's
    ``serve --workload serve-stream`` now serves a stream."""
    x = torch.tensor([[[5, 1, 7, 1, 0, 3, 3, 6]]], dtype=torch.int32)
    np.testing.assert_array_equal(
        streaming.sort_order(x, chunk_size=4).numpy(),
        torch.argsort(x, dim=-1, stable=True).numpy())
    assert HistogramTrees(num_features=4, chunk_size=4).chunk_size == 4
    y = torch.tensor([[[1, -1, 1, -1, -1, 1, 1, 1]]], dtype=torch.int8)
    runs = [batched.run_accurately_classify_batched(
        x, y, prng.key(0)[None], BoostConfig(k=1, coreset_size=4,
                                             chunk_size=chunk),
        weak.Thresholds(n=64), device="cpu") for chunk in (4, None)]
    for f in ("hypotheses", "rounds", "ok", "attempts", "disputed"):
        np.testing.assert_array_equal(getattr(runs[0], f),
                                      getattr(runs[1], f), f)
    # item 13 (the scheduler) is ported too: the CLI serves a short
    # stream where it used to refuse it
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", [
        "serve", "--workload", "serve-stream", "--device", "cpu",
        "--requests", "3", "--m", "32", "--k", "2", "--coreset", "16",
        "--opt-budget", "4", "--no-warmup"])
    serve.main()
    out = json.loads(capsys.readouterr().out)
    assert out["ok"] == out["served"] == 3
    assert out["kernel_launches"] == {"mw_update": 0, "histogram": 0}
