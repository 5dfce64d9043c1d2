"""The port's stepping API: slicing, player schedules, and state carried
over from the JAX engine.

Slices of ``run_rounds`` (1, 3, 7 rounds per call) give the monolithic
run's final state bit for bit, weight sums included; a dropout schedule
gives the JAX engine's masked ledger; a JAX state converted after 3
rounds and finished by the port equals the JAX run to completion.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import batched as j_batched
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro_torch import convert
from repro_torch.core import batched, prng, weak
from repro_torch.core.types import BoostConfig

from test_torch_batched import CFG, N, assert_results_equal

B, M, NOISE = 2, 512, 3


def _batch():
    x, y, _ = j_tasks.make_batch(j_weak.Thresholds(n=N), B, M, 4, NOISE,
                                 seed0=11)
    return x, y


def _run_sliced(x, y, n, sched=None):
    cfg, cls = BoostConfig(**CFG), weak.Thresholds(n=N)
    s = batched.init_state(x, y, prng.key(5), cfg, cls=cls, device="cpu")
    for _ in range(500):
        s = batched.run_rounds(s, x, y, cfg, cls, n=n, player_sched=sched)
        if not bool((~s.done & (s.attempt < cfg.opt_budget + 1)).any()):
            break
    return s


@pytest.mark.parametrize("slice_rounds", [1, 3, 7])
def test_sliced_runs_equal_monolithic(slice_rounds):
    x, y = _batch()
    whole = _run_sliced(x, y, None)
    sliced = _run_sliced(x, y, slice_rounds)
    for name, a, b in zip(batched.StepState._fields, whole, sliced):
        assert torch.equal(a, b), name
    cfg, cls = BoostConfig(**CFG), weak.Thresholds(n=N)
    s0 = batched.init_state(x, y, prng.key(5), cfg, cls=cls, device="cpu")
    same = batched.run_rounds(s0, x, y, cfg, cls, n=0)
    assert all(torch.equal(a, b) for a, b in zip(s0, same))


def test_dropout_schedule_gives_the_masked_ledger():
    x, y = _batch()
    sched = np.ones((12, 4), bool)
    sched[5:, 1] = False                  # player 1 drops at round 5
    keys = jax.random.split(jax.random.key(5), B)
    ref = j_batched.run_accurately_classify_batched(
        x, y, keys, JConfig(**CFG), j_weak.Thresholds(n=N),
        player_sched=sched)
    got = batched.run_accurately_classify_batched(
        x, y, prng.key(5), BoostConfig(**CFG), weak.Thresholds(n=N),
        player_sched=sched, device="cpu")
    assert_results_equal(ref, got)
    assert (got.hist_players < got.hist_rounds * 4 + 4).any()


def test_jax_state_finished_by_the_port():
    x, y = _batch()
    jcfg, jcls = JConfig(**CFG), j_weak.Thresholds(n=N)
    keys = jax.random.split(jax.random.key(5), B)
    js = j_batched.init_state(x, y, keys, jcfg, cls=jcls)
    js = j_batched.run_rounds(js, x, y, jcfg, jcls, n=3)
    ref = j_batched.finalize(j_batched.run_rounds(js, x, y, jcfg, jcls),
                             x, y, np.ones(x.shape, bool), jcfg, jcls)
    cfg, cls = BoostConfig(**CFG), weak.Thresholds(n=N)
    ps = convert.from_jax(jax.device_get(js)._asdict(), device="cpu")
    ps = batched.run_rounds(ps, x, y, cfg, cls)
    got = batched.finalize(ps, x, y, np.ones(x.shape, bool), cfg, cls)
    assert_results_equal(ref, got)


def test_port_state_finished_by_jax():
    x, y = _batch()
    cfg, cls = BoostConfig(**CFG), weak.Thresholds(n=N)
    ps = batched.init_state(x, y, prng.key(5), cfg, cls=cls, device="cpu")
    ps = batched.run_rounds(ps, x, y, cfg, cls, n=3)
    leaves = convert.to_jax(ps)
    assert set(leaves) == set(j_batched.StepState._fields)
    for f, dtype in j_batched.STATE_DTYPES.items():
        assert leaves[f].dtype == np.dtype(dtype), f
    jcfg, jcls = JConfig(**CFG), j_weak.Thresholds(n=N)
    js = j_batched.StepState(**leaves)
    ref = j_batched.finalize(j_batched.run_rounds(js, x, y, jcfg, jcls),
                             x, y, np.ones(x.shape, bool), jcfg, jcls)
    got = batched.finalize(batched.run_rounds(ps, x, y, cfg, cls), x, y,
                           np.ones(x.shape, bool), cfg, cls)
    assert_results_equal(ref, got)


def test_init_state_refuses_more_than_126_rounds():
    cfg = BoostConfig(k=4, coreset_size=8, domain_size=N)
    x = np.zeros((1, 4, 2 ** 19 + 1), np.int32)
    with pytest.raises(ValueError, match="item 10"):
        batched.init_state(x, np.ones(x.shape, np.int8), prng.key(0), cfg,
                           device="cpu")
