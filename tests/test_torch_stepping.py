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

from test_torch_batched import (CFG, N, assert_results_equal,
                                assert_task_parity)

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


def test_port_equals_jax_past_126_rounds():
    """240 rounds (rounds_factor 30 at m = 256): with noise 0 every hit
    count reaches 240, past float32's normal range for an unshifted
    Σ 2^−hits.  The shifted sum keeps every protocol output and ledger
    field equal to the JAX engine's."""
    x, y, _ = j_tasks.make_batch(j_weak.Thresholds(n=N), B, 256, 4, 0,
                                 seed0=11)
    cfg = dict(k=4, coreset_size=100, domain_size=N, rounds_factor=30,
               opt_budget=4)
    keys = jax.random.split(jax.random.key(5), B)
    ref = j_batched.run_accurately_classify_batched(
        x, y, keys, JConfig(**cfg), j_weak.Thresholds(n=N))
    got = batched.run_accurately_classify_batched(
        x, y, prng.key(5), BoostConfig(**cfg), weak.Thresholds(n=N),
        device="cpu")
    assert BoostConfig(**cfg).num_rounds(256) == 240
    assert got.ok.all() and (got.rounds == 240).all()
    assert_results_equal(ref, got)
    for b in range(B):
        assert_task_parity(ref.per_task(b), got.per_task(b))


def test_init_state_takes_more_than_126_rounds():
    """k = 4, mloc = 2^19 + 1: m = 2^21 + 4 per task needs 127 rounds."""
    cfg = BoostConfig(k=4, coreset_size=8, domain_size=N)
    x = np.zeros((1, 4, 2 ** 19 + 1), np.int32)
    assert cfg.num_rounds(4 * x.shape[2]) == 127
    s = batched.init_state(x, np.ones(x.shape, np.int8), prng.key(0), cfg,
                           device="cpu")
    assert s.h_params.shape[1] == 127
    assert s.wsum_shift.dtype == torch.int32
    assert s.wsum_shift.shape == s.wsum.shape == (1, 4)
