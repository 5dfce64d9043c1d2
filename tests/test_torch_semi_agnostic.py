"""The semi-agnostic reduction (``core/semi_agnostic.py``) in the port
against the JAX package, bit for bit.

The T rounds of agnostic boosting — every hypothesis and every round's
ERM loss, against the reference's compiled ``lax.scan`` — and the whole
``SemiAgnosticResult`` (errors, patch, dispute table, ledger), on
``tests/test_semi_agnostic.py``'s cases, ``benchmarks/baselines.py``'s
two (Thresholds, n = 2^12, m = 2048, k = 4, coreset 400, noise 4 and
12) and one AxisStumps case.  No tolerance is used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semi_agnostic as j_sa
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro_torch.core import prng, semi_agnostic, weak
from repro_torch.core.types import BoostConfig

torch.set_num_threads(1)

N = 1 << 12


def _cfgs(**kw):
    return JConfig(**kw), BoostConfig(**kw)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name,noise", [("thresholds", 4),
                                        ("intervals", 4),
                                        ("singletons", 12)])
def test_agnostic_rounds_equal_reference_bitwise(name, noise):
    """Every round's hypothesis and ERM loss, against the reference's
    compiled scan."""
    jc, pc = j_weak.make_class(name, n=N), weak.make_class(name, n=N)
    task = j_tasks.make_task(jc, m=2048, k=4, noise=noise, seed=noise)
    jcfg, cfg = _cfgs(k=4, coreset_size=400, domain_size=N)
    T = jcfg.num_rounds(2048)
    alive = np.ones(task.x.shape, bool)
    jh, jl = j_sa._agnostic_boost_jit(
        jnp.asarray(task.x), jnp.asarray(task.y), jnp.asarray(alive),
        jax.random.key(3), jcfg, jc, T, 8.0)
    ph, pl = semi_agnostic.agnostic_boost(
        torch.from_numpy(task.x), torch.from_numpy(task.y),
        torch.from_numpy(alive), prng.key(3), cfg, pc, T, 8.0)
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(_bits(pl), _bits(jl))


def _assert_sa_equal(got, want):
    for f in ("boost_errors", "final_errors", "patched"):
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.asdict(got.ledger) == dataclasses.asdict(want.ledger)
    gf, wf = got.classifier, want.classifier
    assert gf.rounds == int(wf.rounds)
    np.testing.assert_array_equal(gf.hypotheses, np.asarray(wf.hypotheses))
    for a in ("dispute_x", "dispute_pos", "dispute_neg"):
        np.testing.assert_array_equal(getattr(gf, a),
                                      np.asarray(getattr(wf, a)))


@pytest.mark.parametrize("m,noise,seed,key,budget", [
    (1024, 6, 2, 0, 64), (1024, 0, 5, 0, 64),     # test_semi_agnostic
    (2048, 4, 0, 0, 96), (2048, 12, 1, 1, 96)])   # baselines.py
def test_run_semi_agnostic_equals_reference(m, noise, seed, key, budget):
    jcfg, cfg = _cfgs(k=4, coreset_size=400, domain_size=N,
                      opt_budget=budget)
    jc, pc = j_weak.Thresholds(n=N), weak.Thresholds(n=N)
    task = j_tasks.make_task(jc, m=m, k=4, noise=noise, seed=seed)
    want = j_sa.run_semi_agnostic(jnp.asarray(task.x), jnp.asarray(task.y),
                                  jax.random.key(key), jcfg, jc)
    got = semi_agnostic.run_semi_agnostic(task.x, task.y, prng.key(key),
                                          cfg, pc, device="cpu")
    _assert_sa_equal(got, want)
    assert got.final_errors <= got.boost_errors
    # the patch is exact on every broadcast point
    f = got.classifier
    for p in f.dispute_x.tolist():
        copies = task.flat_y[task.flat_x == p]
        maj = 1 if (copies > 0).sum() >= (copies < 0).sum() else -1
        assert int(f(torch.tensor([p], dtype=torch.int32))[0]) == maj


def test_run_semi_agnostic_stumps_equals_reference():
    jc = j_weak.make_class("stumps", num_features=4)
    pc = weak.make_class("stumps", num_features=4)
    task = j_tasks.make_task(jc, m=512, k=4, noise=4, seed=3)
    jcfg, cfg = _cfgs(k=4, coreset_size=64, domain_size=N)
    want = j_sa.run_semi_agnostic(jnp.asarray(task.x), jnp.asarray(task.y),
                                  jax.random.key(5), jcfg, jc)
    got = semi_agnostic.run_semi_agnostic(task.x, task.y, prng.key(5),
                                          cfg, pc, device="cpu")
    _assert_sa_equal(got, want)
