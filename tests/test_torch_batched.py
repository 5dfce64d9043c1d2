"""The port's batched engine ≡ the JAX batched engine, bit for bit.

The JAX engine (``repro.core.batched``) is itself held bit-equal to the
host reference loop by tests/test_batched.py; the port is held to it on
the same grid, on the CPU.  Protocol outputs — attempts, rounds, stuck
history, winning hypotheses, dispute sets with their D-table counts,
every integer ledger field, the final classifier on S — must be equal.
``min_loss`` is a float diagnostic and gets rtol 1e-5: the port follows
XLA:CPU's float32 rounding op by op (repro_torch.core.fp32), but a
rewrite XLA applies inside the fused engine program can still move a
last bit (ROADMAP queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as j_batched
from repro.core import classify as j_classify
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro_torch.core import batched, prng, tasks, weak
from repro_torch.core.types import BoostConfig

N = 1 << 12
CFG = dict(k=4, coreset_size=100, domain_size=N, opt_budget=16)

STATE_ARRAYS = ("rounds", "ok", "attempts", "alive", "disputed",
                "hist_stuck", "hist_rounds", "hist_alive", "hist_p",
                "hist_players", "hist_players_h", "hist_players_last")


def assert_task_parity(ref, got):
    """The reference's per-task contract (tests/test_batched.py)."""
    assert ref.attempts == got.attempts
    assert ref.rounds == got.rounds
    assert ref.stuck_history == got.stuck_history
    np.testing.assert_array_equal(np.asarray(ref.hypotheses)[:ref.rounds],
                                  np.asarray(got.hypotheses)[:got.rounds])
    assert dataclasses.asdict(ref.ledger) == dataclasses.asdict(got.ledger)
    np.testing.assert_array_equal(np.asarray(ref.dispute_x),
                                  np.asarray(got.dispute_x))
    for r, g in zip(ref.dispute_y, got.dispute_y):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(g))


def assert_results_equal(ref, got):
    for f in STATE_ARRAYS:
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f), f)
    np.testing.assert_allclose(got.min_loss, ref.min_loss, rtol=1e-5)
    for b in range(ref.batch):
        R = int(ref.rounds[b])
        np.testing.assert_array_equal(ref.hypotheses[b, :R],
                                      got.hypotheses[b, :R])
        assert dataclasses.asdict(ref.ledger(b)) == \
            dataclasses.asdict(got.ledger(b))


@pytest.mark.parametrize("clsname,noise", [
    ("thresholds", 0), ("thresholds", 3), ("intervals", 3),
    ("singletons", 2),
])
def test_port_equals_jax_batched_engine(clsname, noise):
    jcls = j_weak.make_class(clsname, n=N)
    cls = weak.make_class(clsname, n=N)
    B, m = 4, 512
    x, y, _ = j_tasks.make_batch(jcls, B, m, 4, noise, seed0=11)
    px, py, _ = tasks.make_batch(cls, B, m, 4, noise, seed0=11)
    np.testing.assert_array_equal(px, x)
    np.testing.assert_array_equal(py, y)
    keys = jax.random.split(jax.random.key(5), B)
    ref = j_batched.run_accurately_classify_batched(x, y, keys,
                                                    JConfig(**CFG), jcls)
    got = batched.run_accurately_classify_batched(
        px, py, prng.split(prng.key(5), B), BoostConfig(**CFG), cls,
        device="cpu")
    assert bool(got.ok.all())
    assert_results_equal(ref, got)
    for b in range(B):
        assert_task_parity(ref.per_task(b), got.per_task(b))
        flat = x[b].reshape(-1)
        np.testing.assert_array_equal(
            np.asarray(ref.classifier(b)(jnp.asarray(flat))),
            got.classifier(b)(torch.from_numpy(flat)).numpy())
        # and the host reference loop's classifier, through the JAX
        # engine's contract with it
        host = j_classify.make_classifier(jcls, ref.per_task(b))
        np.testing.assert_array_equal(
            np.asarray(host(jnp.asarray(flat))),
            got.classifier(b)(torch.from_numpy(flat)).numpy())
