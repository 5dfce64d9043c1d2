"""The port's feature track ≡ the JAX batched engine.

AxisStumps (the reference's own feature-track parity case,
tests/test_batched.py::test_batched_parity_feature_track) and
HistogramTrees in its three wire modes run on both engines with the
same seeds and keys; every protocol output — attempts, rounds, stuck
history, winning hypotheses, dispute rows with their D-table counts,
every integer ledger field, the final classifier on S — must be equal.
``min_loss`` is a float diagnostic of total weight ≈ 1: rtol 1e-5 plus
atol 1e-6 for near-zero float32 cancellation residues.

The trees are held to the batched engine, not the host loop (the
reference's own host and batched tree runs differ on one case, ROADMAP
queue 3).  Their splits depend on the float order of the histogram
sums, which XLA:CPU picks by shape and, possibly, by host: each tree
test first probes that the reference's histogram on this host sums in
the port's order at the test's shapes, and skips with that reason if
it does not (ROADMAP queue 3).

One case is a known divergence, held as a strict xfail: at shard sizes
mloc 250–300 the reference's jitted ``sampled_coreset`` names an index
past the shard for many draws, where the port (like the reference op
by op) gives the true argmax (ROADMAP queue 3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as j_batched
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro.kernels.histogram import ref as j_hist
from repro_torch.core import batched, prng, tasks, weak
from repro_torch.core.types import BoostConfig
from repro_torch.kernels.histogram import ops as hist_ops

from test_torch_batched import STATE_ARRAYS, assert_task_parity

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

N = 1 << 12
STUMPS_CFG = dict(k=2, coreset_size=64, domain_size=N, opt_budget=8,
                  deterministic_coreset=False)
TREE_CFG = dict(k=4, coreset_size=100, domain_size=N, opt_budget=16,
                deterministic_coreset=False)
TREE_B, TREE_M, TREE_NOISE, TREE_SEED, TREE_KEY = 2, 256, 2, 3, 5
PAST_THE_SHARD = (
    "ROADMAP queue 3, 'The reference's sampled coreset names an index "
    "past the shard at mloc 250-300': jitted on XLA:CPU its "
    "pinned_argmax returns m for many draws at mloc 256, the port "
    "returns the true argmax, so the runs diverge")


def _tree_kw(mode):
    return dict(num_features=4, tree_depth=2, tree_bins=8,
                tree_comm_mode=mode)


def assert_feature_results_equal(ref, got):
    for f in STATE_ARRAYS:
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f), f)
    np.testing.assert_allclose(got.min_loss, ref.min_loss, rtol=1e-5,
                               atol=1e-6)
    for b in range(ref.batch):
        R = int(ref.rounds[b])
        np.testing.assert_array_equal(ref.hypotheses[b, :R],
                                      got.hypotheses[b, :R])
        assert dataclasses.asdict(ref.ledger(b)) == \
            dataclasses.asdict(got.ledger(b))


def _assert_every_task(ref, got, x):
    assert_feature_results_equal(ref, got)
    for b in range(ref.batch):
        if not ref.ok[b]:
            continue
        assert_task_parity(ref.per_task(b), got.per_task(b))
        flat = x[b].reshape(-1, x.shape[-1])
        np.testing.assert_array_equal(
            np.asarray(ref.classifier(b)(jnp.asarray(flat))),
            got.classifier(b)(torch.from_numpy(flat)).numpy())


def _probe_histogram_order(B, F, Q):
    """Skip unless this host's XLA sums the reference's histograms in
    the port's order at the engine test's shapes: the pooled coreset
    (k·c points, one and two nodes) and one player's coreset."""
    reason = _histogram_order_differs(B, F, Q)
    if reason:
        pytest.skip(reason)


@functools.cache
def _histogram_order_differs(B, F, Q):
    rng = np.random.default_rng(0)
    k, c = TREE_CFG["k"], TREE_CFG["coreset_size"]
    for pts in (k * c, c):
        for nodes in (1, 2):
            x = rng.random((B, pts, F), dtype=np.float32)
            route = rng.integers(0, nodes, (B, pts))
            wv = (rng.random((B, pts)) / pts).astype(np.float32)
            wyv = np.where(rng.random((B, pts)) < 0.5, -wv, wv)

            def f(x, wv, wyv, route, nodes=nodes):
                # trees.py's construction of the routed weights
                on = route[:, None] == jnp.arange(nodes)[None]
                return j_hist.node_histograms_ref(
                    x, jnp.where(on, wv[:, None], 0.0).T,
                    jnp.where(on, wyv[:, None], 0.0).T, Q)

            want = jax.jit(jax.vmap(f))(x, wv, wyv, route)
            on = route[..., None] == np.arange(nodes)
            got = hist_ops.node_histograms(*(
                torch.from_numpy(np.ascontiguousarray(a)) for a in (
                    x, np.where(on, wv[..., None], 0.0).astype(
                        np.float32).transpose(0, 2, 1),
                    np.where(on, wyv[..., None], 0.0).astype(
                        np.float32).transpose(0, 2, 1))), Q)
            for g, r in zip(got, want):
                if not np.array_equal(g.numpy(), np.asarray(r)):
                    return (f"this host's XLA:CPU sums the reference's "
                            f"histogram ({pts} points, {nodes} node(s)) "
                            f"in another order than ref.xla_cpu_block; "
                            f"the trees' splits may differ (ROADMAP "
                            f"queue 3)")
    return ""


def test_axis_stumps_equal_jax_batched_engine():
    jcls, cls = j_weak.AxisStumps(num_features=4), weak.AxisStumps(
        num_features=4)
    B, m = 2, 128
    x, y, _ = j_tasks.make_batch(jcls, B, m, 2, 1, seed0=3)
    px, py, _ = tasks.make_batch(cls, B, m, 2, 1, seed0=3)
    np.testing.assert_array_equal(px, x)
    np.testing.assert_array_equal(py, y)
    ref = j_batched.run_accurately_classify_batched(
        x, y, jax.random.split(jax.random.key(9), B), JConfig(**STUMPS_CFG),
        jcls)
    got = batched.run_accurately_classify_batched(
        px, py, prng.key(9), BoostConfig(**STUMPS_CFG), cls, device="cpu")
    assert bool(got.ok.all())
    _assert_every_task(ref, got, x)


def _tree_runs(mode, m=TREE_M):
    jcls = j_weak.make_class("tree", **_tree_kw(mode))
    cls = weak.make_class("tree", **_tree_kw(mode))
    x, y, _ = j_tasks.make_batch(jcls, TREE_B, m, 4, TREE_NOISE,
                                 seed0=TREE_SEED)
    px, py, _ = tasks.make_batch(cls, TREE_B, m, 4, TREE_NOISE,
                                 seed0=TREE_SEED)
    np.testing.assert_array_equal(px, x)
    np.testing.assert_array_equal(py, y)
    return jcls, cls, x, y


def _tree_results(mode, m=TREE_M):
    jcls, cls, x, y = _tree_runs(mode, m)
    keys = jax.random.split(jax.random.key(TREE_KEY), TREE_B)
    ref = j_batched.run_accurately_classify_batched(
        x, y, keys, JConfig(**TREE_CFG), jcls)
    got = batched.run_accurately_classify_batched(
        x, y, prng.split(prng.key(TREE_KEY), TREE_B),
        BoostConfig(**TREE_CFG), cls, device="cpu")
    return ref, got, x


@pytest.mark.parametrize("mode", ["coreset", "histogram", "voting"])
def test_trees_equal_jax_batched_engine(mode):
    _probe_histogram_order(TREE_B, 4, 8)
    ref, got, x = _tree_results(mode)
    assert int(got.ok.sum()) >= 1
    assert (got.attempts > 1).any()       # quarantine ran
    _assert_every_task(ref, got, x)


@pytest.mark.xfail(strict=True, raises=AssertionError, reason=PAST_THE_SHARD)
def test_trees_equal_jax_batched_engine_at_mloc_256():
    # m = 1024 over k = 4 players: shards of 256 points
    _probe_histogram_order(TREE_B, 4, 8)
    ref, got, x = _tree_results("coreset", m=1024)
    _assert_every_task(ref, got, x)
