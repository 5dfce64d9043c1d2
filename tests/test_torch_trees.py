"""The port's feature-track weak learners against the JAX package.

HistogramTrees' ``erm`` (pooled coresets) and ``erm_players``
(histogram and voting modes) on seeded coresets, and AxisStumps' ERM:
the trees' (feature, bin, sign) and the stumps' hypotheses must match
bit for bit, ``predict`` must agree everywhere.  The returned loss is a
float diagnostic: a weighted error of total weight ≈ 1, so it gets
rtol 1e-5 plus atol 1e-6 for the near-zero residues of float32
cancellation (XLA fuses the final sums in an order the port does not
reproduce to the last bit).  The tree ledger branches must match the
reference's integer bits.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import ledger as j_ledger
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro.weak_tree import HistogramTrees as JTrees
from repro_torch.core import ledger, weak
from repro_torch.core.types import BoostConfig, Ledger
from repro_torch.weak_tree import HistogramTrees

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

TREES = [(4, 2, 8, 100), (8, 2, 32, 100), (3, 3, 16, 37)]   # F, depth, Q, c
MODES = ("coreset", "histogram", "voting")


def _coresets(seed, F, Q, c, B=3, k=4, dead=True):
    rng = np.random.default_rng(seed)
    x = ((np.floor(rng.random((B, k, c, F)) * Q) + 0.5) / Q
         ).astype(np.float32)
    y = np.where(rng.random((B, k, c)) < 0.5, 1, -1).astype(np.int8)
    mix = rng.random((B, k)).astype(np.float32)
    if dead:
        # a dead shard's sampled coreset is the reference's fill: NaN
        # rows, label −128, and mixture weight 0
        x[0, 1] = np.nan
        y[0, 1] = -128
        mix[0, 1] = 0.0
    mix = (mix / mix.sum(-1, keepdims=True)).astype(np.float32)
    pw = (mix * np.float32(1.0 / np.float32(c))).astype(np.float32)
    return x, y, pw


def _assert_tree_equal(jp, jl, p, loss):
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", TREES, ids=str)
def test_tree_erm_equals_jax(shape, mode):
    F, depth, Q, c = shape
    x, y, pw = _coresets(sum(shape), F, Q, c)
    jt = JTrees(num_features=F, depth=depth, bins=Q, comm_mode=mode)
    pt = HistogramTrees(num_features=F, depth=depth, bins=Q,
                        comm_mode=mode)
    B, k = y.shape[:2]
    if mode == "coreset":
        w = np.ascontiguousarray(np.broadcast_to(
            pw[..., None], (B, k, c)).reshape(B, k * c))
        xs, ys = x.reshape(B, k * c, F), y.reshape(B, k * c)
        jp, jl = jax.jit(jax.vmap(jt.erm))(xs, ys, w)
        p, loss = pt.erm(torch.from_numpy(xs), torch.from_numpy(ys),
                         torch.from_numpy(w))
    else:
        jp, jl = jax.jit(jax.vmap(jt.erm_players))(x, y, pw)
        p, loss = pt.erm_players(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(pw))
    _assert_tree_equal(jp, jl, p, loss)
    pts = np.nan_to_num(x.reshape(B, -1, F), nan=0.25)
    np.testing.assert_array_equal(
        pt.predict(p, torch.from_numpy(pts)).numpy(),
        np.asarray(jax.vmap(jt.predict)(jp, pts)))
    # one hypothesis on a batch of points, as the classifier calls it
    np.testing.assert_array_equal(
        pt.predict(p[0], torch.from_numpy(pts[0])).numpy(),
        np.asarray(jt.predict(jp[0], pts[0])))


def test_tree_class_surface_equals_jax():
    for F, depth, Q, _ in TREES:
        for mode in MODES:
            jt = JTrees(num_features=F, depth=depth, bins=Q,
                        comm_mode=mode, vote_topk=3)
            pt = weak.make_class("tree", num_features=F, tree_depth=depth,
                                 tree_bins=Q, tree_comm_mode=mode,
                                 tree_vote_topk=3)
            for attr in ("nodes", "leaves", "param_dim", "elected",
                         "bin_bits", "feat_bits", "value_bits", "vc_dim"):
                assert getattr(pt, attr) == getattr(jt, attr), attr
            assert pt.hypothesis_bits() == jt.hypothesis_bits()
            assert weak.param_dim(pt) == j_weak.param_dim(jt)
            x = jt.sample_points(np.random.default_rng(F), 64)
            np.testing.assert_array_equal(
                pt.sample_points(np.random.default_rng(F), 64), x)
            np.testing.assert_array_equal(
                pt.sample_target(np.random.default_rng(Q), x),
                jt.sample_target(np.random.default_rng(Q), x))
            np.testing.assert_array_equal(
                pt.pack_params([0] * pt.nodes, [1] * pt.nodes,
                               [1] * pt.leaves),
                jt.pack_params([0] * jt.nodes, [1] * jt.nodes,
                               [1] * jt.leaves))
    for bad in (dict(depth=0), dict(bins=6), dict(comm_mode="x"),
                dict(vote_topk=0)):
        with pytest.raises(ValueError):
            HistogramTrees(num_features=4, **bad)
    # chunk_size (the streaming tier) accumulates over tiles; 0 tiles
    # are refused
    assert HistogramTrees(num_features=4, chunk_size=64).chunk_size == 64
    with pytest.raises(ValueError):
        HistogramTrees(num_features=4, chunk_size=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_axis_stumps_equal_jax(seed):
    rng = np.random.default_rng(seed)
    B, K, F = 4, 128, 4
    xs = (rng.standard_normal((B, K, F)) * 100).astype(np.float32)
    xs[1, :64] = xs[1, 64:]                          # duplicate points
    xs[2, :, 1] = 3.0                                # a constant column
    ys = np.where(rng.random((B, K)) < 0.5, 1, -1).astype(np.int8)
    w = (rng.dirichlet(np.ones(K), B)).astype(np.float32)
    w[3] = np.float32(1.0 / K)
    jcls, cls = j_weak.AxisStumps(num_features=F), weak.AxisStumps(
        num_features=F)
    jp, jl = jax.jit(jax.vmap(jcls.erm))(xs, ys, w)
    p, loss = cls.erm(torch.from_numpy(xs), torch.from_numpy(ys),
                      torch.from_numpy(w))
    _assert_tree_equal(jp, jl, p, loss)
    np.testing.assert_array_equal(
        cls.predict(p, torch.from_numpy(xs)).numpy(),
        np.stack([np.asarray(jcls.predict(jp[b], xs[b])) for b in range(B)]))
    assert cls.vc_dim == jcls.vc_dim
    assert cls.hypothesis_bits() == jcls.hypothesis_bits()
    np.testing.assert_array_equal(
        cls.sample_points(np.random.default_rng(seed), 32),
        jcls.sample_points(np.random.default_rng(seed), 32))


@pytest.mark.parametrize("mode", MODES)
def test_tree_ledger_equals_jax(mode):
    cfg, jcfg = BoostConfig(k=4, coreset_size=100), JConfig(
        k=4, coreset_size=100)
    cls = HistogramTrees(num_features=8, comm_mode=mode)
    jcls = JTrees(num_features=8, comm_mode=mode)
    for fn in ("tree_comm_mode", "hist_scalars_per_player",
               "vote_entries_per_player"):
        assert getattr(ledger, fn)(cls) == getattr(j_ledger, fn)(jcls)
    assert ledger.vote_entry_bits(cls, 4096, 72) == \
        j_ledger.vote_entry_bits(jcls, 4096, 72)
    assert ledger.domain_size(cls) == j_ledger.domain_size(jcls) == 2 ** 40
    for m, rounds, stuck in ((256, 3, True), (65536, 96, False),
                             (1000, 0, True)):
        got = ledger.boost_attempt_ledger(cfg, cls, m, rounds, stuck)
        want = j_ledger.boost_attempt_ledger(jcfg, jcls, m, rounds, stuck)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        got = ledger.boost_attempt_ledger_masked(cfg, cls, m, rounds, stuck,
                                                 7, 5, 3)
        want = j_ledger.boost_attempt_ledger_masked(jcfg, jcls, m, rounds,
                                                    stuck, 7, 5, 3)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert ledger.theorem_41_bound(cfg, cls, m, 8) == \
            j_ledger.theorem_41_bound(jcfg, jcls, m, 8)
    assert isinstance(got, Ledger)
