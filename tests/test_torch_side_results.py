"""The paper's side results in the port against the JAX package.

* ``finite.learn_finite`` (Section 6): errors, OPT, bits and the chosen
  hypothesis equal, on ``tests/test_finite.py``'s cases and on
  ``benchmarks/finite_class.py``'s grid (n = 2^12, |H| = 512, m = 4096);
* ``lower_bound`` (Theorem 2.3): ``disj_to_sample`` arrays, the random
  instances and the whole ``DisjOutcome`` equal, on
  ``tests/test_lower_bound.py``'s cases and at r ∈ {8, 64};
* ``prng.categorical`` bit for bit against ``jax.random.categorical``,
  with ties and −inf logits;
* ``weak.erm_batch``, ``weights.probs``, ``classify.distinct_count``,
  ``streaming.DEFAULT_CHUNK`` and ``configs.boosting`` against the
  reference's names.

Every comparison is exact: no tolerance is used.  The semi-agnostic
reduction is tests/test_torch_semi_agnostic.py's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import boosting as j_boosting
from repro.core import classify as j_classify
from repro.core import finite as j_finite
from repro.core import lower_bound as j_lb
from repro.core import streaming as j_streaming
from repro.core import weak as j_weak
from repro.core import weights as j_weights
from repro.core.types import BoostConfig as JConfig
from repro_torch.configs import boosting
from repro_torch.core import (classify, finite, lower_bound, prng,
                              streaming, weak, weights)
from repro_torch.core.types import BoostConfig

torch.set_num_threads(1)

N = 1 << 12


def _cfgs(**kw):
    return JConfig(**kw), BoostConfig(**kw)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


# --------------------------------------------------------------- small names

def test_production_boost_and_default_chunk_equal_reference():
    assert dataclasses.asdict(boosting.PRODUCTION_BOOST) == {
        **dataclasses.asdict(j_boosting.PRODUCTION_BOOST), "chunk_size": None}
    assert streaming.DEFAULT_CHUNK == j_streaming.DEFAULT_CHUNK


@pytest.mark.parametrize("seed", [0, 3])
def test_probs_equal_reference(seed):
    rng = np.random.default_rng(seed)
    hits = rng.integers(0, 40, (3, 5, 300)).astype(np.int32)
    alive = rng.random((3, 5, 300)) > 0.3
    alive[0, 1] = False                     # an all-dead row: NaN, as jax
    want = np.asarray(j_weights.probs(jnp.asarray(hits), jnp.asarray(alive)))
    got = weights.probs(torch.from_numpy(hits), torch.from_numpy(alive))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_distinct_count_equals_reference():
    rng = np.random.default_rng(1)
    for pts in (np.array([3, 1, 3, 7, 1], np.int32),
                rng.integers(0, 50, 200).astype(np.int32),
                np.array([[0.5, 1.0], [0.5, 1.0], [np.nan, 2.0],
                          [np.nan, 2.0], [0.0, -0.0], [-0.0, 0.0]],
                         np.float32),
                rng.integers(0, 3, (64, 3)).astype(np.float32)):
        want = int(j_classify.distinct_count(jnp.asarray(pts)))
        assert int(classify.distinct_count(torch.from_numpy(pts))) == want


@pytest.mark.parametrize("name", ["thresholds", "intervals", "singletons"])
def test_erm_batch_equals_reference_and_is_pad_safe(name):
    """tests/test_weak.py's erm_batch case, on the port."""
    n = 1 << 10
    jc, pc = j_weak.make_class(name, n=n), weak.make_class(name, n=n)
    rng = np.random.default_rng(7)
    B, c = 5, 64
    xs = rng.integers(0, n, (B, c)).astype(np.int32)
    ys = rng.choice([-1, 1], (B, c)).astype(np.int8)
    w = rng.random((B, c)).astype(np.float32)
    jp, jl = j_weak.erm_batch(jc, jnp.asarray(xs), jnp.asarray(ys),
                              jnp.asarray(w))
    pp, pl = weak.erm_batch(pc, torch.from_numpy(xs), torch.from_numpy(ys),
                            torch.from_numpy(w))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_bits(pl), _bits(jl))
    pad = (np.concatenate([xs, np.zeros((B, 16), np.int32)], -1),
           np.concatenate([ys, np.ones((B, 16), np.int8)], -1),
           np.concatenate([w, np.zeros((B, 16), np.float32)], -1))
    _, jlp = j_weak.erm_batch(jc, *map(jnp.asarray, pad))
    _, plp = weak.erm_batch(pc, *map(torch.from_numpy, pad))
    np.testing.assert_array_equal(_bits(plp), _bits(jlp))
    zero = (np.zeros((2, c), np.int32), np.ones((2, c), np.int8),
            np.zeros((2, c), np.float32))
    jp0, _ = j_weak.erm_batch(jc, *map(jnp.asarray, zero))
    pp0, pl0 = weak.erm_batch(pc, *map(torch.from_numpy, zero))
    assert (pl0 == 0).all() and torch.isfinite(pp0).all()
    np.testing.assert_array_equal(pp0.numpy(), np.asarray(jp0))


def test_erm_batch_stumps_rows_equal_reference():
    jc = j_weak.make_class("stumps", num_features=3)
    pc = weak.make_class("stumps", num_features=3)
    rng = np.random.default_rng(2)
    xs = rng.random((3, 48, 3)).astype(np.float32)
    ys = rng.choice([-1, 1], (3, 48)).astype(np.int8)
    w = rng.random((3, 48)).astype(np.float32)
    jp, jl = j_weak.erm_batch(jc, *map(jnp.asarray, (xs, ys, w)))
    pp, pl = weak.erm_batch(pc, *map(torch.from_numpy, (xs, ys, w)))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_bits(pl), _bits(jl))


# ----------------------------------------------------------------- finite

def _finite_cases():
    """tests/test_finite.py's and benchmarks/finite_class.py's inputs."""
    n = 256
    grid = np.asarray([[2.0, t, t, s] for t in range(0, n, 8)
                       for s in (1.0, -1.0)], np.float32)
    rng = np.random.default_rng(0)
    for noise in (0, 50, 400):
        x = rng.integers(0, n, 2048).astype(np.int32)
        y = np.where(x >= 96, 1, -1).astype(np.int8)
        flip = rng.choice(2048, size=noise, replace=False)
        y[flip] = -y[flip]
        yield f"test-{noise}", n, grid, x, y
    rng = np.random.default_rng(1)
    x = rng.integers(0, n, 1024).astype(np.int32)
    y = np.where(x >= 100, 1, -1).astype(np.int8)
    for step in (32, 2):
        yield (f"bits-{step}", n,
               np.asarray([[2.0, t, t, 1.0] for t in range(0, n, step)],
                          np.float32), x, y)
    grid = np.asarray([[2.0, t, t, s] for t in range(0, N, 16)
                       for s in (1.0, -1.0)], np.float32)
    rng = np.random.default_rng(7)
    for noise in (0, 16, 256):
        x = rng.integers(0, N, 4096).astype(np.int32)
        y = np.where(x >= N // 3, 1, -1).astype(np.int8)
        flip = rng.choice(4096, size=noise, replace=False)
        y[flip] = -y[flip]
        yield f"bench-{noise}", N, grid, x, y


def test_learn_finite_equals_reference():
    names = []
    for name, n, grid, x, y in _finite_cases():
        xk, yk = x.reshape(4, -1), y.reshape(4, -1)
        want = j_finite.learn_finite(jnp.asarray(xk), jnp.asarray(yk),
                                     jnp.asarray(grid), j_weak.Thresholds(n=n))
        got = finite.learn_finite(xk, yk, grid, weak.Thresholds(n=n),
                                  device="cpu")
        assert (got.errors, got.opt, got.total_bits) == (
            want.errors, want.opt, want.total_bits), name
        np.testing.assert_array_equal(got.best_params.numpy(),
                                      np.asarray(want.best_params))
        names.append(name)
    assert len(names) == 8 and grid.shape[0] == 512


# ------------------------------------------------------------ lower bound

def test_disj_to_sample_and_instances_equal_reference():
    xbits = np.array([1, 0, 1, 0, 0], np.int8)
    ybits = np.array([0, 0, 1, 1, 0], np.int8)
    jx, jy = j_lb.disj_to_sample(xbits, ybits, N)
    x, y = lower_bound.disj_to_sample(xbits, ybits, N, "cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert (x.dtype, y.dtype) == (torch.int32, torch.int8)
    for disjoint in (True, False):
        a = j_lb.random_disj_instance(np.random.default_rng(5), 40, 9,
                                      disjoint)
        b = lower_bound.random_disj_instance(np.random.default_rng(5), 40,
                                             9, disjoint)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("r,weight,seed,budget", [
    (8, 3, 0, 24), (16, 5, 1, 24), (32, 12, 2, 24),   # test_lower_bound
    (8, 4, 8, 32), (64, 32, 64, 200)])                # paper_claims sizes
def test_solve_disjointness_equals_reference(r, weight, seed, budget):
    jcfg, cfg = _cfgs(k=2, coreset_size=400, domain_size=N,
                      opt_budget=budget)
    for disjoint in (True, False):
        xbits, ybits = j_lb.random_disj_instance(
            np.random.default_rng(seed), r=r, weight=weight,
            disjoint=disjoint)
        want = j_lb.solve_disjointness(xbits, ybits, N, jcfg, seed=seed)
        got = lower_bound.solve_disjointness(xbits, ybits, N, cfg,
                                             seed=seed, device="cpu")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.disjoint_decided == disjoint


# --------------------------------------------------------------- categorical

@pytest.mark.parametrize("seed", [0, 9])
def test_categorical_equals_jax_bitwise(seed):
    rng = np.random.default_rng(seed)
    cases = [(rng.standard_normal(7).astype(np.float32), (5,)),
             (rng.standard_normal(300).astype(np.float32), (64,)),
             (rng.standard_normal((3, 11)).astype(np.float32), (4, 3)),
             (rng.standard_normal((2, 6)).astype(np.float32), None),
             # ties: equal logits everywhere, and two tied maxima
             (np.zeros(9, np.float32), (200,)),
             (np.array([0.0, 5.0, 5.0, -1.0], np.float32), (50,)),
             # −inf logits (dead categories), one row all −inf
             (np.array([-np.inf, 0.3, -np.inf, 0.1], np.float32), (40,)),
             (np.full((2, 5), -np.inf, np.float32), (3, 2))]
    for logits, shape in cases:
        want = jax.random.categorical(jax.random.key(seed),
                                      jnp.asarray(logits), shape=shape)
        got = prng.categorical(prng.key(seed), torch.from_numpy(logits),
                               shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_categorical_batched_keys_equal_vmapped_jax():
    rng = np.random.default_rng(4)
    logits = np.log(rng.random((4, 130)).astype(np.float32))
    jkeys = jax.random.split(jax.random.key(2), 4)
    want = jax.vmap(lambda k, lg: jax.random.categorical(
        k, lg, shape=(33,)))(jkeys, jnp.asarray(logits))
    got = prng.categorical(prng.split(prng.key(2), 4),
                           torch.from_numpy(logits), (33,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
