"""The port's threefry keys and draws against jax, bit for bit.

jax 0.9.0 runs with ``jax_threefry_partitionable = True``: split,
random_bits, uniform and gumbel (``mode="low"``) all hash the flat
index of each output.  The port must give the same words and the same
float32 bits, over seeds and shapes (0-d, odd sizes, 3-d), and the same
bits when a batch of keys is drawn in chunks.  The sampled coreset built
on them must give the reference's indices, dead shards included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approximation as j_approx
from repro_torch.core import approximation, prng, weights

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2 ** 31 - 1, 123456789]
SHAPES = [(), (1,), (5,), (3, 4), (2, 3, 5), (7, 33)]


def _words(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_equal_jax(seed):
    jk, pk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(pk.numpy(), _words(jk))
    for n in (1, 2, 3, 7):
        np.testing.assert_array_equal(prng.split(pk, n).numpy(),
                                      _words(jax.random.split(jk, n)))
    for data in (0, 17, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(pk, data).numpy(),
                                      _words(jax.random.fold_in(jk, data)))
    # a batch of keys splits row by row, as jax.vmap(split) does
    jks = jax.random.split(jk, 4)
    np.testing.assert_array_equal(
        prng.split(prng.split(pk, 4), 3).numpy(),
        _words(jax.vmap(lambda k: jax.random.split(k, 3))(jks)))
    words = np.asarray(jax.random.key_data(jks))
    np.testing.assert_array_equal(prng.wrap_key_data(words).numpy(),
                                  words.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_gumbel_equal_jax(seed, shape):
    jk, pk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(
        prng.random_bits(pk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
    u = prng.uniform(pk, shape).numpy()
    assert u.shape == shape and u.dtype == np.float32
    np.testing.assert_array_equal(
        u.view(np.int32), np.asarray(jax.random.uniform(jk, shape))
        .view(np.int32))
    lo = prng.uniform(pk, shape, minval=float(prng.TINY)).numpy()
    np.testing.assert_array_equal(
        lo, np.asarray(jax.random.uniform(jk, shape, minval=prng.TINY)))
    g = prng.gumbel(pk, shape).numpy()
    np.testing.assert_array_equal(
        g.view(np.int32), np.asarray(jax.random.gumbel(jk, shape))
        .view(np.int32))


def test_draw_in_chunks_equals_whole():
    # a batch of keys drawn in chunks of keys equals the batch drawn
    # whole (and jax.vmap of the draw)
    keys = prng.split(prng.key(9), 5)
    whole = prng.gumbel(keys, (10, 37))
    parts = [prng.gumbel(keys[a:b], (10, 37)) for a, b in ((0, 2), (2, 3),
                                                             (3, 5))]
    assert torch.equal(torch.cat(parts), whole)
    np.testing.assert_array_equal(
        whole.numpy().view(np.int32), np.asarray(jax.vmap(
            lambda k: jax.random.gumbel(k, (10, 37)))(
                jax.random.split(jax.random.key(9), 5))).view(np.int32))
    big = np.asarray(jax.random.gumbel(jax.random.key(3), (400, 2049)))
    np.testing.assert_array_equal(
        prng.gumbel(prng.key(3), (400, 2049)).numpy().view(np.int32),
        big.view(np.int32))


def _coreset_inputs(seed, m):
    rng = np.random.default_rng(seed)
    hits = rng.integers(0, 20, (3, m)).astype(np.int32)
    alive = rng.random((3, m)) < 0.8
    alive[0] = False                     # a dead shard
    return hits, alive


@pytest.mark.parametrize("m,c", [(64, 100), (50, 7), (100, 64), (17, 33)])
def test_sampled_coreset_equals_jax(m, c):
    hits, alive = _coreset_inputs(m + c, m)
    keys = jax.random.split(jax.random.key(m), 3)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda k, h, a: j_approx.sampled_coreset(k, h, a, c)))(
            keys, hits, alive))
    ht, at = torch.from_numpy(hits), torch.from_numpy(alive)
    got = approximation.sampled_coreset(
        prng.split(prng.key(m), 3), ht, at, c,
        weights.log_weight_sum(ht, at))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got[0] == m).all()           # the dead shard's index is m
    # its gather fills as jnp.take_along_axis does
    x = np.random.default_rng(0).random((3, m, 2)).astype(np.float32)
    y = np.ones((3, m), np.int8)
    jx = np.asarray(jnp.take_along_axis(x, ref[..., None], axis=1))
    jy = np.asarray(jnp.take_along_axis(y, ref, axis=1))
    np.testing.assert_array_equal(
        approximation.gather_fill(torch.from_numpy(x), got).numpy(), jx)
    np.testing.assert_array_equal(
        approximation.gather_fill(torch.from_numpy(y), got).numpy(), jy)
    assert (approximation.gather_fill(torch.from_numpy(y), got)[0]
            == -128).all()
