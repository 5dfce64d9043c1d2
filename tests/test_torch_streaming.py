"""The port's streaming tier ≡ the JAX package's (tests/test_streaming.py
case for case), on the CPU.

* Exact path: ``streaming.sort_order`` equals ``jnp.argsort`` and the
  reference's chunked order bit for bit (int32 points, float32 columns
  with ±0.0 and NaN, heavy ties, the engines' leading axes), and
  ``BoostConfig.chunk_size`` changes no protocol output of the three
  engines, which equal the JAX engines run with the same config.
* Chunked histograms: bitwise against the reference's
  ``node_histograms_chunked_ref`` and ``ops.node_histograms(...,
  chunk_size=…)`` on dyadic weights (ragged tiles, the batched form,
  tile ≥ c) and on any weights at tiles below 400 points (where
  ``ref.xla_cpu_block`` is established); beyond that at rtol 1e-5 /
  atol 1e-6 (ROADMAP queue 3: the order rule is not known there).
* Sketch: indices and the ``err``/``gran`` fields bit for bit against
  the reference's ``build_sketch``/``sketch_coreset``; the measured
  approximation error within the self-accounted bound.
* Feed: ``iter_chunks``/``prefetch_to_device`` keep order and values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as j_batched
from repro.core import classify as j_classify
from repro.core import sharded_batched as j_sharded
from repro.core import streaming as j_streaming
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro.data import chunks as j_chunks
from repro.kernels.histogram import ops as j_hist
from repro.weak_tree.trees import HistogramTrees as JTrees
from repro_torch.core import (approximation, batched, classify, prng,
                              sharded_batched, streaming, tasks, weak)
from repro_torch.core.types import EPS_APPROX, BoostConfig
from repro_torch.data import chunks
from repro_torch.kernels.histogram import kernel as hist_kernel
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.weak_tree.trees import HistogramTrees

from test_torch_batched import assert_task_parity

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)


# the reference's chunked order, jitted: eager, its run merges compile
# op by op for every new shape
_j_sort_order = jax.jit(j_streaming.sort_order, static_argnums=(1, 2))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# sort_order ≡ stable argsort ≡ the reference's chunked order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,chunk", [
    (1024, 128), (1000, 128), (7, 3), (513, 512), (64, 64), (64, 4096),
])
def test_sort_order_equals_jax(m, chunk):
    rng = np.random.default_rng(m * 1000 + chunk)
    n = 1 << 12
    x_int = rng.integers(0, n, m).astype(np.int32)
    got = streaming.sort_order(torch.from_numpy(x_int), chunk, n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(_j_sort_order(jnp.asarray(x_int),
                                                 chunk, n)))
    np.testing.assert_array_equal(got.numpy(), np.argsort(x_int,
                                                          kind="stable"))
    x_f = rng.normal(size=m).astype(np.float32)
    got_f = streaming.sort_order(torch.from_numpy(x_f), chunk)
    np.testing.assert_array_equal(
        got_f.numpy(), np.asarray(_j_sort_order(jnp.asarray(x_f), chunk)))


def test_sort_order_stable_under_heavy_ties():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 4, 4096).astype(np.int32)        # ~1k ties a key
    got = streaming.sort_order(torch.from_numpy(x), 100, 4)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(_j_sort_order(jnp.asarray(x), 100, 4)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argsort(x)))


@pytest.mark.parametrize("chunk", [16, 64, 100])
def test_sort_order_signed_zeros_and_nan(chunk):
    """-0.0 ties with +0.0 and every NaN sorts last, each in index
    order, as jnp.argsort and the reference's searchsorted merge have
    it."""
    rng = np.random.default_rng(chunk)
    x = rng.normal(size=500).astype(np.float32)
    x[rng.random(500) < 0.2] = 0.0
    x[rng.random(500) < 0.2] = -0.0
    x[rng.random(500) < 0.1] = np.nan
    x[rng.random(500) < 0.05] = -np.nan
    x[rng.random(500) < 0.05] = -np.inf
    got = streaming.sort_order(torch.from_numpy(x), chunk)
    ref = np.asarray(_j_sort_order(jnp.asarray(x), chunk))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argsort(x)))


def test_sort_order_none_is_monolithic():
    x = torch.tensor([3, 1, 2], dtype=torch.int32)
    np.testing.assert_array_equal(streaming.sort_order(x, None).numpy(),
                                  [1, 2, 0])
    with pytest.raises(ValueError):
        streaming.sort_order(x, 0)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_sort_order_over_leading_axes_equals_vmapped_jax(dtype):
    """The engines sort [B, k, mloc] at once; the reference vmaps."""
    rng = np.random.default_rng(3)
    if dtype == "int32":
        x, n = rng.integers(0, 16, (2, 3, 300)).astype(np.int32), 16
    else:
        x, n = rng.normal(size=(2, 3, 300)).astype(np.float32), None
    got = streaming.sort_order(torch.from_numpy(x), 37, n)
    ref = jax.jit(jax.vmap(jax.vmap(
        lambda v: j_streaming.sort_order(v, 37, n))))(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_merge_sorted_equals_jax_ties_a_first():
    rng = np.random.default_rng(4)
    xa = np.sort(rng.integers(0, 8, 50)).astype(np.int32)
    xb = np.sort(rng.integers(0, 8, 33)).astype(np.int32)
    ia, ib = np.arange(50, dtype=np.int32), np.arange(33, dtype=np.int32) + 50
    x, i = streaming.merge_sorted(*(torch.from_numpy(v)
                                    for v in (xa, ia, xb, ib)))
    jx, ji = j_streaming.merge_sorted(*(jnp.asarray(v)
                                        for v in (xa, ia, xb, ib)))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


# ---------------------------------------------------------------------------
# chunked histograms
# ---------------------------------------------------------------------------

def _hist_case(c, tile, batched_form, dyadic, F=5, Q=16, nodes=3):
    rng = np.random.default_rng(c * 7 + tile)
    x = ((rng.integers(0, Q, (c, F)) + 0.5) / Q).astype(np.float32)
    w = (rng.integers(0, 256, (nodes, c)) / 256.0 if dyadic
         else rng.random((nodes, c))).astype(np.float32)
    wy = (w * rng.choice([-1.0, 1.0], (nodes, c))).astype(np.float32)
    if batched_form:
        x, w, wy = x[None], w[None], wy[None]
    return x, w, wy


def _jax_chunked(x, w, wy, Q, tile):
    """The reference's two chunked forms: its plain version, and its
    dispatching op inside the engine's jit (vmapped for a task axis)."""
    args = tuple(jnp.asarray(v) for v in (x, w, wy))
    ref = j_hist.node_histograms_chunked_ref(*args, Q, tile)
    op = (lambda a, b, c: j_hist.node_histograms(a, b, c, Q,
                                                 chunk_size=tile))
    if x.ndim == 3:
        op = jax.vmap(op)
    return ref, jax.jit(op)(*args)


@pytest.mark.parametrize("c,tile,batched_form", [
    (257, 64, False), (130, 200, False), (512, 128, False),
    (257, 64, True), (1, 1, True),
])
def test_chunked_histograms_equal_jax_on_dyadic_weights(c, tile,
                                                        batched_form):
    x, w, wy = _hist_case(c, tile, batched_form, dyadic=True)
    got = hist_ops.node_histograms(*(torch.from_numpy(v) for v in (x, w, wy)),
                                   16, chunk_size=tile)
    mono = hist_ops.node_histograms(*(torch.from_numpy(v)
                                      for v in (x, w, wy)), 16)
    for ref in _jax_chunked(x, w, wy, 16, tile):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got, mono):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("c,tile,batched_form", [
    (257, 64, False), (512, 128, True), (1000, 300, False),
    (400, 128, True), (777, 399, True),
])
def test_chunked_histograms_equal_jax_bitwise_below_400(c, tile,
                                                        batched_form):
    """Any weights: a tile below 400 points sums left to right in the
    reference (``xla_cpu_block``), and so does the port."""
    x, w, wy = _hist_case(c, tile, batched_form, dyadic=False)
    got = hist_ops.node_histograms(*(torch.from_numpy(v) for v in (x, w, wy)),
                                   16, chunk_size=tile)
    for ref in _jax_chunked(x, w, wy, 16, tile):
        for a, b in zip(got, ref):
            _bits_equal(a.numpy(), np.asarray(b) + 0.0)


@pytest.mark.parametrize("c,tile", [(1600, 800), (2500, 1000)])
def test_chunked_histograms_near_jax_past_400(c, tile):
    """Tiles of 400 points and more: the order rule is not established
    there (ROADMAP queue 3), so the port is held at rtol 1e-5 / atol
    1e-6 on arbitrary weights."""
    x, w, wy = _hist_case(c, tile, True, dyadic=False)
    got = hist_ops.node_histograms(*(torch.from_numpy(v) for v in (x, w, wy)),
                                   16, chunk_size=tile)
    for ref in _jax_chunked(x, w, wy, 16, tile):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_chunked_histogram_folds_from_positive_zero():
    """A tile whose sum is −0.0 (all-negative-zero weights) and the
    padded rows fold into +0.0, as the reference's scan from +0."""
    c, tile, F, Q = 100, 32, 3, 8
    x = np.random.default_rng(0).random((c, F)).astype(np.float32)
    w = np.full((2, c), -0.0, np.float32)
    w[1, 40:45] = -0.25
    wy = -w
    got = hist_ops.node_histograms(*(torch.from_numpy(v) for v in (x, w, wy)),
                                   Q, chunk_size=tile)
    ref = j_hist.node_histograms_chunked_ref(
        *(jnp.asarray(v) for v in (x, w, wy)), Q, tile)
    for a, b in zip(got, ref):
        _bits_equal(a.numpy(), np.asarray(b))
    assert not torch.signbit(got[0][0]).any()


def test_chunked_best_splits_equal_jax():
    rng = np.random.default_rng(0)
    c, F, Q, nodes = 321, 4, 8, 2
    x = ((rng.integers(0, Q, (c, F)) + 0.5) / Q).astype(np.float32)
    w = (rng.integers(0, 256, (nodes, c)) / 256.0).astype(np.float32)
    wy = (w * rng.choice([-1.0, 1.0], (nodes, c))).astype(np.float32)
    got = hist_ops.best_node_splits(*(torch.from_numpy(v)
                                      for v in (x, w, wy)), Q,
                                    chunk_size=100)
    ref = j_hist.best_node_splits(*(jnp.asarray(v) for v in (x, w, wy)), Q,
                                  chunk_size=100)
    mono = hist_ops.best_node_splits(*(torch.from_numpy(v)
                                       for v in (x, w, wy)), Q)
    for a, b, m in zip(got, ref, mono):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), m.numpy())


def test_chunk_plan_fits_the_tier_tiles_and_refuses_the_rest():
    """The chunked route's shared memory at the tier's tile (16384
    points, 32 bins) is far below a block's 232,448 bytes; a tile past
    the uint16 indices is refused with a reason."""
    p = hist_kernel.chunk_plan(1, 10 ** 6, 1 << 14, 32)
    assert p.route == "chunked" and p.smem_bytes == 4 * (8 * 32 + 33) \
        + 4 * (1 << 14)
    with pytest.raises(ValueError, match="tiles of at most"):
        hist_kernel.chunk_plan(1, 10 ** 6, 1 << 16, 32)
    with pytest.raises(ValueError):
        hist_ops.node_histograms(torch.zeros(4, 2), torch.zeros(1, 4),
                                 torch.zeros(1, 4), 8, chunk_size=0)


# ---------------------------------------------------------------------------
# HistogramTrees(chunk_size=…)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["coreset", "histogram", "voting"])
def test_trees_chunked_equal_jax(mode):
    """erm (pooled: 400 points, every level in tiles of 128) and
    erm_players (per player: 100 points in tiles of 64, the last ragged)
    against the reference's classes with the same chunk_size, and equal
    to the port's monolithic trees (dyadic weights)."""
    B, k, c, F, Q = 2, 4, 100, 8, 32
    rng = np.random.default_rng(11)
    cx = ((rng.integers(0, Q, (B, k, c, F)) + 0.5) / Q).astype(np.float32)
    cy = rng.choice([-1, 1], (B, k, c)).astype(np.int8)
    pw = (rng.integers(1, 64, (B, k)) / 64.0).astype(np.float32)
    kw = dict(num_features=F, depth=2, bins=Q, comm_mode=mode,
              chunk_size=128 if mode == "coreset" else 64)
    jt, pt = JTrees(**kw), HistogramTrees(**kw)
    mono = HistogramTrees(**dict(kw, chunk_size=None))
    if mode == "coreset":
        w = (rng.integers(0, 256, (B, k * c)) / 256.0).astype(np.float32)
        args = (cx.reshape(B, k * c, F), cy.reshape(B, k * c), w)
        ref = jax.vmap(jt.erm)(*(jnp.asarray(v) for v in args))
        got = pt.erm(*(torch.from_numpy(v) for v in args))
        same = mono.erm(*(torch.from_numpy(v) for v in args))
    else:
        args = (cx, cy, pw)
        ref = jax.vmap(jt.erm_players)(*(jnp.asarray(v) for v in args))
        got = pt.erm_players(*(torch.from_numpy(v) for v in args))
        same = mono.erm_players(*(torch.from_numpy(v) for v in args))
    for a, b, m in zip(got, ref, same):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), m.numpy())


def test_tree_class_chunk_parity():
    """tests/test_streaming.py's case: c = 300 normal features, 16 bins,
    tiles of 128, dyadic weights, one task."""
    rng = np.random.default_rng(3)
    c, F = 300, 4
    x = rng.normal(size=(c, F)).astype(np.float32)
    y = rng.choice([-1, 1], c).astype(np.int8)
    w = (rng.integers(0, 256, c) / 256.0).astype(np.float32)
    jp, jl = JTrees(num_features=F, depth=2, bins=16,
                    chunk_size=128).erm(jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(w))
    p, l = HistogramTrees(num_features=F, depth=2, bins=16,
                          chunk_size=128).erm(
        *(torch.from_numpy(v)[None] for v in (x, y, w)))
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(l[0].numpy(), np.asarray(jl))


# ---------------------------------------------------------------------------
# chunk_size through the three engines
# ---------------------------------------------------------------------------

N = 1 << 12


def _engine_cfg(chunk, k=4):
    return dict(k=k, coreset_size=64, domain_size=N, opt_budget=32,
                chunk_size=chunk)


def test_host_engine_chunk_parity():
    cls, jcls = weak.Thresholds(n=N), j_weak.Thresholds(n=N)
    task = j_tasks.make_task(jcls, m=1024, k=4, noise=3, seed=2)
    ref = j_classify.run_accurately_classify(
        jnp.asarray(task.x), jnp.asarray(task.y), jax.random.key(0),
        JConfig(**_engine_cfg(100)), jcls)
    kw = dict(device="cpu")
    _, got = classify.learn(task.x, task.y, prng.key(0),
                            BoostConfig(**_engine_cfg(100)), cls, **kw)
    _, mono = classify.learn(task.x, task.y, prng.key(0),
                             BoostConfig(**_engine_cfg(None)), cls, **kw)
    assert_task_parity(ref, got)
    assert_task_parity(mono, got)


def _batched_inputs():
    x, y, _ = j_tasks.make_batch(j_weak.Thresholds(n=N), 2, 512, 4, 3,
                                 seed0=11)
    return x, y


ENGINE_FIELDS = ("hypotheses", "rounds", "ok", "attempts", "disputed",
                 "alive", "hist_stuck", "hist_rounds", "hist_alive",
                 "hist_p", "hist_players", "hist_players_h",
                 "hist_players_last")


def _assert_engine_fields(ref, got, same_package=False):
    """Every protocol field and ledger equal; ``min_loss``, a float
    diagnostic, within rtol 1e-5 + atol 1e-6 against the JAX engine (on
    this grid the port's monolithic run already ends at −1.8e-7 where
    the reference's ends at 0: ROADMAP queue 3, near-zero ERM losses)
    and bit for bit between the port's own runs."""
    for f in ENGINE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      np.asarray(getattr(got, f)), f)
    if same_package:
        _bits_equal(got.min_loss, ref.min_loss)
    else:
        np.testing.assert_allclose(got.min_loss, np.asarray(ref.min_loss),
                                   rtol=1e-5, atol=1e-6)
    for b in range(got.batch):
        assert dataclasses.asdict(ref.ledger(b)) == \
            dataclasses.asdict(got.ledger(b))


def test_batched_engine_chunk_parity():
    x, y = _batched_inputs()
    cls, jcls = weak.Thresholds(n=N), j_weak.Thresholds(n=N)
    ref = j_batched.run_accurately_classify_batched(
        x, y, jax.random.split(jax.random.key(5), 2),
        JConfig(**_engine_cfg(100)), jcls)
    runs = [batched.run_accurately_classify_batched(
        x, y, prng.split(prng.key(5), 2), BoostConfig(**_engine_cfg(ch)),
        cls, device="cpu") for ch in (100, None)]
    _assert_engine_fields(ref, runs[0])
    _assert_engine_fields(runs[1], runs[0], same_package=True)


def test_sharded_engine_chunk_parity():
    x, y = _batched_inputs()
    cls, jcls = weak.Thresholds(n=N), j_weak.Thresholds(n=N)
    ref = j_sharded.run_accurately_classify_sharded(
        x, y, jax.random.split(jax.random.key(5), 2),
        JConfig(**_engine_cfg(100)), jcls)
    with sharded_batched.make_players_group(4, "cpu") as g:
        runs = [sharded_batched.run_accurately_classify_sharded(
            x, y, prng.split(prng.key(5), 2),
            BoostConfig(**_engine_cfg(ch)), cls, group=g)
            for ch in (100, None)]
    _assert_engine_fields(ref, runs[0])
    _assert_engine_fields(runs[1], runs[0], same_package=True)
    for b in range(2):
        assert runs[0].wire_summary(b) == runs[1].wire_summary(b)


# ---------------------------------------------------------------------------
# the quantile sketch
# ---------------------------------------------------------------------------

def _random_stream(m, seed, n=1 << 14, hmax=13, p_pos=0.5, dead_frac=0.0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, n, m).astype(np.int32)
    y = np.where(rng.random(m) < p_pos, 1, -1).astype(np.int8)
    hits = rng.integers(0, hmax + 1, m).astype(np.int32)
    alive = rng.random(m) >= dead_frac
    w = streaming.sketch_weights(torch.from_numpy(hits),
                                 torch.from_numpy(alive)).numpy()
    _bits_equal(w, np.asarray(j_streaming.sketch_weights(
        jnp.asarray(hits), jnp.asarray(alive))))
    return x, y, hits, alive, w


_j_from_chunk = jax.jit(j_streaming.sketch_from_chunk, static_argnums=4)
_j_compress = jax.jit(j_streaming.compress_sketch, static_argnums=1)
_j_merge = jax.jit(j_streaming.merge_sketches)


def _jax_sketch(x, y, w, chunk, cap):
    """``j_streaming.build_sketch`` with each of the reference's steps
    jitted, in its level order: its eager steps compile op by op for
    every new shape, which dominates the file's run time.
    :func:`test_jitted_reference_equals_build_sketch` holds this to
    ``build_sketch`` itself."""
    levels = []
    for xc, yc, wc, start in j_chunks.iter_shard_chunks(x, y, w, chunk):
        s = _j_compress(_j_from_chunk(xc, yc, wc, start, None), cap)
        i = 0
        while i < len(levels) and levels[i] is not None:
            s = j_streaming._merge_compress(levels[i], s, cap)
            levels[i] = None
            i += 1
        if i == len(levels):
            levels.append(s)
        else:
            levels[i] = s
    acc = None
    for s in reversed(levels):
        if s is not None:
            acc = s if acc is None else _j_merge(acc, s)
    return _j_compress(acc, cap)


def _assert_sketch_equal(got, ref):
    for f in streaming.QuantileSketch._fields:
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        _bits_equal(a, b.astype(a.dtype) if f in ("ip", "i_n") else b)


def test_jitted_reference_equals_build_sketch():
    x, y, _, _, w = _random_stream(192, seed=2)        # 3 tiles, merged
    ref = j_streaming.build_sketch(j_chunks.iter_shard_chunks(x, y, w, 64),
                                   cap=96)
    _assert_sketch_equal(_jax_sketch(x, y, w, 64, 96), ref)


def _both_sketches(x, y, w, chunk, cap):
    ref = _jax_sketch(x, y, w, chunk, cap)
    got = streaming.build_sketch(
        chunks.iter_shard_chunks(x, y, w, chunk, device="cpu"), cap=cap)
    _assert_sketch_equal(got, ref)
    return ref, got


def _measured_error(idx, x, y, hits, alive, n=1 << 14):
    """sup over a dense threshold grid, both polarities (the class the
    integer track boosts over), by the port's approximation_error."""
    theta = np.arange(0, n + 1, max(1, n // 256), dtype=np.int32)
    grid = torch.from_numpy(np.stack(
        [np.concatenate([theta, theta]),
         np.concatenate([np.ones_like(theta), -np.ones_like(theta)])],
        axis=1))

    def predict(params, pts):
        return (torch.where(pts <= params[:, 0:1], 1, -1)
                * params[:, 1:2]).to(torch.int8)

    return float(approximation.approximation_error(
        idx, *(torch.from_numpy(v) for v in (x, y, hits, alive)), predict,
        grid))


def test_sketch_uncompressed_matches_quantile_coreset():
    m, c = 999, 64
    x, y, hits, alive, w = _random_stream(m, seed=1)
    ref, sk = _both_sketches(x, y, w, 128, 1024)
    got = streaming.sketch_coreset(sk, c).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        j_streaming.sketch_coreset(ref, c)))
    mono = approximation.quantile_coreset(
        *(torch.from_numpy(v) for v in (x, y, hits, alive)), c).numpy()
    np.testing.assert_array_equal(x[got], x[mono])
    np.testing.assert_array_equal(y[got], y[mono])
    assert float(streaming.coreset_bound(sk, c)) <= 4 / c + 1e-6


@pytest.mark.parametrize("m,hmax,p_pos,dead,chunk,cap,c,seed", [
    (20_000, 13, 0.5, 0.0, 2048, 4096, 256, 20_013),
    (20_000, 13, 0.9, 0.1, 2048, 4096, 256, 20_013),
    (50_000, 40, 0.5, 0.0, 2048, 4096, 256, 50_040),   # 2^-40 weights
    (50_000, 0, 0.5, 0.3, 2048, 4096, 256, 50_000),
    (100_000, 13, 0.5, 0.0, 16_384, 16_384, 1024, 5),  # the pinned ε
])
def test_sketch_equals_jax_and_its_bound_is_honest(m, hmax, p_pos, dead,
                                                   chunk, cap, c, seed):
    x, y, hits, alive, w = _random_stream(m, seed, hmax=hmax, p_pos=p_pos,
                                          dead_frac=dead)
    ref, sk = _both_sketches(x, y, w, chunk, cap)
    idx = streaming.sketch_coreset(sk, c)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(
        j_streaming.sketch_coreset(ref, c)))
    bound = streaming.coreset_bound(sk, c)
    _bits_equal(bound.numpy(), np.asarray(j_streaming.coreset_bound(ref, c)))
    measured = _measured_error(idx, x, y, hits, alive)
    assert measured <= float(bound) + 1e-6, (measured, float(bound))
    if cap == 16_384:
        assert float(bound) <= EPS_APPROX


def test_build_sketch_empty_stream_raises():
    with pytest.raises(ValueError):
        streaming.build_sketch(iter(()), cap=64)


# ---------------------------------------------------------------------------
# the chunk feed and the task helpers
# ---------------------------------------------------------------------------

def test_iter_chunks_tiles_and_offsets():
    x, y = np.arange(10), np.arange(10) * 2
    tiles = list(chunks.iter_chunks((x, y), 4))
    assert [t[-1] for t in tiles] == [0, 4, 8]
    np.testing.assert_array_equal(np.concatenate([t[0] for t in tiles]), x)
    np.testing.assert_array_equal(np.concatenate([t[1] for t in tiles]), y)
    assert len(tiles[-1][0]) == 2
    with pytest.raises(ValueError):
        list(chunks.iter_chunks((np.arange(3), np.arange(4)), 2))
    with pytest.raises(ValueError):
        list(chunks.iter_chunks((np.arange(3),), 0))


@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_preserves_order_and_values(depth):
    x = np.arange(100)
    tiles = list(chunks.prefetch_to_device(chunks.iter_chunks((x,), 7),
                                           depth=depth, device="cpu"))
    assert all(isinstance(t[0], torch.Tensor) for t in tiles)
    np.testing.assert_array_equal(
        np.concatenate([t[0].numpy() for t in tiles]), x)
    assert [t[-1] for t in tiles] == list(range(0, 100, 7))
    with pytest.raises(ValueError):
        list(chunks.prefetch_to_device(iter(()), depth=0, device="cpu"))


def test_prefetch_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU:
    on a host without one the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(chunks.prefetch_to_device(chunks.iter_chunks((np.arange(4),),
                                                          2)))


def test_pad_shards_and_shard_chunk_feed_equal_jax():
    cls, jcls = weak.Thresholds(n=N), j_weak.Thresholds(n=N)
    task = tasks.make_task(cls, m=400, k=4, noise=3, seed=2)
    jtask = j_tasks.make_task(jcls, m=400, k=4, noise=3, seed=2)
    for got, ref in zip(tasks.pad_shards(task.x, task.y, 128),
                        j_tasks.pad_shards(jtask.x, jtask.y, 128)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(tasks.pad_shards(task.x, task.y, 100),
                        j_tasks.pad_shards(jtask.x, jtask.y, 100)):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tasks.pad_shards(task.x, task.y, 99)
    w = np.linspace(0.5, 1.0, 100).astype(np.float32)
    got = list(tasks.shard_chunk_feed(task, 2, 32, w, device="cpu"))
    ref = list(j_tasks.shard_chunk_feed(jtask, 2, 32, w))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        for a, b in zip(g[:3], r[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert g[3] == r[3]
