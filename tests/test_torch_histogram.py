"""The port's tree histogram against the JAX kernel and its oracle.

On the CPU the wrapper runs its plain version (``ref.py``), which sums
in the order the CUDA kernel sums in; tests/test_torch_kernels_cuda.py
holds the kernel itself to it on the card, bit for bit.  Against the JAX
package: on dyadic weights (the protocol's 2^−hits scale) every order
is exact, so the histograms must match bit for bit, the Pallas kernel
(interpret mode) included; on arbitrary weights they must match within
rtol 1e-5 (the order rule, ``ref.xla_cpu_block``, makes them equal on
the host it was established on).  The split reductions must match bit
for bit when fed the same histograms.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.histogram import kernel as j_kernel
from repro.kernels.histogram import ref as j_ref
from repro_torch.kernels.histogram import kernel, ops, ref

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

SHAPES = {          # (B, c, N, F, Q)
    "pooled_level0": (4, 400, 1, 8, 32),
    "pooled_level1": (4, 400, 2, 8, 32),
    "players": (8, 100, 2, 4, 8),
    "ragged": (3, 77, 4, 3, 8),
    "one_point": (2, 1, 2, 2, 4),
}


def _inputs(name, dyadic, seed=0):
    B, c, N, F, Q = SHAPES[name]
    rng = np.random.default_rng(seed)
    x = (rng.random((B, c, F)) * 1.3 - 0.15).astype(np.float32)
    x[0, 0, 0] = np.nan                     # bins to 0, as in XLA
    if dyadic:
        w = np.ldexp(1.0, -rng.integers(0, 20, (B, N, c))).astype(np.float32)
    else:
        w = (rng.random((B, N, c)) / c).astype(np.float32)
    w[rng.random((B, N, c)) < 0.3] = 0.0    # off-node points
    wy = np.where(rng.random((B, N, c)) < 0.5, -w, w).astype(np.float32)
    return x, w, wy, Q


def _jax_batched(x, w, wy, Q):
    """The reference's histogram as its engine evaluates it: under the
    task vmap, with the routed weights laid out [c, N] and transposed
    into the contraction (``jnp.where(onnode, …).T`` in trees.py)."""
    wt, wyt = w.transpose(0, 2, 1), wy.transpose(0, 2, 1)
    return [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda a, b, c: j_ref.node_histograms_ref(a, b.T, c.T, Q)))(
            x, wt, wyt)]


def _port(x, w, wy, Q):
    return [a.numpy() for a in ops.node_histograms(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(wy), Q)]


@pytest.mark.parametrize("name", SHAPES)
def test_histograms_bitwise_on_dyadic_weights(name):
    x, w, wy, Q = _inputs(name, dyadic=True)
    got = _port(x, w, wy, Q)
    for g, r in zip(got, _jax_batched(x, w, wy, Q)):
        np.testing.assert_array_equal(g, r)
    # the Pallas kernel (interpret mode), padded as its ops wrapper pads
    B, c, F = x.shape
    pc, pf = (-c) % j_kernel.BC, (-F) % j_kernel.BF
    hk = j_kernel.hist_batched_pallas(
        np.pad(x, ((0, 0), (0, pc), (0, pf))),
        np.pad(w, ((0, 0), (0, 0), (0, pc))),
        np.pad(wy, ((0, 0), (0, 0), (0, pc))), bins=Q, interpret=True)
    for g, r in zip(got, hk):
        np.testing.assert_array_equal(g, np.asarray(r)[:, :, :F, :Q])


@pytest.mark.parametrize("name", SHAPES)
def test_histograms_and_splits_on_arbitrary_weights(name):
    x, w, wy, Q = _inputs(name, dyadic=False, seed=1)
    ref_h = _jax_batched(x, w, wy, Q)
    got = _port(x, w, wy, Q)
    for g, r in zip(got, ref_h):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=0.0)
    # the reductions, fed the same histograms
    hw, hwy = (torch.from_numpy(np.array(a)) for a in ref_h)
    for g, r in zip(ops.best_splits_ref(hw, hwy),
                    jax.jit(jax.vmap(j_ref.best_splits_ref))(*ref_h)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(ops.best_splits_per_feature(hw, hwy),
                    jax.jit(jax.vmap(j_ref.best_splits_per_feature))(
                        *ref_h)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        ref.split_err_surface(hw, hwy).numpy(),
        np.asarray(jax.jit(j_ref.split_err_surface)(*ref_h)))


def test_bin_index_and_block_rule():
    v = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 0.99999, -0.0,
                  1.0, 0.5, 0.03125], np.float32)
    np.testing.assert_array_equal(
        ops.bin_index(torch.from_numpy(v), 32).numpy(),
        np.asarray(j_ref.bin_index(v, 32)))
    assert ref.xla_cpu_block(400, 1) == 400
    assert ref.xla_cpu_block(384, 2) == 384
    assert ref.xla_cpu_block(400, 2) == 200
    assert ref.xla_cpu_block(800, 2) == 200
    # a block wider than c sums left to right, as block = c does
    x, w, wy, Q = _inputs("ragged", dyadic=False, seed=2)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(wy),
            Q)
    for a, b in zip(ref.node_histograms_ref(*args, 77),
                    ref.node_histograms_ref(*args, 1000)):
        assert torch.equal(a, b)


def test_histogram_rejects_bad_inputs():
    x = torch.zeros((2, 5, 3))
    w = torch.zeros((2, 2, 5))
    with pytest.raises(TypeError):
        ops.node_histograms(x.double(), w, w, 8)
    with pytest.raises(ValueError):
        ops.node_histograms(x, w[..., :4], w[..., :4], 8)
    with pytest.raises(ValueError):
        ops.node_histograms(x, w, w, 6)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.node_histograms(x, w, w, 8, interpret=False)


def _sort_route_model(x, w, wy, Q, block):
    """A numpy float32 model of the CUDA kernel's "sort" route: each
    (task, feature) column's points stably ordered by bin; each (node,
    bin) entry adds its bin's points in index order, from +0, restarting
    the partial at each k-block boundary and adding it to the total when
    a block ends.  The points outside the bin are skipped, not added as
    +0.0."""
    G, c, F = x.shape
    N = w.shape[1]
    b = ref.bin_index(torch.from_numpy(x), Q).numpy()
    out = [np.zeros((G, N, F, Q), np.float32) for _ in range(2)]
    zero = np.float32(0.0)
    with np.errstate(all="ignore"):            # inf − inf, NaN
        for g in range(G):
            for f in range(F):
                order = np.argsort(b[g, :, f], kind="stable")
                first = np.searchsorted(b[g, order, f], np.arange(Q + 1))
                for n in range(N):
                    for q in range(Q):
                        run = order[first[q]:first[q + 1]]
                        for k, v in enumerate((w, wy)):
                            tot, part, end = zero, zero, -1
                            for i in run:
                                if i >= end:            # a k-block ends
                                    if end >= 0:
                                        tot = np.float32(tot + part)
                                        part = zero
                                    end = (i // block + 1) * block
                                part = np.float32(part + v[g, n, i])
                            out[k][g, n, f, q] = np.float32(tot + part)
    return out


def _same_bits(a, b):
    """Equal bit for bit, ±0.0 apart; NaN where the other is NaN (its
    payload follows the operand order the compiler picks)."""
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a.view(np.uint32)[~nan],
                                  b.view(np.uint32)[~nan])


@pytest.mark.parametrize("G,N,c,F,Q,block", [(16, 2, 400, 8, 32, 200),
                                             (3, 2, 1000, 3, 8, 250)])
def test_sort_route_summation_equals_the_plain_version(G, N, c, F, Q,
                                                       block):
    """The kernel's "sort" route sums only a bin's own points, in index
    order, in k-blocks; the plain version adds +0.0 for every point
    outside the bin.  The same bits, ±0.0, ±inf and NaN weights
    included: a partial that starts at +0 never becomes −0."""
    assert ref.xla_cpu_block(c, N) == block
    rng = np.random.default_rng(c)
    x = (rng.random((G, c, F)) * 1.3 - 0.15).astype(np.float32)
    x[0, 0, 0] = np.nan
    w = (rng.random((G, N, c)) / c).astype(np.float32)
    w[rng.random((G, N, c)) < 0.3] = 0.0
    wy = np.where(rng.random((G, N, c)) < 0.5, -w, w).astype(np.float32)
    for v in (w, wy):
        for special in (0.0, -0.0, np.inf, -np.inf, np.nan):
            for g in range(G):
                for n in range(N):
                    v[g, n, rng.choice(c, 2, replace=False)] = special
    want = ref.node_histograms_ref(*(torch.from_numpy(a) for a in (x, w, wy)),
                                   Q, block)
    got = _sort_route_model(x, w, wy, Q, block)
    for a, b in zip(got, want):
        assert np.isfinite(a).any() and np.isnan(a).any()
        _same_bits(a, b.numpy())


def test_plan_routes_the_engine_shapes_to_sort():
    """Every shape the engine and chip_smoke.py launch takes the "sort"
    route (c ≤ 1000, Q ≤ 64, F ≤ 40); a column whose state does not fit
    in a block's shared memory takes the "tiled" one."""
    for G, N, c, F, Q in [(16, 1, 400, 8, 32), (16, 2, 400, 8, 32),
                          (64, 2, 100, 8, 32), (5, 4, 77, 3, 8),
                          (3, 2, 1000, 3, 8), (2, 2, 300, 40, 64),
                          (16, 2, 1000, 40, 64)]:
        p = kernel.plan(G, N, c, F, Q)
        assert p.route == "sort" and p.tile == 0
        assert p.smem_bytes == kernel.sort_smem_bytes(N, c, Q) \
            <= kernel.SMEM_LIMIT
    assert kernel.sort_smem_bytes(2, 400, 32) == \
        4 * (2 * 2 * 400 + 8 * 32 + 33) + 4 * 400
    for G, N, c, F, Q in [(2, 1, 300, 3, 8192), (1, 64, 500, 2, 8),
                          (1, 1, 70000, 2, 8), (70000, 1, 10, 2, 8)]:
        p = kernel.plan(G, N, c, F, Q)
        assert p.route == "tiled"
        assert p.tile == kernel.tile_rows(F)
        assert p.smem_bytes == p.tile * (2 * F + 8)
