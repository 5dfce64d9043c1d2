"""The port's stump contraction and its exact OPT against the JAX package.

On the CPU the wrapper runs its plain version (``ref.py``);
tests/test_torch_kernels_cuda.py holds the CUDA kernel to it on the
card.  Against the reference, on its own kernel test cases
(tests/test_kernels.py): the scores S within rtol 1e-5 plus an atol of
1e-6·Σ|wy| (sums in another order; S near zero cancels), against both
the Pallas kernel in interpret mode and the jnp oracle.  The errors are
held to a float64 direct sum with atol 1e-6·W — not to the reference's
closed-form bar, which its own batched test fails near zero error
(ROADMAP queue 3).  Integer weights give exact counts.  The OPT helper
(one batched launch on the card) equals ``repro.core.tasks.true_opt``
on stumps tasks, at sizes that are and are not powers of two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scenarios as j_scen
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro.kernels.stump import ops as j_ops
from repro.kernels.stump import ref as j_ref
from repro_torch.core import scenarios, tasks, weak
from repro_torch.kernels.stump import ops, ref

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

# the reference's stump cases (tests/test_kernels.py), as (B or None,
# c, F, Q, kind): its sweep, block boundaries, all-negative weights,
# duplicated thresholds and the batched grid
CASES = [(None, 32, 1, 8, "sweep"), (None, 128, 8, 128, "sweep"),
         (None, 257, 9, 130, "sweep"), (None, 512, 16, 256, "sweep"),
         (None, 127, 7, 127, "edge"), (None, 129, 9, 129, "edge"),
         (None, 128, 8, 128, "edge"), (None, 1, 1, 1, "edge"),
         (None, 255, 17, 257, "edge"), (None, 130, 9, 127, "negative"),
         (None, 64, 4, 6, "duplicates"), (1, 127, 7, 129, "edge"),
         (3, 129, 9, 127, "edge"), (2, 128, 8, 128, "edge"),
         (4, 33, 3, 17, "edge"), (2, 129, 9, 130, "negative_duplicates")]


def _case(B, c, F, Q, kind, seed=0):
    rng = np.random.default_rng(seed + c * 31 + F * 7 + Q)
    lead = () if B is None else (B,)
    if kind in ("duplicates", "negative_duplicates"):
        x = rng.integers(0, 8, lead + (c, F)).astype(np.float32)
        th = np.repeat(rng.integers(0, 8, lead + (F, 1)), Q,
                       axis=-1).astype(np.float32)
    else:
        x = (rng.standard_normal(lead + (c, F)) * 10).astype(np.float32)
        th = (rng.standard_normal(lead + (F, Q)) * 10).astype(np.float32)
        if kind == "sweep":
            th = np.sort(th, axis=-1)
    w = (rng.random(lead + (c,)) + 0.05).astype(np.float32)
    if kind.startswith("negative"):
        y = -np.ones(lead + (c,), np.float32)
    else:
        y = rng.choice([-1.0, 1.0], lead + (c,)).astype(np.float32)
    return x, w, y, th


def _direct(x, w, y, th):
    """float64 errors by a direct sum over the points."""
    x, w, y, th = (np.asarray(a, np.float64) for a in (x, w, y, th))
    pred = x[..., :, :, None] >= th[..., None, :, :]      # [.., c, F, Q]
    pos = np.einsum("...c,...cfq->...fq", w * (y < 0), pred) + np.einsum(
        "...c,...cfq->...fq", w * (y > 0), ~pred)
    return np.stack([pos, w.sum(-1)[..., None, None] - pos], axis=-1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_scores_match_the_pallas_kernel_and_its_oracle(case):
    x, w, y, th = _case(*case)
    wy = (w * y).astype(np.float32)
    got = ops.stump_scores(*_t(x, wy, th)).numpy()
    atol = 1e-6 * float(np.abs(wy).sum(-1).max())
    pallas = np.asarray(j_ops.stump_scores(jnp.asarray(x), jnp.asarray(wy),
                                           jnp.asarray(th), interpret=True))
    oracle = np.asarray(j_ref.stump_scores_ref(jnp.asarray(x),
                                               jnp.asarray(wy),
                                               jnp.asarray(th)))
    assert got.shape == pallas.shape == th.shape
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_errors_match_a_float64_direct_sum(case):
    x, w, y, th = _case(*case)
    got = ops.stump_errors(*_t(x, w, y, th)).numpy()
    want = _direct(x, w, y, th)
    assert got.shape == th.shape + (2,)
    W = w.astype(np.float64).sum(-1).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * W)
    assert np.array_equal(ref.stump_errors_ref(*_t(x, w, y, th)).numpy(),
                          got)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_integer_weights_give_exact_counts(case):
    x, w, y, th = _case(*case, seed=1)
    w = np.floor(w * 4).astype(np.float32) + 1.0          # 1 … 5
    got = ops.stump_errors(*_t(x, w, y, th)).numpy()
    assert np.array_equal(got, _direct(x, w, y, th))


def test_batched_lanes_equal_their_unbatched_calls():
    x, w, y, th = _case(3, 129, 9, 127, "edge")
    wy = (w * y).astype(np.float32)
    got = ops.stump_scores(*_t(x, wy, th))
    for b in range(3):
        assert torch.equal(got[b], ops.stump_scores(*_t(x[b], wy[b], th[b])))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w, y, th = _t(*_case(None, 16, 2, 4, "edge"))
    with pytest.raises(TypeError, match="float32"):
        ops.stump_scores(x.double(), w, th)
    with pytest.raises(ValueError, match="shapes"):
        ops.stump_scores(x, w[:-1], th)
    with pytest.raises(ValueError, match="shapes"):
        ops.stump_scores(x, w, th[:1])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.stump_scores(x, w, th, interpret=False)


def _stump_task(m, seed, scenario=None):
    cls_j, cls_t = j_weak.AxisStumps(num_features=8), weak.AxisStumps(
        num_features=8)
    if scenario is None:
        return (j_tasks.make_task(cls_j, m, 4, m // 10, seed=seed),
                tasks.make_task(cls_t, m, 4, m // 10, seed=seed))
    spec_j = j_scen.ScenarioSpec(name=scenario, noise=m // 20)
    spec_t = scenarios.ScenarioSpec(name=scenario, noise=m // 20)
    return (j_scen.make_scenario_task(cls_j, m, 4, spec_j, seed=seed),
            scenarios.make_scenario_task(cls_t, m, 4, spec_t, seed=seed))


@pytest.mark.parametrize("m", [512, 1536, 4096])
@pytest.mark.parametrize("scenario", [None, "boundary"])
def test_stump_opt_equals_the_references_true_opt(m, scenario):
    before = ops.launches
    for seed in range(2):
        ref_task, task = _stump_task(m, seed, scenario)
        np.testing.assert_array_equal(ref_task.x, task.x)
        np.testing.assert_array_equal(ref_task.y, task.y)
        assert tasks.true_opt(task, "cpu") == j_tasks.true_opt(ref_task)
    assert ops.launches == before          # the plain version ran


def test_stump_opt_counts_of_a_batch_equal_each_tasks():
    pairs = [_stump_task(1536, seed) for seed in range(3)]
    ts = [t for _, t in pairs]
    got = tasks.opt_counts(ts[0].cls, np.stack([t.flat_x for t in ts]),
                           np.stack([t.flat_y for t in ts]), "cpu")
    assert got.dtype == np.int64
    assert got.tolist() == [j_tasks.true_opt(r) for r, _ in pairs]


def test_stump_opt_of_constant_features():
    """No threshold separates points with equal features: one odd label
    costs 1, a sample of one label costs nothing."""
    x = np.zeros((1, 6, 2), np.float32)
    y = np.ones((1, 6), np.int8)
    y[0, 3] = -1
    assert tasks.opt_counts(weak.AxisStumps(num_features=2), x, y,
                            "cpu").tolist() == [1]
    y[:] = -1
    assert tasks.opt_counts(weak.AxisStumps(num_features=2), x, y,
                            "cpu").tolist() == [0]
