"""The port's mw_update against the JAX kernel and its oracle.

On the CPU the wrapper runs its plain version (the CUDA kernel's exact
summation order); ``chip_smoke.py`` and the ``cuda``-marked test below
hold the kernel itself to it on the card.  new_hits must match bit for
bit.  Weight sums agree within rtol 1e-6: the reference sums in another
order and its exp2 is XLA's polynomial, off by up to an ulp from the
exact powers of two the port sums.
"""

import numpy as np
import pytest
import torch

from repro.kernels.mw_update import ops as jax_ops
from repro.kernels.mw_update import ref as jax_ref
from repro_torch.kernels.mw_update import ops, ref


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    R, m = {"ragged": (3, 1000), "multi_block": (2, 5000),
            "dead_and_alive_rows": (4, 2049), "hits_to_126": (3, 777),
            "tiny": (2, 5)}[name]
    hi = 127 if name == "hits_to_126" else 40
    hits = rng.integers(0, hi, (R, m)).astype(np.int32)
    correct = rng.random((R, m)) < 0.5
    alive = rng.random((R, m)) < 0.8
    if name == "hits_to_126":
        hits[:, :5] = 126
        correct[:, :5] = False
    if name == "dead_and_alive_rows":
        alive[1] = False
        alive[2] = True
    return hits, correct, alive


CASES = ["ragged", "multi_block", "dead_and_alive_rows", "hits_to_126",
         "tiny"]


@pytest.mark.parametrize("name", CASES)
def test_mw_update_matches_jax_kernel_and_ref(name):
    hits, correct, alive = _case(name)
    new_hits, wsum = ops.mw_update(torch.from_numpy(hits),
                                   torch.from_numpy(correct),
                                   torch.from_numpy(alive))
    assert new_hits.dtype == torch.int32 and wsum.dtype == torch.float32
    for r in range(hits.shape[0]):
        jh, jw = jax_ops.mw_update(hits[r], correct[r], alive[r],
                                   interpret=True)
        np.testing.assert_array_equal(new_hits[r].numpy(), np.asarray(jh))
        np.testing.assert_allclose(wsum[r].numpy(), np.asarray(jw),
                                   rtol=1e-6)
        m = hits.shape[1]
        pad = (-m) % 128
        rh, rp = jax_ref.mw_update_ref(
            np.pad(hits[r], (0, pad)), np.pad(correct[r], (0, pad)),
            np.pad(alive[r], (0, pad)), 128)
        np.testing.assert_array_equal(new_hits[r].numpy(),
                                      np.asarray(rh)[:m])
        np.testing.assert_allclose(wsum[r].numpy(),
                                   np.asarray(rp).sum(dtype=np.float64),
                                   rtol=1e-6)
    if name == "dead_and_alive_rows":
        assert wsum[1].item() == 0.0
        np.testing.assert_array_equal(new_hits[1].numpy(), hits[1])


def test_plain_version_is_exact_powers_of_two_in_kernel_order():
    hits, correct, alive = _case("multi_block", seed=3)
    h = torch.from_numpy(hits)
    nh, wsum = ref.mw_update_ref(h, torch.from_numpy(correct),
                                 torch.from_numpy(alive))
    exact = np.where(alive, np.ldexp(1.0, -nh.numpy().astype(np.int64)),
                     0.0).sum(axis=1)
    np.testing.assert_allclose(wsum.numpy(), exact, rtol=1e-6)
    np.testing.assert_array_equal(
        ref.pow2_neg(torch.arange(151, dtype=torch.int32)).numpy(),
        np.ldexp(np.float32(1), -np.arange(151)).astype(np.float32))
    forced = ops.mw_update(h, torch.from_numpy(correct),
                           torch.from_numpy(alive), interpret=True)
    np.testing.assert_array_equal(forced[1].numpy(), wsum.numpy())


def test_mw_update_rejects_bad_inputs():
    h = torch.zeros((2, 8), dtype=torch.int32)
    b = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(TypeError):
        ops.mw_update(h.long(), b, b)
    with pytest.raises(ValueError):
        ops.mw_update(h, b[:, :4], b)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mw_update kernel has no "
                    "CPU mode")
    for name in CASES:
        hits, correct, alive = (torch.from_numpy(a).cuda()
                                for a in _case(name))
        before = ops.launches
        kh, kw = ops.mw_update(hits, correct, alive)
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        rh, rw = ops.mw_update(hits, correct, alive, interpret=True)
        assert torch.equal(kh, rh)
        assert torch.equal(kw, rw), (kw, rw)
