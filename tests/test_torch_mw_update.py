"""The port's mw_update against the JAX kernel and its oracle.

On the CPU the wrapper runs its plain version (the CUDA kernel's exact
summation order); ``chip_smoke.py`` and the ``cuda``-marked test below
hold the kernel itself to it on the card.  new_hits must match bit for
bit.  Weight sums agree within rtol 1e-6: the reference sums in another
order and its exp2 is XLA's polynomial, off by up to an ulp from the
exact powers of two the port sums.

The sum is shifted by a per-row exponent (the engine passes each row's
least alive hit count): with hits past 126, where an unshifted
Σ 2^−hits leaves float32's normal range, the engine's log2 weight sum
equals ``repro.core.weights.log_weight_sum`` bit for bit on sums that
are exact in float32, and a zero shift gives the unshifted bits.
"""

import numpy as np
import pytest
import torch

from repro.core import weights as j_weights
from repro.kernels.mw_update import ops as jax_ops
from repro.kernels.mw_update import ref as jax_ref
from repro_torch.core import weights
from repro_torch.core.approximation import least_alive_hits
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


def _shifted_case(seed, R=5, m=3001):
    """Hits in 120–300: each row's least hit count in 120–288 and a
    spread of 12 above it, so every term of the reference's max-shifted
    sum is an exact power of two (XLA's exp2 is exact to 2^−12) and the
    sums are exact in any order.  Row 1's lightest points are all hit,
    so its least count moves up by one; row 3 is dead."""
    rng = np.random.default_rng(seed)
    base = rng.integers(120, 289, R)
    hits = (base[:, None] + rng.integers(0, 12, (R, m))).astype(np.int32)
    hits[:, :3] = base[:, None]
    correct = rng.random((R, m)) < 0.5
    alive = rng.random((R, m)) < 0.8
    alive[:, :3] = True
    correct[1, hits[1] == base[1]] = True
    correct[0, :3] = False
    alive[3] = False
    return hits, correct, alive


@pytest.mark.parametrize("seed", [0, 1])
def test_shifted_sum_past_126_hits_gives_the_reference_log_weight_sum(
        seed):
    hits, correct, alive = _shifted_case(seed)
    h, c, a = (torch.from_numpy(v) for v in (hits, correct, alive))
    shift = least_alive_hits(h, a)
    assert int(shift[0]) > 126 or int(shift[1]) > 126
    new_hits, wsum = ops.mw_update(h, c, a, shift)
    assert torch.equal(new_hits, h + (c & a).to(torch.int32))
    assert float(wsum[3]) == 0.0
    got = weights.log_wsums_from_sums(wsum, least_alive_hits(new_hits, a),
                                      shift)
    want = np.asarray(j_weights.log_weight_sum(new_hits.numpy(), alive,
                                               axis=-1))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isneginf(want[3])
    hmin = least_alive_hits(new_hits, a)
    assert int(hmin[1]) == int(shift[1]) + 1 and int(hmin[0]) == int(shift[0])


@pytest.mark.parametrize("name", CASES)
def test_zero_shift_gives_the_unshifted_bits(name):
    """shift 0 is the unshifted sum, and a shift by the least alive hit
    count only scales it by a power of two, exactly, while its terms
    stay normal (hits ≤ 126)."""
    hits, correct, alive = _case(name)
    h, c, a = (torch.from_numpy(v) for v in (hits, correct, alive))
    nh0, w0 = ops.mw_update(h, c, a)
    zero = torch.zeros(h.shape[:1], dtype=torch.int32)
    nh, w = ops.mw_update(h, c, a, zero)
    assert torch.equal(nh, nh0) and torch.equal(w, w0)
    assert torch.equal(ref.mw_update_ref(h, c, a)[1], w0)
    shift = least_alive_hits(h, a)
    live = w0 > 0
    shift = torch.where(live, shift, 0)
    _, ws = ops.mw_update(h, c, a, shift)
    scale = ((127 - shift) << 23).view(torch.float32)      # 2^−shift
    assert torch.equal(ws * scale, w0)


def test_mw_update_rejects_bad_inputs():
    h = torch.zeros((2, 8), dtype=torch.int32)
    b = torch.ones((2, 8), dtype=torch.bool)
    with pytest.raises(TypeError):
        ops.mw_update(h.long(), b, b)
    with pytest.raises(ValueError):
        ops.mw_update(h, b[:, :4], b)
    with pytest.raises(ValueError, match="shift"):
        ops.mw_update(h, b, b, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="shift"):
        ops.mw_update(h, b, b, torch.zeros(2, dtype=torch.int64))


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
