"""The port's feature-track stepping API: slices and state carried
over from the JAX engine, on a HistogramTrees case.

Slices of ``run_rounds`` (1, 3, 7 rounds per call) give the monolithic
run's final state bit for bit, keys and the NaN fill of dead shards'
coresets included; a JAX state converted after 3 rounds, key words and
all, and finished by the port equals the JAX run to completion, and so
does a port state finished by JAX.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import batched as j_batched
from repro.core.types import BoostConfig as JConfig
from repro_torch import convert
from repro_torch.core import batched, prng
from repro_torch.core.types import BoostConfig

from test_torch_feature_engine import (TREE_B, TREE_CFG, TREE_KEY,
                                       _tree_runs,
                                       assert_feature_results_equal)

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)


def _run_sliced(x, y, cls, n):
    cfg = BoostConfig(**TREE_CFG)
    s = batched.init_state(x, y, prng.key(TREE_KEY), cfg, cls=cls,
                           device="cpu")
    for _ in range(500):
        s = batched.run_rounds(s, x, y, cfg, cls, n=n)
        if not bool((~s.done & (s.attempt < cfg.opt_budget + 1)).any()):
            break
    return s


@functools.cache
def _whole():
    _, cls, x, y = _tree_runs("histogram")
    return cls, x, y, _run_sliced(x, y, cls, None)


@pytest.mark.parametrize("slice_rounds", [1, 3, 7])
def test_tree_sliced_runs_equal_monolithic(slice_rounds):
    cls, x, y, whole = _whole()
    sliced = _run_sliced(x, y, cls, slice_rounds)
    for name, a, b in zip(batched.StepState._fields, whole, sliced):
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(
            torch.nan_to_num(a, nan=-7.0), torch.nan_to_num(b, nan=-7.0))
        ), name


def test_jax_tree_state_with_keys_finished_by_the_port():
    jcls, cls, x, y = _tree_runs("coreset")
    jcfg, cfg = JConfig(**TREE_CFG), BoostConfig(**TREE_CFG)
    keys = jax.random.split(jax.random.key(TREE_KEY), TREE_B)
    alive0 = np.ones(x.shape[:3], bool)
    js = j_batched.init_state(x, y, keys, jcfg, cls=jcls)
    js = j_batched.run_rounds(js, x, y, jcfg, jcls, n=3)
    ref = j_batched.finalize(j_batched.run_rounds(js, x, y, jcfg, jcls),
                             x, y, alive0, jcfg, jcls)
    ps = convert.from_jax(jax.device_get(js)._asdict(), device="cpu")
    assert ps.key_data.dtype == torch.int64
    got = batched.finalize(batched.run_rounds(ps, x, y, cfg, cls), x, y,
                           alive0, cfg, cls)
    assert_feature_results_equal(ref, got)
    # and back: the port's state after 3 rounds, finished by JAX
    ps = batched.init_state(x, y, prng.split(prng.key(TREE_KEY), TREE_B),
                            cfg, cls=cls, device="cpu")
    leaves = convert.to_jax(batched.run_rounds(ps, x, y, cfg, cls, n=3))
    for f, dtype in j_batched.STATE_DTYPES.items():
        assert leaves[f].dtype == np.dtype(dtype), f
    for f in ("key_data", "akey_data"):           # the same key words
        np.testing.assert_array_equal(leaves[f], np.asarray(getattr(js, f)))
    js = j_batched.StepState(**leaves)
    again = j_batched.finalize(j_batched.run_rounds(js, x, y, jcfg, jcls),
                               x, y, alive0, jcfg, jcls)
    assert_feature_results_equal(ref, again)
