"""The port's HistogramTrees ≡ the JAX batched engine at the tree
slice's widths.

``chip_smoke.py``'s tree slice runs F = 8 features, depth 2, 32 bins,
the coreset wire mode, k = 4 players and coreset 100.  Here the same
widths run on both engines on the CPU at m = 2048 (shards of 512
points) and B = 2, with planted noise 8 as in the slice: once with the
slice's opt budget of 16, where every task finishes, and once with a
budget of 2, below the noise, where every task exhausts its budget.
Every protocol output must be equal, ``ok`` and the attempts included,
so the port finishes and fails the same tasks as the reference.  The
histogram order is probed first at these shapes, as in
test_torch_feature_engine.py (ROADMAP queue 3).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import batched as j_batched
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro_torch.core import batched, prng, tasks, weak
from repro_torch.core.types import BoostConfig

from test_torch_feature_engine import (TREE_CFG, _assert_every_task,
                                       _probe_histogram_order)

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

B, M, NOISE, SEED, KEY = 2, 2048, 8, 3, 5
TREE_KW = dict(num_features=8, tree_depth=2, tree_bins=32,
               tree_comm_mode="coreset")


@pytest.mark.parametrize("budget,all_ok", [(16, True), (2, False)],
                         ids=["budget16", "budget2"])
def test_trees_at_slice_widths_equal_jax_batched_engine(budget, all_ok):
    _probe_histogram_order(B, TREE_KW["num_features"], TREE_KW["tree_bins"])
    jcls = j_weak.make_class("tree", **TREE_KW)
    cls = weak.make_class("tree", **TREE_KW)
    x, y, _ = j_tasks.make_batch(jcls, B, M, 4, NOISE, seed0=SEED)
    px, py, _ = tasks.make_batch(cls, B, M, 4, NOISE, seed0=SEED)
    np.testing.assert_array_equal(px, x)
    np.testing.assert_array_equal(py, y)
    cfg = dict(TREE_CFG, opt_budget=budget)
    ref = j_batched.run_accurately_classify_batched(
        x, y, jax.random.split(jax.random.key(KEY), B), JConfig(**cfg), jcls)
    got = batched.run_accurately_classify_batched(
        x, y, prng.split(prng.key(KEY), B), BoostConfig(**cfg), cls,
        device="cpu")
    assert bool(got.ok.all()) if all_ok else not got.ok.any()
    _assert_every_task(ref, got, x)
