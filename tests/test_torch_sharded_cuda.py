"""The sharded engine on the card: one NCCL rank over an in-process
``HashStore``, held to the batched engine on the same card on every
protocol field, with the ledger validated against the wire counters and
the run's collectives equal to ``steps × collective_sites_per_round``
— on thresholds (with and without a center) and on HistogramTrees in
its histogram and voting modes; and a world that a launcher formed in
subprocesses: each rank on ``cuda:LOCAL_RANK``, a gloo world refused on
the card, and (with two cards) a 2-rank NCCL world equal to the
batched engine.  Every test here needs a CUDA device and skips on a
host without one (the 2-rank NCCL world needs two); the file imports
no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_sharded_cuda.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import batched, ledger, prng, sharded_batched, tasks
from repro_torch.core import weak
from repro_torch.core.types import BoostConfig
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.mw_update import ops as mw_ops

FIELDS = ("hypotheses", "rounds", "ok", "attempts", "alive", "disputed",
          "min_loss", "hist_stuck", "hist_rounds", "hist_alive", "hist_p",
          "hist_players", "hist_players_h", "hist_players_last")


@pytest.fixture(scope="module")
def group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NCCL group and the "
                    "hand-written kernels have no CPU mode")
    with sharded_batched.make_players_group(4, "cuda") as g:
        yield g


def _case(name):
    if name.startswith("tree"):
        cls = weak.make_class("tree", num_features=4, tree_depth=2,
                              tree_bins=8,
                              tree_comm_mode=name.split("/")[1])
        cfg = BoostConfig(k=4, coreset_size=100, domain_size=4096,
                          opt_budget=16, deterministic_coreset=False)
        return cls, cfg, tasks.make_batch(cls, 2, 512, 4, 2, seed0=3)
    cls = weak.Thresholds(n=4096)
    cfg = BoostConfig(k=4, coreset_size=24, domain_size=4096, opt_budget=32)
    return cls, cfg, tasks.make_batch(cls, 2, 512, 4, 3, seed0=11)


@pytest.mark.cuda
@pytest.mark.parametrize("name,no_center", [
    ("thresholds", False), ("thresholds", True), ("tree/histogram", False),
    ("tree/voting", False)])
def test_nccl_sharded_equals_batched_on_the_card(group, name, no_center):
    cls, cfg, (x, y, _) = _case(name)
    assert (group.backend, group.size) == ("nccl", 1)
    keys = prng.split(prng.key(5, device="cuda"), 2)
    ref = batched.run_accurately_classify_batched(x, y, keys, cfg, cls,
                                                  device="cuda")
    mw0, hist0 = mw_ops.launches, hist_ops.launches
    got = sharded_batched.run_accurately_classify_sharded(
        x, y, keys, cfg, cls, group=group, no_center=no_center)
    torch.cuda.synchronize()
    assert mw_ops.launches - mw0 == got.steps == ref.steps
    depth = cls.depth if name.startswith("tree") else 0
    assert hist_ops.launches - hist0 == depth * got.steps
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f), f)
    for b in range(2):
        assert ref.ledger(b) == got.ledger(b)
        if got.ok[b]:
            got.validate_ledger(b)
    census = ledger.collective_sites_per_round(cls, no_center=no_center)
    assert got.collective_calls == {k: n * got.steps
                                    for k, n in census.items()}


@pytest.mark.cuda
def test_nccl_one_rank_sum_keeps_the_center_bits(group):
    t = torch.tensor([-0.0, 1.5, -2.0, 0.0], device="cuda")
    out = group.psum(t)
    assert torch.equal(out, t)
    assert torch.equal(torch.signbit(out), torch.signbit(t))


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one rank of a 2-rank world formed outside the port, as torchrun forms
# it: argv rank, store file, output prefix, backend
_RANK = r"""
import json, os, sys
import numpy as np
import torch.distributed as dist

rank, store, out, backend = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4])
dist.init_process_group(backend, store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
from repro_torch.core import prng, sharded_batched
from test_torch_sharded_cuda import FIELDS, _case

meta, results = {}, {}
local = os.environ.pop("LOCAL_RANK")
try:
    sharded_batched.rank_device()
except RuntimeError as e:
    meta["no_local_rank"] = str(e)
os.environ["LOCAL_RANK"] = local
meta["device"] = str(sharded_batched.rank_device())
if backend == "gloo":
    try:
        with sharded_batched.make_players_group(4):
            pass
    except ValueError as e:
        meta["refused"] = str(e)
else:
    with sharded_batched.make_players_group(4) as g:
        for name in ("thresholds", "tree/histogram"):
            cls, cfg, (x, y, _) = _case(name)
            res = sharded_batched.run_accurately_classify_sharded(
                x, y, prng.split(prng.key(5, device=g.device), 2), cfg,
                cls, group=g)
            for b in range(2):
                if res.ok[b]:
                    res.validate_ledger(b)
            for f in FIELDS:
                results[f"{name}/{f}"] = np.asarray(getattr(res, f))
            meta[name] = dict(steps=res.steps, calls=res.collective_calls,
                              mesh_devices=res.mesh_devices,
                              backend=res.backend)
if rank == 0:
    np.savez(out + ".npz", **results)
with open(f"{out}.{rank}.json", "w") as f:
    json.dump(meta, f)
dist.destroy_process_group()
"""


def _launch_world(tmp_path, backend: str, local_ranks) -> list[dict]:
    """Run :data:`_RANK` as two processes; returns each rank's meta."""
    out = str(tmp_path / "world")
    procs = []
    for rank, local in enumerate(local_ranks):
        env = dict(os.environ, LOCAL_RANK=str(local),
                   PYTHONPATH=os.pathsep.join([
                       os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
                       os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, str(rank), str(tmp_path / "store"),
             out, backend], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-4000:]
    metas = []
    for rank in range(2):
        with open(f"{out}.{rank}.json") as f:
            metas.append(json.load(f))
    return metas


@pytest.mark.cuda
def test_launcher_world_needs_local_rank_and_the_device_backend(tmp_path):
    """In a 2-rank world a launcher formed, a bare ``cuda`` without
    LOCAL_RANK raises (it would put every rank on one card), with
    LOCAL_RANK it is that card, and a gloo world is refused for a
    players group on the card (gloo has no CUDA all_gather)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the players group on the card")
    for meta in _launch_world(tmp_path, "gloo", (0, 0)):
        assert "set LOCAL_RANK" in meta["no_local_rank"]
        assert meta["device"] == "cuda:0"
        assert "world runs gloo" in meta["refused"]


@pytest.mark.cuda
def test_nccl_world_of_two_cards_equals_batched(tmp_path):
    """Two NCCL ranks, one per card by LOCAL_RANK, two players each:
    thresholds and a histogram-mode tree equal the batched engine on
    every field, ledgers validated, collectives = census × steps."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: one NCCL rank per card")
    metas = _launch_world(tmp_path, "nccl", (0, 1))
    assert [m["device"] for m in metas] == ["cuda:0", "cuda:1"]
    got = np.load(tmp_path / "world.npz")
    for name in ("thresholds", "tree/histogram"):
        cls, cfg, (x, y, _) = _case(name)
        ref = batched.run_accurately_classify_batched(
            x, y, prng.split(prng.key(5, device="cuda"), 2), cfg, cls,
            device="cuda")
        for f in FIELDS:
            np.testing.assert_array_equal(got[f"{name}/{f}"],
                                          getattr(ref, f), (name, f))
        m = metas[0][name]
        assert (m["mesh_devices"], m["backend"], m["steps"]) == \
            (2, "nccl", ref.steps), name
        census = ledger.collective_sites_per_round(cls)
        assert m["calls"] == {k: n * ref.steps for k, n in census.items()}
