"""The scheduler on the card: a preempted dispatch resumes onto
``cuda`` with every leaf of its state in the engine's dtype, a small
mixed stream (thresholds with a ``drift`` shape, one request preempted
twice) completes on the card equal to the same stream on the CPU,
request by request, and a tree stream's launches find the histogram
plans its bucket programs made.  Every test needs a CUDA device and
skips on a host without one; the file imports no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_scheduler_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.ckpt import msgpack_ckpt
from repro_torch.core import batched, sharded_batched
from repro_torch.kernels.histogram import kernel as hist_kernel
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.mw_update import ops as mw_ops
from repro_torch.launch import scheduler as S

SHAPES = [{"m": 256, "k": 4, "noise": 0}, {"m": 512, "k": 4, "noise": 2},
          {"m": 1024, "k": 4, "noise": 2, "scenario": "drift"}]
LATTICE = S.BucketLattice(b_sizes=(1, 4), mloc_sizes=(64, 128, 256))
COMMON = dict(coreset_size=64, opt_budget=8, domain=1 << 12)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _lanes(done):
    out = {}
    for c in done:
        r, b = c.result, c.lane
        out[c.request.rid] = (
            bool(r.ok[b]), int(r.attempts[b]), int(r.rounds[b]),
            r.hypotheses[b].tobytes(), r.disputed[b].tobytes(),
            r.hist_stuck[b].tobytes(), r.ledger(b))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["batched", "sharded"])
def test_resume_restores_onto_the_card_in_every_leafs_dtype(card, engine,
                                                            tmp_path):
    req = S.Request(rid=0, m=512, k=4, noise=2, seed=3, engine=engine,
                    **COMMON)
    with S.BoostScheduler(lattice=LATTICE, device=card,
                          ckpt_dir=str(tmp_path), preempt={0: 3}) as sched:
        sched.submit(req)
        assert sched.step()[0] == []
        sched._ckpt_writer().wait()
        (sus,) = sched._suspended
        state, meta = msgpack_ckpt.restore_pytree(sus.ckpt_path,
                                                  device=card)
        assert meta["rounds_done"] == 3
        leaves = state if isinstance(state, dict) else state._asdict()
        dtypes = (sharded_batched.STATE_DTYPES if engine == "sharded"
                  else batched.STATE_DTYPES)
        for name, v in leaves.items():
            assert v.device.type == "cuda", name
            want = "int64" if name in batched.KEY_FIELDS else dtypes.get(
                name, str(v.dtype).removeprefix("torch."))
            assert str(v.dtype).removeprefix("torch.") == want, name
        assert int(leaves["step"].max()) == 3
        (done, _) = sched.step()
        assert len(done) == 1 and done[0].resumed
        one = sched.one_shot(req)
        assert _lanes(done) == _lanes([S.Completion(
            request=req, task=done[0].task, result=one, lane=0,
            bucket=done[0].bucket, queue_wait_s=0, service_s=0,
            latency_s=0)])
    assert os.listdir(tmp_path) == []


@pytest.mark.cuda
def test_stream_on_the_card_equals_the_cpu(card, tmp_path):
    arrivals = S.bursty_trace(12, rate_per_s=100.0, burst=4, seed=1)
    reqs = S.make_request_stream(12, arrivals, SHAPES, seed0=20, **COMMON)
    out = {}
    for dev in (card, torch.device("cpu")):
        with S.BoostScheduler(lattice=LATTICE, policy="fill", device=dev,
                              ckpt_dir=str(tmp_path / dev.type),
                              preempt={0: 4, 1: 2}) as sched:
            sched.warm(reqs)
            mw_ops.launches = 0
            done = sched.run_stream(reqs)
            assert sched.stats.resumes == 2
            out[dev.type] = (_lanes(done), mw_ops.launches)
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1] > 0 and out["cpu"][1] == 0


@pytest.mark.cuda
def test_tree_stream_launches_find_their_plans_made(card):
    common = dict(clsname="tree", num_features=8, tree_depth=2,
                  tree_bins=32, coreset_size=100, opt_budget=8)
    reqs = S.make_request_stream(6, np.zeros(6), [{"m": 1024, "k": 4,
                                                   "noise": 2}],
                                 seed0=5, **common)
    with S.BoostScheduler(lattice=LATTICE, device=card) as sched:
        sched.warm(reqs)
        misses = hist_kernel.plan.cache_info().misses
        hist_ops.launches = 0
        done = sched.run_stream(reqs)
        assert len(done) == 6 and hist_ops.launches > 0
        assert hist_kernel.plan.cache_info().misses == misses
