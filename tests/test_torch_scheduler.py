"""The port's continuous-batching scheduler
(``repro_torch.launch.scheduler``) against the reference's.

* Every case of tests/test_scheduler.py and tests/test_preemption.py at
  their sizes, on the CPU (the 200-request stream is in
  tests/test_torch_scheduler_stream.py): zero steady-state builds (the
  reference's jit-cache check becomes ``ClassifyProgram.builds`` and the histogram
  plans made, ``kernel.plan``'s cache misses), bitwise parity of every
  completion with ``one_shot``, an eviction that builds again exactly
  once, the lattice rounding, the filler lane, the arrival traces, fill
  against pack, the counters and their metrics export, the sharded
  stream's wire ledger over a gloo rank, preempted streams equal to
  unpreempted ones and a chained re-preemption.
* Against the JAX scheduler: the same request stream through both
  schedulers gives, request id by request id, equal hypotheses,
  disputed sets, attempts, rounds, stuck histories and ledger fields —
  thresholds with a ``drift`` shape, and stumps.  (Completions are
  compared by request id: which B a batch gets depends on measured wall
  time, and a lane's result does not.)
* ``serve --workload serve-stream --device cpu`` prints the JAX CLI's
  JSON keys plus ``device`` and ``kernel_launches``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import scheduler as J
from repro.launch import serve as j_serve
from repro_torch.core import batched, classify, tasks
from repro_torch.kernels.histogram import kernel as hist_kernel
from repro_torch.launch import scheduler as S
from repro_torch.launch import serve
from repro_torch.obs import metrics as M

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [
    {"m": 64, "k": 2, "noise": 0},
    {"m": 96, "k": 2, "noise": 1},
    {"m": 128, "k": 2, "noise": 2, "scenario": "drift"},
]
# three mloc lattice points ⇒ the 200-request stream hits ≥ 3 buckets
LATTICE = S.BucketLattice(b_sizes=(2, 4), mloc_sizes=(32, 48, 64))
COMMON = dict(coreset_size=48, opt_budget=6)
LEDGER_FIELDS = ("bits_coresets", "bits_weight_sums", "bits_hypotheses",
                 "bits_control", "bits_dispute", "bits_histograms",
                 "bits_votes", "rounds", "attempts")


def _stream(n, engine="batched", rate=500.0, seed=3):
    arrivals = S.poisson_trace(n, rate_per_s=rate, seed=seed)
    return S.make_request_stream(n, arrivals, SHAPES, seed0=100,
                                 engine=engine, **COMMON)


def _sched(**kw):
    return S.BoostScheduler(device="cpu", **kw)


def _lane(c):
    """One completion's protocol outputs: the parity bar's fields."""
    r, b = c.result, c.lane
    out = {"ok": bool(r.ok[b]), "attempts": int(r.attempts[b]),
           "rounds": int(r.rounds[b]),
           "hypotheses": np.asarray(r.hypotheses[b]).tobytes(),
           "disputed": np.asarray(r.disputed[b]).tobytes(),
           "stuck": np.asarray(r.hist_stuck[b]).tobytes()}
    led = r.ledger(b)
    out.update({f: int(getattr(led, f)) for f in LEDGER_FIELDS})
    return out


def _assert_one_shot_parity(sched, c):
    """Completion lane ≡ the one-shot engine run of the same request."""
    one = sched.one_shot(c.request)
    assert _lane(c) == _lane(S.Completion(
        request=c.request, task=c.task, result=one, lane=0,
        bucket=c.bucket, queue_wait_s=0.0, service_s=0.0, latency_s=0.0))
    if c.ok:
        ref, got = one.per_task(0), c.per_task()
        assert ref.stuck_history == got.stuck_history
        assert dataclasses.asdict(ref.ledger) == \
            dataclasses.asdict(got.ledger)


def test_tree_stream_makes_its_histogram_plans_at_warmup():
    """A tree stream's bucket programs make the histogram plans of every
    level at build time; the stream itself makes none (on the card a
    launch finds its plan made)."""
    common = dict(COMMON, clsname="tree", num_features=4, tree_depth=2,
                  tree_bins=8, coreset_size=16)
    reqs = S.make_request_stream(6, np.zeros(6), [{"m": 64, "k": 2,
                                                   "noise": 1}],
                                 seed0=3, **common)
    hist_kernel.plan.cache_clear()
    with _sched(lattice=LATTICE) as sched:
        sched.warm(reqs, b_sizes=LATTICE.b_sizes + (1,))
        made = hist_kernel.plan.cache_info().misses
        assert made == 3 * 2           # (B = 2, 4, 1) × two levels
        builds0 = batched.ClassifyProgram.builds
        done = sched.run_stream(reqs)
        assert len(done) == 6
        assert hist_kernel.plan.cache_info().misses == made
        assert batched.ClassifyProgram.builds == builds0
        for c in done[::2]:
            _assert_one_shot_parity(sched, c)


def test_scheduler_matches_host_reference():
    arrivals = np.zeros(8)
    shapes = [{"m": 64, "k": 2, "noise": 1},      # exact fit: mloc 32
              {"m": 80, "k": 2, "noise": 1}]     # padded: mloc 40 → 48
    reqs = S.make_request_stream(8, arrivals, shapes, seed0=40, **COMMON)
    with _sched(lattice=LATTICE, policy="fill", fill_wait_s=10.0) as sched:
        sched.warm(reqs)
        done = sched.run_stream(reqs)
    assert len(done) == 8
    picks = {}
    for c in done:
        picks.setdefault(c.request.m, c)
    for m in (64, 80):
        c = picks[m]
        req = c.request
        mloc_b = LATTICE.bucket_mloc(req.m // req.k)
        x, y, alive = tasks.pad_shards(c.task.x, c.task.y, mloc_b)
        ref = classify.run_accurately_classify(
            x, y, req.make_key(), req.make_cfg(), req.make_cls(),
            alive=alive, device="cpu")
        got = c.per_task()
        assert ref.attempts == got.attempts
        assert ref.stuck_history == got.stuck_history
        np.testing.assert_array_equal(ref.hypotheses[:ref.rounds],
                                      got.hypotheses[:got.rounds])
        np.testing.assert_array_equal(np.unique(ref.dispute_x),
                                      np.unique(got.dispute_x))
        if req.m == 64:       # exact fit ⇒ identical bit accounting too
            assert ref.ledger.total_bits == got.ledger.total_bits


def test_second_admission_same_bucket_zero_compiles():
    reqs = _stream(4, rate=1e-3, seed=1)
    same = [S.Request(rid=r.rid, m=64, k=2, noise=0, seed=r.seed,
                      arrival_s=r.arrival_s, **COMMON) for r in reqs]
    with _sched(lattice=LATTICE) as sched:
        for r in same[:2]:
            sched.submit(r)
        sched.step()
        first = sched.cache.stats.compiles
        assert first == 1
        builds0 = batched.ClassifyProgram.builds
        for r in same[2:]:
            sched.submit(r)
        done, _ = sched.step()
        assert done and sched.cache.stats.compiles == first
        assert sched.cache.stats.hits == 1
        assert batched.ClassifyProgram.builds == builds0


def test_cache_eviction_recompiles_exactly_once_unit():
    cache = S.CompileCache(capacity=1)
    built = []

    def make_build(tag):
        def build():
            built.append(tag)
            return tag
        return build

    a = S.BucketKey(compat="A", B=1, mloc=32)
    b = S.BucketKey(compat="B", B=1, mloc=32)
    assert cache.get(a, make_build("a")) == "a"
    assert cache.get(b, make_build("b")) == "b"
    assert cache.stats.evictions == 1
    assert cache.get(a, make_build("a")) == "a"
    assert built == ["a", "b", "a"]
    assert cache.get(a, make_build("a")) == "a"
    assert built == ["a", "b", "a"]
    assert cache.stats == S.CacheStats(
        hits=1, misses=3, evictions=2, compiles=3,
        compile_s=cache.stats.compile_s)


def test_cache_eviction_really_rebuilds_engine_programs():
    lattice = S.BucketLattice(b_sizes=(1,), mloc_sizes=(32, 64))
    req_a = S.Request(rid=0, m=64, k=2, noise=1, seed=5, **COMMON)
    req_b = S.Request(rid=1, m=128, k=2, noise=1, seed=6, **COMMON)
    with _sched(lattice=lattice, cache_capacity=1) as sched:
        b0 = batched.ClassifyProgram.builds
        sched.submit(req_a)
        out1, _ = sched.step()
        prog_a = sched.cache._entries[out1[0].bucket]
        assert sched.cache.stats.compiles == 1
        sched.submit(req_b)
        sched.step()
        assert sched.cache.stats.compiles == 2
        assert sched.cache.stats.evictions == 1
        assert out1[0].bucket not in sched.cache._entries
        sched.submit(req_a)
        out2, _ = sched.step()
        assert sched.cache.stats.compiles == 3
        assert sched.cache._entries[out2[0].bucket] is not prog_a
        sched.submit(req_a)
        out3, _ = sched.step()
        assert sched.cache.stats.compiles == 3
        assert sched.cache.stats.hits == 1
        assert batched.ClassifyProgram.builds == b0 + 3
    for o in (out2, out3):
        np.testing.assert_array_equal(o[0].result.hypotheses[0],
                                      out1[0].result.hypotheses[0])


def test_program_refuses_another_signature():
    req = S.Request(rid=0, m=64, k=2, noise=1, seed=5, **COMMON)
    task = req.make_task()
    x, y, alive = tasks.pad_shards(task.x, task.y, 32)
    xb, yb, ab, keys, _ = batched.stack_for_dispatch(
        [(x, y, alive, req.make_key())], 2)
    prog = batched.lower_classify(xb, yb, ab, keys, req.make_cfg(),
                                  req.make_cls(), device="cpu")
    with pytest.raises(ValueError, match="bound to"):
        prog(xb[:1], yb[:1], ab[:1], keys[:1])
    with pytest.raises(ValueError, match="cfg or cls"):
        batched.run_accurately_classify_batched(
            xb, yb, keys, dataclasses.replace(req.make_cfg(), opt_budget=5),
            req.make_cls(), alive=ab, compiled=prog)


def test_sharded_stream_parity_and_wire_ledger():
    reqs = _stream(12, engine="sharded", seed=7)
    with _sched(lattice=LATTICE) as sched:
        sched.warm(reqs, b_sizes=LATTICE.b_sizes + (1,))
        warm_compiles = sched.cache.stats.compiles
        done = sched.run_stream(reqs)
        assert len(done) == 12
        assert sched.cache.stats.compiles == warm_compiles
        validated = 0
        for c in done:
            assert c.result.backend == "gloo"
            if c.ok:
                report = c.validate_ledger()
                assert report["bits_coresets"] > 0
                validated += 1
        assert validated > 0
        for c in done[::4]:
            _assert_one_shot_parity(sched, c)


def test_bucket_lattice_rounding():
    lat = S.BucketLattice(b_sizes=(2, 4), mloc_sizes=(32, 64))
    assert lat.bucket_mloc(9) == 32
    assert lat.bucket_mloc(32) == 32
    assert lat.bucket_mloc(33) == 64
    with pytest.raises(ValueError):
        lat.bucket_mloc(65)
    with pytest.raises(ValueError):
        S.BucketLattice(mloc_sizes=()).bucket_mloc(4)
    assert lat.bucket_b(1) == 2
    assert lat.bucket_b(3) == 4
    assert lat.bucket_b(99) == 4
    assert lat.max_b == 4


def test_pad_shards_masks_dead_rows():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, (2, 5)).astype(np.int32)
    y = rng.choice([-1, 1], (2, 5)).astype(np.int8)
    xp, yp, alive = tasks.pad_shards(x, y, 8)
    assert xp.shape == (2, 8) and alive.shape == (2, 8)
    np.testing.assert_array_equal(xp[:, :5], x)
    np.testing.assert_array_equal(xp[:, 5:], np.repeat(x[:, -1:], 3, 1))
    assert alive[:, :5].all() and not alive[:, 5:].any()
    xs, ys, al = tasks.pad_shards(x, y, 5)
    assert xs is x and ys is y and al.all()
    with pytest.raises(ValueError):
        tasks.pad_shards(x, y, 4)
    xf = rng.standard_normal((2, 5, 3)).astype(np.float32)
    xfp, _, _ = tasks.pad_shards(xf, y, 8)
    assert xfp.shape == (2, 8, 3)
    np.testing.assert_array_equal(xfp[:, 5:], np.repeat(xf[:, -1:], 3, 1))


def test_stack_for_dispatch_fills_with_live_lane():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 100, (2, 4)).astype(np.int32)
    y = rng.choice([-1, 1], (2, 4)).astype(np.int8)
    alive = np.ones((2, 4), bool)
    k0, k1 = S.Request(rid=0, seed=0).make_key(), \
        S.Request(rid=1, seed=1).make_key()
    xb, yb, ab, keys, n_real = batched.stack_for_dispatch(
        [(x, y, alive, k0), (x + 1, y, alive, k1)], 4)
    assert n_real == 2 and xb.shape == (4, 2, 4)
    np.testing.assert_array_equal(xb[2], xb[0])
    np.testing.assert_array_equal(xb[3], xb[0])
    assert keys.dtype == torch.int64 and keys.shape == (4, 2)
    assert torch.equal(keys[2], k0) and torch.equal(keys[1], k1)
    with pytest.raises(ValueError):
        batched.stack_for_dispatch([], 4)
    with pytest.raises(ValueError):
        batched.stack_for_dispatch([(x, y, alive, k0)] * 5, 4)


def test_arrival_traces():
    arr = S.poisson_trace(50, rate_per_s=100.0, seed=2)
    assert arr.shape == (50,) and np.all(np.diff(arr) >= 0)
    assert 0.1 < arr[-1] < 5.0
    np.testing.assert_array_equal(arr, J.poisson_trace(50, 100.0, seed=2))
    burst = S.bursty_trace(50, rate_per_s=100.0, burst=8, seed=2)
    assert burst.shape == (50,) and np.all(np.diff(burst) >= 0)
    assert len(np.unique(burst)) <= 7
    assert 0.1 < burst[-1] < 5.0
    np.testing.assert_array_equal(burst, J.bursty_trace(50, 100.0, burst=8,
                                                        seed=2))


def test_fill_policy_two_bucket_burst_dispatches_full_batch():
    fill_wait = 30.0
    reqs = [S.Request(rid=0, m=64, k=2, noise=0, seed=1, arrival_s=0.0,
                      **COMMON)]
    reqs += [S.Request(rid=1 + i, m=96, k=2, noise=0, seed=2 + i,
                       arrival_s=1e-3, **COMMON)
             for i in range(LATTICE.max_b)]
    reqs.append(S.Request(rid=9, m=64, k=2, noise=0, seed=9,
                          arrival_s=3 * fill_wait, **COMMON))
    with _sched(lattice=LATTICE, policy="fill",
                fill_wait_s=fill_wait) as sched:
        sched.warm(reqs)
        done = sched.run_stream(reqs)
    assert len(done) == len(reqs)
    burst = [c for c in done if c.request.m == 96]
    assert len(burst) == LATTICE.max_b
    assert {c.bucket.B for c in burst} == {LATTICE.max_b}
    assert len({id(c.result) for c in burst}) == 1
    assert max(c.queue_wait_s for c in burst) < fill_wait / 2, \
        [c.queue_wait_s for c in burst]


def test_padded_requests_counter_counts_only_padded_shapes():
    with _sched(lattice=LATTICE) as sched:
        sched.submit(S.Request(rid=0, m=64, k=2, **COMMON))
        assert sched.stats.padded_requests == 0
        sched.submit(S.Request(rid=1, m=80, k=2, **COMMON))
        assert sched.stats.padded_requests == 1
        sched.submit(S.Request(rid=2, m=80, k=2, seed=1, **COMMON))
        assert sched.stats.padded_requests == 2


def test_stats_note_accumulates_per_bucket_occupancy():
    stats = S.SchedulerStats()
    compat = S.CompatKey(engine="batched", cfg=None, cls=None)
    b4 = S.BucketKey(compat=compat, B=4, mloc=32)
    b2 = S.BucketKey(compat=compat, B=2, mloc=64)
    stats.note(b4, 3, 4)
    stats.note(b4, 4, 4)
    stats.note(b2, 1, 2)
    assert stats.dispatches == 3
    assert stats.served == 8
    assert stats.filler_lanes == 2
    assert stats.per_bucket[(4, 32, "batched")] == (7, 8)
    assert stats.per_bucket[(2, 64, "batched")] == (1, 2)


def test_preempt_resume_counters_and_metrics_export(tmp_path):
    reqs = _stream(4, rate=1e-3, seed=9)
    with _sched(lattice=LATTICE, ckpt_dir=str(tmp_path),
                preempt={0: 1, 1: 1}) as sched:
        done = sched.run_stream(reqs)
    assert len(done) == 4
    assert sched.stats.preemptions == 2
    assert sched.stats.resumes == 2
    reg = M.MetricsRegistry()
    M.publish_scheduler_stats(sched.stats, reg)
    M.publish_cache_stats(sched.cache.stats, reg)
    out = reg.to_dict()
    assert out["scheduler.preemptions"]["value"] == 2
    assert out["scheduler.resumes"]["value"] == 2
    assert (out["scheduler.padded_requests"]["value"]
            == sched.stats.padded_requests)
    assert out["scheduler.dispatches"]["value"] == sched.stats.dispatches
    assert (out["scheduler.compile_cache.compiles"]["value"]
            == sched.cache.stats.compiles)
    for key, (served, cap) in sched.stats.per_bucket.items():
        tag = f"B{key[0]}_mloc{key[1]}_{key[2]}"
        assert out[f"scheduler.bucket.{tag}.served"]["value"] == served
        assert out[f"scheduler.bucket.{tag}.capacity"]["value"] == cap
        assert (out[f"scheduler.bucket.{tag}.occupancy"]["value"]
                == served / cap)


def test_fill_policy_batches_fuller_than_pack():
    n = 8
    arrivals = np.arange(n) * 1e-4
    reqs = S.make_request_stream(n, arrivals,
                                 [{"m": 64, "k": 2, "noise": 0}],
                                 seed0=0, **COMMON)
    cache = S.CompileCache()
    with _sched(lattice=LATTICE, policy="fill", fill_wait_s=10.0,
                cache=cache) as fill:
        fill.warm(reqs)
        done_fill = fill.run_stream(reqs)
    assert len(done_fill) == n
    assert fill.stats.dispatches == n // LATTICE.max_b
    assert fill.stats.filler_lanes == 0
    with _sched(lattice=LATTICE, policy="pack", cache=cache) as pack:
        done_pack = pack.run_stream(reqs)
    assert len(done_pack) == n
    assert pack.stats.dispatches >= fill.stats.dispatches


# ---------------------------------------------------------------------------
# tests/test_preemption.py
# ---------------------------------------------------------------------------

def test_preempted_stream_completes_bit_identical(tmp_path):
    reqs = _stream(24)
    with _sched(lattice=LATTICE, ckpt_dir=str(tmp_path),
                preempt={0: 3, 2: 5}) as sched:
        done = sched.run_stream(reqs)
        assert len(done) == len(reqs)
        assert sched.stats.preemptions == 2
        assert sched.stats.resumes == 2
        assert len([c for c in done if c.resumed]) >= 2
        assert [f for f in os.listdir(tmp_path)
                if f.endswith(".msgpack")] == []
        for c in done:
            _assert_one_shot_parity(sched, c)


def test_preempted_equals_unpreempted_stream(tmp_path):
    reqs = _stream(8, seed=5)
    cache = S.CompileCache()
    with _sched(lattice=LATTICE, cache=cache) as plain:
        done_plain = {c.request.rid: c for c in plain.run_stream(reqs)}
    with _sched(lattice=LATTICE, cache=cache, ckpt_dir=str(tmp_path),
                preempt={0: 2}) as pre:
        done_pre = {c.request.rid: c for c in pre.run_stream(reqs)}
    assert pre.stats.resumes == 1
    assert done_plain.keys() == done_pre.keys()
    for rid, cp in done_pre.items():
        assert _lane(cp) == _lane(done_plain[rid])


def test_sharded_preemption_keeps_wire_ledger_valid(tmp_path):
    reqs = _stream(6, engine="sharded", seed=7)
    with _sched(lattice=LATTICE, ckpt_dir=str(tmp_path),
                preempt={0: 2}) as sched:
        done = sched.run_stream(reqs)
        assert len(done) == 6
        assert sched.stats.resumes == 1
        validated = 0
        for c in done:
            if c.ok:
                c.validate_ledger()
                validated += 1
            _assert_one_shot_parity(sched, c)
        assert validated > 0


def test_chained_re_preemption_checkpoints_incrementally(tmp_path):
    from repro_torch.ckpt import msgpack_ckpt
    reqs = S.make_request_stream(2, np.zeros(2), [SHAPES[0]], seed0=2,
                                 **COMMON)
    with _sched(lattice=LATTICE, ckpt_dir=str(tmp_path),
                preempt={0: 2, 1: 2}) as sched:
        for r in reqs:
            sched.submit(r)
        done, _ = sched.step()
        assert done == [] and sched.stats.preemptions == 1
        done, _ = sched.step()
        assert done == [] and sched.stats.preemptions == 2
        assert sched.stats.resumes == 1
        sched._ckpt_writer().wait()
        ckpts = sorted(f for f in os.listdir(tmp_path)
                       if f.endswith(".msgpack"))
        assert len(ckpts) == 2
        assert msgpack_ckpt.snapshot_base(
            os.path.join(tmp_path, ckpts[1])) == ckpts[0]
        assert os.path.getsize(os.path.join(tmp_path, ckpts[1])) < \
            os.path.getsize(os.path.join(tmp_path, ckpts[0]))
        done, _ = sched.step()
        assert len(done) == 2 and all(c.resumed for c in done)
        assert sched.stats.resumes == 2
        assert [f for f in os.listdir(tmp_path)
                if f.endswith(".msgpack")] == []
        for c in done:
            _assert_one_shot_parity(sched, c)


def test_preempt_requires_ckpt_dir():
    with pytest.raises(ValueError):
        _sched(lattice=LATTICE, preempt={0: 3})


def test_queued_counts_suspended_batches(tmp_path):
    reqs = S.make_request_stream(2, np.zeros(2), [SHAPES[0]], seed0=1,
                                 **COMMON)
    with _sched(lattice=LATTICE, ckpt_dir=str(tmp_path),
                preempt={0: 2}) as sched:
        for r in reqs:
            sched.submit(r)
        assert sched.queued() == 2
        done, _ = sched.step()
        assert done == [] and sched.stats.preemptions == 1
        assert sched.queued() == 2
        done, _ = sched.step()
        assert len(done) == 2 and all(c.resumed for c in done)
        assert sched.queued() == 0


# ---------------------------------------------------------------------------
# Against the JAX scheduler
# ---------------------------------------------------------------------------

STUMP_COMMON = dict(clsname="stumps", num_features=4, coreset_size=48,
                    opt_budget=6)


@pytest.mark.parametrize("case", ["thresholds_drift", "stumps"])
def test_port_scheduler_equals_jax_scheduler(case):
    if case == "stumps":
        shapes = [{"m": 64, "k": 2, "noise": 1},
                  {"m": 80, "k": 2, "noise": 2}]
        common = STUMP_COMMON
    else:
        shapes, common = SHAPES, COMMON
    n = 12
    arrivals = S.poisson_trace(n, rate_per_s=200.0, seed=4)
    jreqs = J.make_request_stream(n, arrivals, shapes, seed0=60, **common)
    reqs = S.make_request_stream(n, arrivals, shapes, seed0=60, **common)
    jl = J.BucketLattice(b_sizes=(4,), mloc_sizes=(32, 48, 64))
    jdone = J.BoostScheduler(lattice=jl, policy="fill",
                             fill_wait_s=10.0).run_stream(jreqs)
    with _sched(lattice=S.BucketLattice(b_sizes=(2, 4),
                                        mloc_sizes=(32, 48, 64))) as sched:
        done = sched.run_stream(reqs)
    want = {c.request.rid: _lane(c) for c in jdone}
    got = {c.request.rid: _lane(c) for c in done}
    assert set(got) == set(want) == set(range(n))
    for rid in range(n):
        assert got[rid] == want[rid], rid
    assert sum(v["ok"] for v in got.values()) >= n // 2


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

STREAM_ARGS = ["--workload", "serve-stream", "--requests", "6", "--m", "64",
               "--k", "2", "--coreset", "32", "--opt-budget", "6",
               "--trace", "bursty", "--burst", "3", "--policy", "fill",
               "--no-warmup"]


def test_serve_stream_cli_prints_the_reference_keys(tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", *STREAM_ARGS, "--preempt", "0:2", "--ckpt-dir",
         str(tmp_path / "ck"), "--trace-out", str(trace),
         "--metrics-out", str(metrics)], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["ok"] == out["requests"] == out["served"] == 6
    assert (out["preemptions"], out["resumes"]) == (1, 1)
    assert out["device"] == "cpu"
    assert out["kernel_launches"] == {"mw_update": 0, "histogram": 0}
    assert os.listdir(tmp_path / "ck") == []
    spans = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"dispatch", "compile", "run_rounds", "finalize", "preempt",
            "resume", "ckpt_save", "ckpt_write", "ckpt_restore"} <= spans
    names = set(json.loads(metrics.read_text()))
    assert {"scheduler.dispatches", "scheduler.preemptions",
            "scheduler.compile_cache.compiles", "ckpt.save_s",
            "ckpt.restore_s"} <= names
    # the JAX CLI's keys on the same argv, plus the port's two
    j_args = j_serve.build_parser().parse_args(STREAM_ARGS)
    ref = j_serve.run_serve_stream(j_args)
    capsys.readouterr()
    assert set(out) == set(ref) | {"device", "kernel_launches"}
    assert set(out["buckets"]) <= {f"B{b}_mloc{m}_batched"
                                   for b in (1, 4, 8)
                                   for m in (16, 32, 64)}


def test_serve_stream_sharded_validates_every_ok_lane():
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--engine", "sharded", *STREAM_ARGS])
    out, done, sched = serve.run_serve_stream(args)
    sched.close()
    assert out["ledger_validated"] == out["ok"] == 6
    assert all(c.result.backend == "gloo" for c in done)


@pytest.mark.parametrize("flags,msg", [
    (["--m", "66"], "multiple of 2"),
    (["--scenario", "dropout"], "infrastructure adversary"),
    (["--chunk-size", "16"], "--chunk-size"),
])
def test_serve_stream_refuses_what_the_reference_refuses(flags, msg):
    args = serve.build_parser().parse_args(
        ["--device", "cpu", *STREAM_ARGS, *flags])
    with pytest.raises(SystemExit, match=msg):
        serve.run_serve_stream(args)
