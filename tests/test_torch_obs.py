"""The port's observability (``repro_torch.obs``) against the
reference's.

* Every case of tests/test_obs.py: the disabled fast path, span args,
  Chrome-trace export, deterministic histogram quantiles, registry
  discipline, a round span interrupted mid-protocol, a resumed run that
  does not count twice, dropout rounds' zero-bit ``dead_players``
  events, and a validator that bites.
* ``trace_rounds`` on the port's batched and sharded engines (with a
  dropout schedule) emits, round by round, the ``task_bits``,
  ``task_rounds``, ``task_attempts`` and ``players`` args that the JAX
  ``roundtrace`` emits on the same inputs, and ``validate_trace`` holds
  them to the ledger bit for bit.
* The engines' and the host loop's spans carry the reference's names
  and categories; the host loop's attempt spans validate against its
  ledger; ``device_trace`` writes a profiler trace with the
  ``run_rounds`` region.
"""

import json
import os
import tempfile
import time

import jax
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import batched as j_batched
from repro.core import sharded_batched as j_sharded
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro.obs import roundtrace as j_roundtrace
from repro.obs import trace as j_trace
from repro_torch.ckpt import msgpack_ckpt
from repro_torch.core import batched, classify, prng, sharded_batched, tasks
from repro_torch.core import weak
from repro_torch.core.types import BoostConfig
from repro_torch.obs import metrics as M
from repro_torch.obs import roundtrace
from repro_torch.obs import trace as T

torch.set_num_threads(1)

B, K, MLOC = 2, 2, 64
N_DOMAIN = 1 << 10
CFG_KW = dict(k=K, coreset_size=32, domain_size=N_DOMAIN, opt_budget=8)

# player 0 sits out wire round 1 (canon_player_sched extends the last row)
MASK_SCHED = np.ones((4, K), bool)
MASK_SCHED[1, 0] = False


def _problem(seed0=11):
    cls = weak.make_class("thresholds", n=N_DOMAIN)
    cfg = BoostConfig(**CFG_KW)
    x, y, _ = tasks.make_batch(cls, B, MLOC, K, 3, seed0=seed0)
    return cls, cfg, x, y, prng.split(prng.key(3), B)


def _step(x, y, cfg, cls, player_sched=None):
    return lambda s: batched.run_rounds(s, x, y, cfg, cls, n=1,
                                        player_sched=player_sched)


def _traced_to_completion(player_sched=None, seed0=11):
    cls, cfg, x, y, keys = _problem(seed0)
    rec = T.TraceRecorder()
    st = batched.init_state(x, y, keys, cfg, cls=cls, device="cpu")
    st = roundtrace.trace_rounds(_step(x, y, cfg, cls, player_sched),
                                 st, cfg, cls, recorder=rec)
    res = batched.finalize(st, x, y, np.ones(y.shape, bool), cfg, cls)
    return rec, res


@pytest.fixture(scope="module")
def group():
    with sharded_batched.make_players_group(K, "cpu") as g:
        yield g


# ---------------------------------------------------------------------------
# instrument units: trace
# ---------------------------------------------------------------------------

def test_disabled_tracing_is_shared_noop():
    assert not T.enabled()
    sp = T.span("anything", "protocol", x=1)
    assert sp is T.span("other")
    with sp as s:
        s.update(ignored=True)
    T.instant("nothing")
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            T.span("run_rounds"):
        pass
    assert "run_rounds" not in {e.key for e in prof.key_averages()}
    assert T.active() is None


def test_recording_scope_and_span_args(tmp_path):
    with T.recording() as rec:
        assert T.enabled() and T.active() is rec
        with T.span("work", "engine", engine="batched") as sp:
            sp.update(rounds=3)
        T.instant("mark", "engine", task=0)
    assert not T.enabled()
    ev = {e["name"]: e for e in rec.events}
    assert ev["work"]["ph"] == "X"
    assert ev["work"]["cat"] == "engine"
    assert ev["work"]["dur"] >= 0.0
    assert ev["work"]["args"] == {"engine": "batched", "rounds": 3}
    assert ev["mark"]["ph"] == "i"
    out = os.path.join(tmp_path, "trace.json")
    rec.save(out)
    with open(out, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["displayTimeUnit"] == "ms"
    assert doc["traceEvents"] == rec.events


def test_span_is_a_profiler_range_on_the_profiler_clock():
    """A span under a recorder is also a profiler range of its name, and
    its recorder ``ts`` is the range's ``ts + baseTimeNanoseconds/1000``
    (Unix µs) within 1 ms: a ``--trace-out`` file lines up with a
    capture of the same process."""
    with T.recording() as rec:
        with T.span("warm"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(5):
                with T.span("ranged", "model"):
                    torch.ones(8).sum()
                time.sleep(0.002)
    doc = _chrome_trace(prof)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    ranges = sorted(e["ts"] + base_us for e in doc["traceEvents"]
                    if e.get("name") == "ranged" and e.get("ph") == "X")
    spans = [e["ts"] for e in rec.events if e["name"] == "ranged"]
    assert len(ranges) == len(spans) == 5
    gaps = sorted(abs(a - b) for a, b in zip(ranges, spans))
    assert gaps[2] < 1e3, gaps
    assert abs(spans[0] - time.time_ns() / 1e3) < 60e6


def _chrome_trace(prof) -> dict:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            return json.load(f)


def test_span_records_event_even_when_body_raises():
    rec = T.TraceRecorder()
    with pytest.raises(RuntimeError):
        with rec.span("interrupted", "protocol"):
            raise RuntimeError("preempted")
    assert [e["name"] for e in rec.events] == ["interrupted"]
    assert rec.events[0]["ph"] == "X"


def test_ledger_bits_covers_every_category():
    import types as pytypes
    led = pytypes.SimpleNamespace(
        **{field: i for i, field in
           enumerate(T.CATEGORY_FIELDS.values(), start=1)})
    bits = T.ledger_bits(led)
    assert set(bits) == set(T.CATEGORY_FIELDS)
    assert sorted(bits.values()) == list(
        range(1, len(T.CATEGORY_FIELDS) + 1))
    assert T.CATEGORY_FIELDS == j_trace.CATEGORY_FIELDS


# ---------------------------------------------------------------------------
# instrument units: metrics
# ---------------------------------------------------------------------------

def test_histogram_quantiles_are_deterministic():
    h = M.Histogram("t", buckets=(1.0, 2.0, 4.0))
    assert h.quantile(0.5) == 0.0
    for v in (0.5,) * 50 + (3.0,) * 50:
        h.observe(v)
    assert h.count == 100
    assert h.sum == pytest.approx(175.0)
    assert 0.0 < h.quantile(0.25) <= 1.0
    assert 2.0 < h.quantile(0.99) <= 4.0
    assert h.quantile(0.25) <= h.quantile(0.5) <= h.quantile(0.99)
    with pytest.raises(ValueError):
        h.quantile(1.5)
    d = h.to_dict()
    assert d["type"] == "histogram" and "p50" in d and "p99" in d


def test_histogram_rejects_unsorted_buckets():
    with pytest.raises(ValueError):
        M.Histogram("bad", buckets=(2.0, 1.0))


def test_registry_get_or_create_and_kind_discipline(tmp_path):
    reg = M.MetricsRegistry()
    c = reg.counter("a.count")
    c.inc()
    assert reg.counter("a.count") is c
    assert reg.counter("a.count").value == 1
    reg.gauge("a.gauge").set(2.5)
    reg.histogram("a.lat").observe(0.01)
    with pytest.raises(TypeError):
        reg.gauge("a.count")
    assert reg.names() == ["a.count", "a.gauge", "a.lat"]
    out = os.path.join(tmp_path, "metrics.json")
    reg.save(out)
    with open(out, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["a.count"] == {"type": "counter", "value": 1}
    assert doc["a.gauge"]["value"] == 2.5


def test_default_registry_reset_isolation():
    reg = M.default_registry()
    assert M.default_registry() is reg
    fresh = M.reset_default_registry()
    assert fresh is not reg
    assert M.default_registry() is fresh


def test_checkpoints_publish_their_timings(tmp_path):
    reg = M.reset_default_registry()
    path = str(tmp_path / "c.msgpack")
    msgpack_ckpt.save_pytree(path, {"a": torch.zeros(3)})
    msgpack_ckpt.restore_pytree(path, device="cpu")
    out = reg.to_dict()
    assert out["ckpt.saves"]["value"] == 1
    assert out["ckpt.restores"]["value"] == 1
    assert out["ckpt.save_s"]["count"] == out["ckpt.restore_s"]["count"] == 1


# ---------------------------------------------------------------------------
# fault integrity
# ---------------------------------------------------------------------------

def test_round_span_closes_when_step_preempted_mid_protocol():
    cls, cfg, x, y, keys = _problem()
    st = batched.init_state(x, y, keys, cfg, cls=cls, device="cpu")
    calls = {"n": 0}

    def step(s):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("dispatch preempted")
        return batched.run_rounds(s, x, y, cfg, cls, n=1)

    rec = T.TraceRecorder()
    with pytest.raises(RuntimeError, match="preempted"):
        roundtrace.trace_rounds(step, st, cfg, cls, recorder=rec)
    rounds = [e for e in rec.events if e["name"] == "round"]
    assert len(rounds) == 2
    assert all(e["ph"] == "X" for e in rounds)
    assert "task_bits" in rounds[0]["args"]


def test_resumed_run_does_not_double_count(tmp_path):
    cls, cfg, x, y, keys = _problem(seed0=21)
    step = _step(x, y, cfg, cls)
    path = os.path.join(tmp_path, "preempt.msgpack")

    rec_a = T.TraceRecorder()
    st = batched.init_state(x, y, keys, cfg, cls=cls, device="cpu")
    st = roundtrace.trace_rounds(step, st, cfg, cls, recorder=rec_a,
                                 max_rounds=2)
    msgpack_ckpt.save_pytree(path, st, treedef=batched.STATE_TREEDEF)
    del st

    restored, _meta = msgpack_ckpt.restore_pytree(path, device="cpu")
    rec_b = T.TraceRecorder()
    restored = roundtrace.trace_rounds(step, restored, cfg, cls,
                                       recorder=rec_b)
    res = batched.finalize(restored, x, y, np.ones(y.shape, bool), cfg,
                           cls)

    assert rec_a.events and rec_b.events
    merged = rec_a.events + rec_b.events
    ledgers = {b: res.ledger(b) for b in range(B)}
    rep = roundtrace.validate_trace(merged, ledgers)
    for b in range(B):
        assert rep[b]["traced"]["rounds"] == int(res.ledger(b).rounds)
    with pytest.raises(AssertionError):
        roundtrace.validate_trace(rec_a.events, ledgers)
    with pytest.raises(AssertionError):
        roundtrace.validate_trace(rec_b.events, ledgers)


def test_dropout_rounds_emit_zero_bit_dead_player_events():
    rec, res = _traced_to_completion(player_sched=MASK_SCHED)
    roundtrace.validate_trace(rec, {b: res.ledger(b) for b in range(B)})
    dead = [e for e in rec.events if e["name"] == "dead_players"]
    assert dead
    for e in dead:
        assert e["ph"] == "i"
        assert e["args"]["bits"] == 0
        assert e["args"]["players_dead"] >= 1
        assert (e["args"]["players_alive"]
                + e["args"]["players_dead"]) == K


def test_validate_trace_detects_tampering():
    rec, res = _traced_to_completion()
    ledgers = {b: res.ledger(b) for b in range(B)}
    roundtrace.validate_trace(rec, ledgers)

    events = json.loads(json.dumps(rec.events))
    victim = next(e for e in events
                  if (e.get("args") or {}).get("task_bits"))
    task, bits = next(iter(victim["args"]["task_bits"].items()))
    cat = next((c for c, v in bits.items() if v), "ws")
    bits[cat] += 1
    with pytest.raises(AssertionError, match=f"task {task} {cat}"):
        roundtrace.validate_trace(events, ledgers)

    idx = next(i for i, e in enumerate(rec.events)
               if (e.get("args") or {}).get("task_bits"))
    dropped = rec.events[:idx] + rec.events[idx + 1:]
    with pytest.raises(AssertionError):
        roundtrace.validate_trace(dropped, ledgers)


def test_validate_trace_rejects_unknown_tasks():
    rec, res = _traced_to_completion()
    rec.instant("bogus", task_bits={"99": {"ws": 1}})
    with pytest.raises(AssertionError, match="unknown tasks"):
        roundtrace.validate_trace(rec, {b: res.ledger(b)
                                        for b in range(B)})


# ---------------------------------------------------------------------------
# trace_rounds against the JAX roundtrace, on both engines
# ---------------------------------------------------------------------------

def _round_args(events):
    return [{k: e["args"].get(k) for k in ("task_bits", "task_rounds",
                                           "task_attempts", "players")}
            for e in events if e["name"] == "round"]


def _instants(events):
    return [(e["name"], e["args"]) for e in events if e["ph"] == "i"]


@pytest.mark.parametrize("engine", ["batched", "sharded"])
@pytest.mark.parametrize("sched", [None, "dropout"])
def test_trace_rounds_equal_jax_roundtrace(engine, sched, group):
    jcls = j_weak.make_class("thresholds", n=N_DOMAIN)
    cls = weak.make_class("thresholds", n=N_DOMAIN)
    jcfg, cfg = JConfig(**CFG_KW), BoostConfig(**CFG_KW)
    x, y, _ = j_tasks.make_batch(jcls, B, MLOC, K, 3, seed0=11)
    jkeys = jax.random.split(jax.random.key(3), B)
    keys = prng.split(prng.key(3), B)
    ps = MASK_SCHED if sched else None
    j_rec, rec = j_trace.TraceRecorder(), T.TraceRecorder()
    if engine == "batched":
        jst = j_roundtrace.trace_rounds(
            lambda s: j_batched.run_rounds(s, x, y, jcfg, jcls, n=1,
                                           player_sched=ps),
            j_batched.init_state(x, y, jkeys, jcfg, cls=jcls), jcfg, jcls,
            recorder=j_rec)
        st = roundtrace.trace_rounds(
            _step(x, y, cfg, cls, ps),
            batched.init_state(x, y, keys, cfg, cls=cls, device="cpu"),
            cfg, cls, recorder=rec)
        res = batched.finalize(st, x, y, np.ones(y.shape, bool), cfg, cls)
        jres = j_batched.finalize(jst, x, y, np.ones(y.shape, bool), jcfg,
                                  jcls)
    else:
        jst = j_roundtrace.trace_rounds(
            lambda s: j_sharded.run_rounds_sharded(s, x, y, jcfg, jcls, n=1,
                                                   player_sched=ps),
            j_sharded.init_state_sharded(x, y, jkeys, jcfg, cls=jcls), jcfg,
            jcls, recorder=j_rec, engine="sharded")
        st = roundtrace.trace_rounds(
            lambda s: sharded_batched.run_rounds_sharded(
                s, x, y, cfg, cls, group=group, n=1, player_sched=ps),
            sharded_batched.init_state_sharded(x, y, keys, cfg, cls=cls,
                                               device="cpu"),
            cfg, cls, recorder=rec, engine="sharded")
        res = sharded_batched.finalize_sharded(
            st, x, y, np.ones(y.shape, bool), cfg, cls, group=group)
        jres = j_sharded.finalize_sharded(jst, x, y, np.ones(y.shape, bool),
                                          jcfg, jcls)
    got, want = _round_args(rec.events), _round_args(j_rec.events)
    assert len(got) == len(want) > 1
    assert got == want
    assert _instants(rec.events) == _instants(j_rec.events)
    if sched:
        assert any(n == "dead_players" for n, _ in _instants(rec.events))
    ledgers = {b: res.ledger(b) for b in range(B)}
    rep = roundtrace.validate_trace(rec, ledgers)
    assert rep == j_roundtrace.validate_trace(
        j_rec, {b: jres.ledger(b) for b in range(B)})
    if engine == "sharded":
        for b in range(B):
            if res.ok[b]:
                res.validate_ledger(b)


# ---------------------------------------------------------------------------
# the engines' and the host loop's spans
# ---------------------------------------------------------------------------

def test_engine_spans_carry_the_reference_names(group):
    cls, cfg, x, y, keys = _problem()
    with T.recording() as rec:
        batched.run_accurately_classify_batched(x, y, keys, cfg, cls,
                                                device="cpu")
        st = batched.init_state(x, y, keys, cfg, cls=cls, device="cpu")
        batched.run_rounds(st, x, y, cfg, cls, n=2)
        sharded_batched.run_accurately_classify_sharded(x, y, keys, cfg,
                                                        cls, group=group)
        prog = batched.lower_classify(x, y, None, keys, cfg, cls,
                                      device="cpu")
    got = [(e["name"], e["cat"], e["args"].get("engine"),
            e["args"].get("n")) for e in rec.events]
    assert got == [("run_rounds", "engine", "batched", -1),
                   ("finalize", "engine", "batched", None),
                   ("run_rounds", "engine", "batched", 2),
                   ("run_rounds", "engine", "sharded", -1),
                   ("finalize", "engine", "sharded", None),
                   ("compile", "compile", "batched", None)]
    assert rec.events[3]["args"]["mesh_devices"] == 1
    assert rec.events[-1]["args"] == {"engine": "batched", "B": B,
                                      "mloc": MLOC // K}
    assert isinstance(prog, batched.ClassifyProgram)


def test_host_loop_attempt_spans_validate_against_its_ledger():
    cls, cfg, x, y, _ = _problem(seed0=5)
    with T.recording() as rec:
        res = classify.run_accurately_classify(x[0], y[0], prng.key(9),
                                               cfg, cls, device="cpu")
    names = [e["name"] for e in rec.events]
    assert names.count("attempt") == res.attempts
    assert names.count("boost_attempt") == res.attempts
    assert names.count("quarantine") == res.attempts - 1
    roundtrace.validate_trace(rec, {0: res.ledger})


def test_device_trace_frames_the_run_rounds_region(tmp_path):
    cls, cfg, x, y, keys = _problem()
    st = batched.init_state(x, y, keys, cfg, cls=cls, device="cpu")
    with T.recording(), T.device_trace(str(tmp_path / "prof")) as prof:
        batched.run_rounds(st, x, y, cfg, cls, n=2)
    assert "run_rounds" in {e.key for e in prof.key_averages()}
    with open(tmp_path / "prof" / "trace.json", encoding="utf-8") as f:
        doc = json.load(f)
    assert any(e.get("name") == "run_rounds" for e in doc["traceEvents"])
