"""The port's sharded engine ≡ its batched engine ≡ the JAX sharded
engine, bit for bit — and the ledger ≡ the payloads its collectives
moved.

``repro_torch.core.sharded_batched`` runs the batched engine's step
over a ``torch.distributed`` players group.  In process the group is
one gloo rank over a ``HashStore`` (the collectives run over a group of
one), held to the port's batched engine and to
``repro.core.sharded_batched`` on a 1-device mesh on every field and
every wire counter: thresholds (tests/test_sharded_batched.py's case),
the §2.2 no-center model, HistogramTrees in its three wire modes, a
``targeted_heavy`` scenario and a dropout schedule.  ``validate_ledger``
passes on every finished task, and the collectives a run makes equal
``steps × collective_sites_per_round`` in every mode.  A subprocess
test forms a real 2-rank gloo world (two players per rank) and holds it
to the batched engine, and its histogram-mode tree run to the JAX
engine on a 2-device mesh.  The tree cases first probe that this
host's XLA sums the reference's histograms in the port's order (ROADMAP
queue 3), as tests/test_torch_feature_engine.py does.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import boost_attempt as j_boost
from repro.core import scenarios as j_scen
from repro.core import sharded_batched as j_sharded
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro_torch import convert
from repro_torch.core import batched, boost_attempt, ledger, prng
from repro_torch.core import scenarios, sharded_batched, weak
from repro_torch.core.types import BoostConfig
from repro_torch.launch import serve

from test_torch_batched import assert_task_parity
from test_torch_feature_engine import (TREE_B, TREE_CFG, TREE_KEY, TREE_M,
                                       TREE_NOISE, TREE_SEED,
                                       _probe_histogram_order, _tree_kw)

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

N = 1 << 12
THR_CFG = dict(k=4, coreset_size=24, domain_size=N, opt_budget=32)
STATE_FIELDS = ("hypotheses", "rounds", "ok", "attempts", "alive",
                "disputed", "hist_stuck", "hist_rounds", "hist_alive",
                "hist_p", "hist_players", "hist_players_h",
                "hist_players_last")
WIRE = ("hist_wire_core", "hist_wire_ws", "hist_wire_hist",
        "hist_wire_votes", "wire_bytes", "wire_q_points", "wire_q_counts")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def group():
    with sharded_batched.make_players_group(4, "cpu") as g:
        yield g


def assert_engines_equal(ref, got, wire: bool):
    """Every protocol field (min_loss within the feature track's
    rtol 1e-5 + atol 1e-6), every ledger, and the wire counters."""
    for f in STATE_FIELDS + (WIRE if wire else ()):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      np.asarray(getattr(got, f)), f)
    np.testing.assert_allclose(got.min_loss, np.asarray(ref.min_loss),
                               rtol=1e-5, atol=1e-6)
    for b in range(got.batch):
        assert dataclasses.asdict(ref.ledger(b)) == \
            dataclasses.asdict(got.ledger(b))


def assert_run_checks(got, cls, no_center=False):
    """validate_ledger on every finished task, and the census."""
    assert got.ok.any()
    for b in range(got.batch):
        if got.ok[b]:
            report = got.validate_ledger(b)
            assert report["collective_bytes"] > 0
            assert got.wire_summary(b)["mesh_devices"] == got.mesh_devices
    census = ledger.collective_sites_per_round(cls, no_center=no_center)
    assert got.collective_calls == {
        kind: n * got.steps for kind, n in census.items()}


def _three_engines(jcls, cls, cfg, x, y, key, B, group, no_center=False,
                   sched=None):
    jkeys = jax.random.split(jax.random.key(key), B)
    ref = j_sharded.run_accurately_classify_sharded(
        x, y, jkeys, JConfig(**cfg), jcls, no_center=no_center,
        player_sched=sched)
    got = sharded_batched.run_accurately_classify_sharded(
        x, y, prng.split(prng.key(key), B), BoostConfig(**cfg), cls,
        group=group, no_center=no_center, player_sched=sched)
    loc = batched.run_accurately_classify_batched(
        x, y, prng.split(prng.key(key), B), BoostConfig(**cfg), cls,
        player_sched=sched, device="cpu")
    assert (got.mesh_devices, got.backend) == (1, "gloo")
    assert_engines_equal(ref, got, wire=True)
    assert_engines_equal(loc, got, wire=False)
    assert got.steps == loc.steps
    assert_run_checks(got, cls, no_center)
    return ref, got


@pytest.mark.parametrize("no_center", [False, True])
def test_thresholds_equal_jax_sharded_and_batched(group, no_center):
    """tests/test_sharded_batched.py's case, and the §2.2 model."""
    jcls, cls = j_weak.Thresholds(n=N), weak.Thresholds(n=N)
    x, y, _ = j_tasks.make_batch(jcls, 2, 512, 4, 3, seed0=11)
    ref, got = _three_engines(jcls, cls, THR_CFG, x, y, 5, 2, group,
                              no_center=no_center)
    for b in range(2):
        assert got.wire_summary(b)["quarantine_point_msgs"] > 0
        assert_task_parity(ref.per_task(b), got.per_task(b))
        flat = x[b].reshape(-1)
        np.testing.assert_array_equal(
            np.asarray(ref.classifier(b)(jax.numpy.asarray(flat))),
            got.classifier(b)(torch.from_numpy(flat)).numpy())


@pytest.mark.parametrize("mode", ["coreset", "histogram", "voting"])
def test_trees_equal_jax_sharded_and_batched(group, mode):
    _probe_histogram_order(TREE_B, 4, 8)
    jcls = j_weak.make_class("tree", **_tree_kw(mode))
    cls = weak.make_class("tree", **_tree_kw(mode))
    x, y, _ = j_tasks.make_batch(jcls, TREE_B, TREE_M, TREE_CFG["k"],
                                 TREE_NOISE, seed0=TREE_SEED)
    _three_engines(jcls, cls, TREE_CFG, x, y, TREE_KEY, TREE_B, group)


def test_targeted_heavy_scenario(group):
    """tests/test_sharded_batched.py's scenario case: the adversary
    lives in the data; the reports hold E_S(f) ≤ OPT."""
    kw = dict(name="targeted_heavy", noise=8)
    jcls, cls = j_weak.Thresholds(n=N), weak.Thresholds(n=N)
    x, y, _ = j_scen.make_scenario_batch(jcls, 2, 512, 4,
                                         j_scen.ScenarioSpec(**kw), seed0=7)
    _, _, ts = scenarios.make_scenario_batch(
        cls, 2, 512, 4, scenarios.ScenarioSpec(**kw), seed0=7)
    _, got = _three_engines(jcls, cls, THR_CFG, x, y, 1, 2, group)
    for b in range(2):
        assert scenarios.scenario_report(ts[b], got, b,
                                         device="cpu")["guarantee_ok"]


def test_dropout_schedule_masks_the_wire(group):
    """Player 1 silent from round 5: the masked ledger, validated."""
    jcls, cls = j_weak.Thresholds(n=N), weak.Thresholds(n=N)
    x, y, _ = j_tasks.make_batch(jcls, 2, 512, 4, 3, seed0=11)
    sched = scenarios.InfraSpec(name="dropout", player=1,
                                drop_round=5).schedule(4)
    _, got = _three_engines(jcls, cls, THR_CFG, x, y, 5, 2, group,
                            sched=sched)
    assert (got.hist_wire_ws < got.hist_rounds * 4).any()


def test_validate_ledger_refuses_a_payload_the_ledger_does_not_charge(
        group):
    """One gathered example more than the ledger charged, or one
    quarantine message less, and the check raises."""
    cls = weak.Thresholds(n=N)
    x, y, _ = j_tasks.make_batch(j_weak.Thresholds(n=N), 1, 512, 4, 3,
                                 seed0=11)
    res = sharded_batched.run_accurately_classify_sharded(
        x, y, prng.key(5), BoostConfig(**THR_CFG), cls, group=group)
    res.validate_ledger(0)
    for field, delta in (("hist_wire_core", 1), ("wire_q_points", -1)):
        bad = dataclasses.replace(res, **{field: getattr(res, field).copy()})
        getattr(bad, field).reshape(-1)[0] += delta
        with pytest.raises(AssertionError, match="measured payloads|"
                           "message pattern"):
            bad.validate_ledger(0)


def test_sliced_rounds_equal_one_run(group):
    """run_rounds_sharded in 7-round slices ≡ one run to completion."""
    cls = weak.Thresholds(n=N)
    cfg = BoostConfig(**THR_CFG)
    x, y, _ = j_tasks.make_batch(j_weak.Thresholds(n=N), 2, 512, 4, 3,
                                 seed0=11)
    s0 = sharded_batched.init_state_sharded(x, y, prng.key(5), cfg,
                                            cls=cls, device="cpu")
    whole = sharded_batched.run_rounds_sharded(s0, x, y, cfg, cls,
                                               group=group)
    s = s0
    for _ in range(40):
        s = sharded_batched.run_rounds_sharded(s, x, y, cfg, cls,
                                               group=group, n=7)
    assert set(s) == set(batched.StepState._fields) | set(
        sharded_batched.WIRE_FIELDS)
    for f in s:
        assert torch.equal(s[f], whole[f]), f


def test_state_carried_both_ways(group):
    """A JAX sharded state stopped after 9 rounds is finished by the
    port, and a port state by JAX: every field and counter equal."""
    jcls, cls = j_weak.Thresholds(n=N), weak.Thresholds(n=N)
    jcfg, cfg = JConfig(**THR_CFG), BoostConfig(**THR_CFG)
    x, y, _ = j_tasks.make_batch(jcls, 2, 512, 4, 3, seed0=11)
    alive0 = np.ones(x.shape, bool)
    mesh = j_sharded.make_players_mesh(4)
    js = j_sharded.init_state_sharded(
        x, y, jax.random.split(jax.random.key(5), 2), jcfg, cls=jcls)
    ref = j_sharded.finalize_sharded(
        j_sharded.run_rounds_sharded(js, x, y, jcfg, jcls, mesh=mesh),
        x, y, alive0, jcfg, jcls, mesh=mesh)
    js9 = jax.device_get(j_sharded.run_rounds_sharded(
        js, x, y, jcfg, jcls, mesh=mesh, n=9))
    ps = convert.from_jax_sharded(js9, device="cpu")
    got = sharded_batched.finalize_sharded(
        sharded_batched.run_rounds_sharded(ps, x, y, cfg, cls, group=group),
        x, y, alive0, cfg, cls, group=group)
    assert_engines_equal(ref, got, wire=True)
    ps9 = sharded_batched.run_rounds_sharded(
        sharded_batched.init_state_sharded(x, y, prng.split(prng.key(5), 2),
                                           cfg, cls=cls, device="cpu"),
        x, y, cfg, cls, group=group, n=9)
    leaves = convert.to_jax_sharded(ps9)
    assert set(leaves) == set(js)
    for f, dtype in j_sharded.STATE_DTYPES.items():
        assert leaves[f].dtype == np.dtype(dtype), f
    back = j_sharded.finalize_sharded(
        j_sharded.run_rounds_sharded(leaves, x, y, jcfg, jcls, mesh=mesh),
        x, y, alive0, jcfg, jcls, mesh=mesh)
    assert_engines_equal(back, got, wire=True)


@pytest.mark.parametrize("clsname,no_center,m,noise", [
    ("thresholds", False, 256, 3), ("thresholds", True, 256, 3),
    ("stumps", False, 512, 0)])
def test_boost_attempt_sharded_equals_jax(group, clsname, no_center, m,
                                          noise):
    """The single-attempt sharded form on one player (a 1-device
    ``data`` mesh in the reference): fold_in keys, the collectives, the
    gathered hits.  The stump case keeps its shard off mloc 250–300,
    where the reference's own sampled coreset names indices past the
    shard (ROADMAP queue 3)."""
    if clsname == "stumps":
        jcls, cls = j_weak.AxisStumps(num_features=4), weak.AxisStumps(
            num_features=4)
        kw = dict(k=1, coreset_size=64, domain_size=N, opt_budget=8,
                  deterministic_coreset=False)
    else:
        jcls, cls = j_weak.Thresholds(n=N), weak.Thresholds(n=N)
        kw = dict(THR_CFG, k=1)
    x, y, _ = j_tasks.make_batch(jcls, 1, m, 1, noise, seed0=13)
    x, y = x[0, 0], y[0, 0]
    alive = np.random.default_rng(1).random(m) < 0.9
    hits = np.random.default_rng(2).integers(0, 3, m).astype(np.int32)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    fn = j_boost.boost_attempt_sharded(mesh, JConfig(**kw), jcls, 30,
                                       no_center=no_center)
    ref = jax.device_get(jax.jit(fn)(x, y, alive, hits, jax.random.key(4)))
    got = boost_attempt.boost_attempt_sharded(
        group, BoostConfig(**kw), cls, 30, no_center=no_center)(
        x, y, alive, hits, prng.key(4))
    assert int(got[0]) == int(ref[0]) > 0 and bool(got[1]) == bool(ref[1])
    for g, r in zip(got[2:4], ref[2:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-5,
                               atol=1e-6)


def test_one_rank_sum_keeps_the_center_bits(group):
    """The no-center broadcast over one rank returns the center's value
    untouched, −0.0 included."""
    t = torch.tensor([-0.0, 1.5, -2.0, 0.0])
    out = group.psum(t)
    assert torch.equal(out, t)
    assert torch.equal(torch.signbit(out), torch.signbit(t))


def test_serve_engine_sharded_on_the_cpu():
    """serve --engine sharded: the reference's JSON keys, the ledger
    validated on every task, the protocol as the batched engine's."""
    argv = ["--workload", "classify", "--device", "cpu", "--batch", "3",
            "--m", "256", "--noise", "3"]
    parser = serve.build_parser()
    out, res, _, _ = serve.run_classify(parser.parse_args(
        argv + ["--engine", "sharded"]))
    ref, bres, _, _ = serve.run_classify(parser.parse_args(argv))
    assert out["ledger_vs_payload"] == f"validated_{out['ok']}/3"
    assert (out["mesh_devices"], out["backend"]) == (1, "gloo")
    assert out["collective_bytes_max"] == int(res.wire_bytes.max()) > 0
    assert out["collective_calls"] == {"all_gather": 3 * res.steps,
                                       "psum": res.steps}
    for f in ("ok", "attempts_max", "steps"):
        assert out[f] == ref[f], f
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(bres, f), f)


def test_players_group_refuses_a_size_that_does_not_divide_k():
    for k, p in [(3, 2), (4, 3), (5, 0)]:
        with pytest.raises(ValueError, match="must divide"):
            sharded_batched.players_per_rank(k, p)
    assert sharded_batched.players_per_rank(4, 2) == 2


_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
from repro_torch.core import prng, sharded_batched, tasks, weak
from repro_torch.core.types import BoostConfig
from repro_torch.launch import serve

results, meta = {}, {}
with sharded_batched.make_players_group(4, "cpu") as g:
    assert (g.size, g.rank, g.kloc) == (2, rank, 2)
    runs = {}
    cls = weak.Thresholds(n=4096)
    x, y, _ = tasks.make_batch(cls, 3, 256, 4, 3, seed0=11)
    for nc in (False, True):
        runs[f"thr_nc{int(nc)}"] = sharded_batched.run_accurately_classify_sharded(
            x, y, prng.split(prng.key(5), 3),
            BoostConfig(k=4, coreset_size=100, domain_size=4096,
                        opt_budget=16), cls, group=g, no_center=nc)
    tcls = weak.make_class("tree", num_features=4, tree_depth=2,
                           tree_bins=8, tree_comm_mode="histogram")
    tx, ty, _ = tasks.make_batch(tcls, 2, 256, 4, 2, seed0=3)
    runs["tree"] = sharded_batched.run_accurately_classify_sharded(
        tx, ty, prng.split(prng.key(5), 2),
        BoostConfig(k=4, coreset_size=100, domain_size=4096, opt_budget=16,
                    deterministic_coreset=False), tcls, group=g)
    for name, res in runs.items():
        for b in range(res.batch):
            if res.ok[b]:
                res.validate_ledger(b)
        for f in FIELDS:
            results[f"{name}/{f}"] = np.asarray(getattr(res, f))
        meta[name] = dict(steps=res.steps, calls=res.collective_calls,
                          mesh_devices=res.mesh_devices,
                          backend=res.backend)
    try:
        with sharded_batched.make_players_group(3, "cpu"):
            pass
    except ValueError as e:
        meta["refused"] = str(e)
    args = serve.build_parser().parse_args(
        ["--workload", "classify", "--engine", "sharded", "--device", "cpu",
         "--batch", "2", "--m", "256", "--noise", "3"])
    meta["serve"] = serve.run_classify(args)[0]
if rank == 0:
    np.savez(out + ".npz", **results)
    with open(out + ".json", "w") as f:
        json.dump(meta, f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""

_JAX2 = r"""
import sys
import numpy as np
import jax
assert jax.device_count() == 2, jax.devices()
from repro.core import sharded_batched, tasks, weak
from repro.core.types import BoostConfig

out = sys.argv[1]
mesh = sharded_batched.make_players_mesh(4)
assert mesh.shape["players"] == 2
cls = weak.make_class("tree", num_features=4, tree_depth=2, tree_bins=8,
                      tree_comm_mode="histogram")
x, y, _ = tasks.make_batch(cls, 2, 256, 4, 2, seed0=3)
res = sharded_batched.run_accurately_classify_sharded(
    x, y, jax.random.split(jax.random.key(5), 2),
    BoostConfig(k=4, coreset_size=100, domain_size=4096, opt_budget=16,
                deterministic_coreset=False), cls, mesh=mesh)
np.savez(out, **{f: np.asarray(getattr(res, f)) for f in FIELDS})
print("JAX2_OK")
"""


@pytest.mark.xdist_group(name="device_mesh_subprocess")
def test_two_gloo_ranks_equal_batched_and_jax_two_device_mesh(tmp_path):
    """A real 2-rank world, two players per rank: thresholds (with and
    without a center) and a histogram-mode tree equal the batched
    engine on every field, with the ledger validated; the tree run
    equals the JAX engine on a 2-device mesh, wire counters included;
    a group of 2 ranks refuses k = 3; serve runs in the world."""
    _probe_histogram_order(2, 4, 8)
    fields = repr(STATE_FIELDS + WIRE + ("min_loss",))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    jax_env = dict(env, XLA_FLAGS=env.get("XLA_FLAGS", "")
                   + " --xla_force_host_platform_device_count=2")
    out = str(tmp_path / "rank0")
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"FIELDS = {fields}\n" + _RANK, str(r),
         str(tmp_path / "store"), out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", f"FIELDS = {fields}\n" + _JAX2,
         str(tmp_path / "jax2.npz")], env=jax_env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-4000:]
    got = np.load(out + ".npz")
    with open(out + ".json") as f:
        meta = json.load(f)
    assert "must divide k=3" in meta["refused"]
    serve_out = meta["serve"]
    assert serve_out["mesh_devices"] == 2 and serve_out["backend"] == "gloo"
    assert serve_out["ledger_vs_payload"] == \
        f"validated_{serve_out['ok']}/2"
    # against the batched engine, in this process
    thr = weak.Thresholds(n=N)
    x, y, _ = j_tasks.make_batch(j_weak.Thresholds(n=N), 3, 256, 4, 3,
                                 seed0=11)
    loc = batched.run_accurately_classify_batched(
        x, y, prng.split(prng.key(5), 3),
        BoostConfig(k=4, coreset_size=100, domain_size=N, opt_budget=16),
        thr, device="cpu")
    tcls = weak.make_class("tree", **_tree_kw("histogram"))
    tx, ty, _ = j_tasks.make_batch(j_weak.make_class(
        "tree", **_tree_kw("histogram")), 2, 256, 4, 2, seed0=3)
    tloc = batched.run_accurately_classify_batched(
        tx, ty, prng.split(prng.key(5), 2), BoostConfig(**TREE_CFG), tcls,
        device="cpu")
    jax2 = np.load(tmp_path / "jax2.npz")
    for name, ref, cls in [("thr_nc0", loc, thr), ("thr_nc1", loc, thr),
                           ("tree", tloc, tcls)]:
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(got[f"{name}/{f}"],
                                          getattr(ref, f), (name, f))
        m = meta[name]
        assert (m["mesh_devices"], m["backend"], m["steps"]) == \
            (2, "gloo", ref.steps), name
        census = ledger.collective_sites_per_round(
            cls, no_center=name == "thr_nc1")
        assert m["calls"] == {k: n * ref.steps for k, n in census.items()}
    for f in STATE_FIELDS + WIRE:
        np.testing.assert_array_equal(got[f"tree/{f}"], jax2[f], f)
    np.testing.assert_allclose(got["tree/min_loss"], jax2["min_loss"],
                               rtol=1e-5, atol=1e-6)
