"""The port's checkpoints (``repro_torch.ckpt``) against the reference's.

* The codec: ``repro_torch.ckpt.codec`` writes what ``msgpack.packb``
  writes, byte for byte, and reads it back as ``msgpack.unpackb`` does,
  on payloads with ints at every width boundary, floats, nil, bools,
  nested maps, arrays, bin of 0, 255, 256 and 65536 bytes and str.
* Every case of tests/test_checkpointing.py on the port's engines and
  trees (template-free restores of the batched, tree and sharded
  states, loud shape/dtype/key mismatches, owned arrays, fsync order,
  crash mid-write, corrupt files, incremental chains, the async writer,
  the manager), and tests/test_fault_tolerance.py's checkpoint cases
  (resume bit-identical on both engines and both distributed tree
  modes; a shape mismatch fails loudly).
* Across packages: a file the JAX package wrote mid-run is finished by
  the port (``load_pytree`` + ``convert.from_jax``) equal to the JAX
  engine's uninterrupted run, and a file the port wrote mid-run is read
  by the JAX ``load_pytree`` with ``convert.to_jax``'s leaves and
  finished by the JAX engine equal to its uninterrupted run — on the
  batched engine and on the sharded one.
"""

import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import msgpack_ckpt as j_ckpt
from repro.core import batched as j_batched
from repro.core import sharded_batched as j_sharded
from repro.core import weak as j_weak
from repro.core.types import BoostConfig as JConfig
from repro_torch import convert
from repro_torch.ckpt import codec, msgpack_ckpt
from repro_torch.core import (batched, prng, scenarios, sharded_batched,
                              tasks, weak)
from repro_torch.core.types import BoostConfig
from repro_torch.weak_tree import HistogramTrees

from test_torch_batched import assert_results_equal

torch.set_num_threads(1)

N = 1 << 10
CLS = weak.Thresholds(n=N)
CFG_KW = dict(k=4, coreset_size=32, domain_size=N, opt_budget=4)
CFG = BoostConfig(**CFG_KW)
WIRE = ("hist_wire_core", "hist_wire_ws", "hist_wire_hist",
        "hist_wire_votes", "wire_bytes", "wire_q_points", "wire_q_counts")


def _assert_trees_equal(a, b):
    la = list(msgpack_ckpt._iter_leaves(a))
    lb = list(msgpack_ckpt._iter_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.is_tensor(x) == torch.is_tensor(y), p
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg=str(p))


@pytest.fixture(scope="module")
def batched_state():
    x, y, _ = tasks.make_batch(CLS, 2, 64, 4, 1, seed0=7)
    keys = prng.split(prng.key(2), 2)
    st = batched.init_state(x, y, keys, CFG, device="cpu")
    st = batched.run_rounds(st, x, y, CFG, CLS, n=3)
    return st, (x, y, CFG, CLS)


@pytest.fixture(scope="module")
def group():
    with sharded_batched.make_players_group(4, "cpu") as g:
        yield g


# ---------------------------------------------------------------------------
# The codec against msgpack
# ---------------------------------------------------------------------------

_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
         2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129, -2 ** 15,
         -2 ** 15 - 1, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
PAYLOADS = {
    "ints": _INTS,
    "floats": [0.0, -0.0, 1.5, -2.25e-300, 1e308, float("inf"),
               float("-inf")],
    "nil_bools": [None, True, False, {"a": None, "b": True}],
    "nested_maps": {"a": {"b": {"c": [1, {"d": b""}], "e": -7}},
                    "f": {str(i): i for i in range(20)}},
    "bin": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65535,
            b"\x03" * 65536],
    "str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
            "ü" * 1],
    "arrays": [list(range(15)), list(range(16)), list(range(70000)),
               (1, 2)],
    "big_map": {str(i): i for i in range(70000)},
    "checkpoint": {"__meta__": {"rounds_done": 3, "rids": [1, 2]},
                   "__format__": 2, "__treedef__": None, "__base__": None,
                   "__hashes__": {"a": "0" * 32},
                   "arrays": {"a": {"dtype": "int32", "shape": [2, 3],
                                    "data": bytes(24)}}},
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_codec_is_byte_equal_to_msgpack(name):
    payload = PAYLOADS[name]
    blob = codec.packb(payload)
    assert blob == msgpack.packb(payload)
    back = msgpack.unpackb(blob, strict_map_key=False)
    assert codec.unpackb(blob) == back
    assert codec.packb(back) == blob


def test_codec_refuses_what_is_outside_the_format():
    with pytest.raises(TypeError):
        codec.packb({1, 2})
    with pytest.raises(TypeError):
        codec.packb(np.int64(3))         # msgpack refuses it too
    with pytest.raises(OverflowError):
        codec.packb(2 ** 64)
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError, match="trailing"):
        codec.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="subset"):
        codec.unpackb(b"\xd4\x01\x00")   # fixext 1


def test_port_checkpoint_file_is_msgpack(tmp_path, batched_state):
    """A whole checkpoint file is what msgpack would write for the
    payload msgpack reads out of it."""
    state, _ = batched_state
    path = str(tmp_path / "s.msgpack")
    msgpack_ckpt.save_pytree(path, state, meta={"rounds_done": 3},
                             treedef=batched.STATE_TREEDEF)
    with open(path, "rb") as f:
        blob = f.read()
    payload = msgpack.unpackb(blob)
    assert msgpack.packb(payload) == blob
    assert payload["__format__"] == 2
    assert payload["__treedef__"] == batched.STATE_TREEDEF
    assert payload["arrays"]["key_data"]["dtype"] == "uint32"
    assert set(payload["__hashes__"]) == set(batched.StepState._fields)


# ---------------------------------------------------------------------------
# Template-free round trips (both engines, thresholds + trees)
# ---------------------------------------------------------------------------

def test_roundtrip_batched_template_free(tmp_path, batched_state):
    state, _ = batched_state
    path = str(tmp_path / "s.msgpack")
    msgpack_ckpt.save_pytree(path, state, meta={"rounds_done": 3},
                             treedef=batched.STATE_TREEDEF)
    restored, meta = msgpack_ckpt.restore_pytree(path, device="cpu")
    assert isinstance(restored, batched.StepState)
    assert meta["rounds_done"] == 3
    _assert_trees_equal(state, restored)
    via_like, _ = msgpack_ckpt.load_pytree(path, like=state)
    _assert_trees_equal(restored, via_like)


def test_roundtrip_batched_trees(tmp_path):
    cls = HistogramTrees(num_features=4, depth=2, bins=8)
    cfg = BoostConfig(k=4, coreset_size=32,
                      domain_size=1 << min(cls.value_bits, 30),
                      opt_budget=4, deterministic_coreset=False)
    spec = scenarios.ScenarioSpec(name="xor", noise=2)
    ts = [scenarios.make_feature_task(cls, m=64, k=4, spec=spec, seed=s)
          for s in range(2)]
    x = np.stack([t.x for t in ts])
    y = np.stack([t.y for t in ts])
    st = batched.init_state(x, y, prng.split(prng.key(3), 2), cfg, cls=cls,
                            device="cpu")
    st = batched.run_rounds(st, x, y, cfg, cls, n=2)
    path = str(tmp_path / "t.msgpack")
    msgpack_ckpt.save_pytree(path, st, treedef=batched.STATE_TREEDEF)
    restored, _ = msgpack_ckpt.restore_pytree(path, device="cpu")
    assert isinstance(restored, batched.StepState)
    assert restored.core_x.dtype == torch.float32
    _assert_trees_equal(st, restored)


def test_roundtrip_sharded_template_free(tmp_path, group):
    x, y, _ = tasks.make_batch(CLS, 2, 64, 4, 1, seed0=9)
    st = sharded_batched.init_state_sharded(
        x, y, prng.split(prng.key(4), 2), CFG, cls=CLS, device="cpu")
    st = sharded_batched.run_rounds_sharded(st, x, y, CFG, CLS,
                                            group=group, n=2)
    path = str(tmp_path / "sh.msgpack")
    msgpack_ckpt.save_pytree(path, st,
                             treedef=sharded_batched.STATE_TREEDEF)
    restored, _ = msgpack_ckpt.restore_pytree(path, device="cpu")
    assert isinstance(restored, dict) and set(restored) == set(st)
    for k in st:
        assert restored[k].dtype == st[k].dtype, k
        assert torch.equal(restored[k], st[k]), k


def test_template_free_rejects_dtype_drift(tmp_path, batched_state):
    state, _ = batched_state
    bad = state._replace(hits=state.hits.long())
    path = str(tmp_path / "bad.msgpack")
    msgpack_ckpt.save_pytree(path, bad, treedef=batched.STATE_TREEDEF)
    with pytest.raises(ValueError, match="dtype"):
        msgpack_ckpt.restore_pytree(path, device="cpu")


def test_unregistered_treedef_raises(tmp_path):
    path = str(tmp_path / "u.msgpack")
    msgpack_ckpt.save_pytree(path, {"a": np.zeros(2, np.int32)},
                             treedef="no.such.treedef")
    with pytest.raises(KeyError, match="not registered"):
        msgpack_ckpt.restore_pytree(path, device="cpu")


def test_key_words_outside_uint32_are_refused(tmp_path, batched_state):
    """The int64 key words go to disk as uint32; a value that would wrap
    is refused, not cast."""
    state, _ = batched_state
    bad = state._replace(key_data=state.key_data - (1 << 40))
    with pytest.raises(ValueError, match="wrapping"):
        msgpack_ckpt.save_pytree(str(tmp_path / "k.msgpack"), bad,
                                 treedef=batched.STATE_TREEDEF)


# ---------------------------------------------------------------------------
# Loud mismatches + owned arrays
# ---------------------------------------------------------------------------

def test_load_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "c.msgpack")
    msgpack_ckpt.save_pytree(path, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        msgpack_ckpt.load_pytree(path, like={"a": torch.zeros(5)})


def test_load_dtype_mismatch_raises_not_casts(tmp_path):
    path = str(tmp_path / "c.msgpack")
    msgpack_ckpt.save_pytree(path, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="dtype"):
        msgpack_ckpt.load_pytree(
            path, like={"a": torch.zeros(4, dtype=torch.float64)})


def test_load_missing_key_raises(tmp_path):
    path = str(tmp_path / "c.msgpack")
    msgpack_ckpt.save_pytree(path, {"a": np.zeros(4, np.float32)})
    with pytest.raises(KeyError, match="missing"):
        msgpack_ckpt.load_pytree(path, like={"a": np.zeros(4, np.float32),
                                             "b": np.zeros(1, np.int32)})


def test_loaded_arrays_are_owned_and_writable(tmp_path):
    path = str(tmp_path / "c.msgpack")
    msgpack_ckpt.save_pytree(path, {"a": torch.arange(6, dtype=torch.int32)})
    arrays, _ = msgpack_ckpt.load_pytree(path)
    assert arrays["a"].flags.writeable
    arrays["a"] += 1
    np.testing.assert_array_equal(arrays["a"], np.arange(1, 7))


def test_save_takes_an_owned_copy_of_cpu_tensors(tmp_path):
    """A tensor updated in place after ``save`` returns does not change
    what the async writer writes."""
    w = msgpack_ckpt.AsyncCheckpointer()
    t = torch.zeros(1 << 16, dtype=torch.int32)
    path = str(tmp_path / "o.msgpack")
    w.save(path, {"t": t})
    t += 7
    w.wait()
    w.close()
    got, _ = msgpack_ckpt.load_pytree(path)
    assert not got["t"].any()


# ---------------------------------------------------------------------------
# Durable atomic writes
# ---------------------------------------------------------------------------

def test_fsync_before_publish_then_dir(tmp_path, monkeypatch):
    events = []
    real_fsync, real_replace = os.fsync, os.replace

    def spy_fsync(fd):
        events.append("fsync")
        return real_fsync(fd)

    def spy_replace(src, dst):
        events.append("replace")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "fsync", spy_fsync)
    monkeypatch.setattr(os, "replace", spy_replace)
    msgpack_ckpt.save_pytree(str(tmp_path / "c.msgpack"),
                             {"a": torch.ones(2)})
    assert events == ["fsync", "replace", "fsync"]


@pytest.mark.parametrize("crash_at", ["fsync", "replace"])
def test_crash_mid_write_preserves_previous(tmp_path, monkeypatch,
                                            crash_at):
    path = str(tmp_path / "c.msgpack")
    first = {"a": np.arange(4, dtype=np.int32)}
    msgpack_ckpt.save_pytree(path, first)

    def boom(*a, **k):
        raise OSError("simulated crash")

    monkeypatch.setattr(os, crash_at, boom)
    with pytest.raises(OSError, match="simulated crash"):
        msgpack_ckpt.save_pytree(path, {"a": np.zeros(4, np.int32)})
    monkeypatch.undo()
    got, _ = msgpack_ckpt.load_pytree(path, like=first)
    np.testing.assert_array_equal(got["a"], first["a"])
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_corrupt_checkpoint_raises_clearly(tmp_path):
    path = tmp_path / "c.msgpack"
    path.write_bytes(b"\xde\xad\xbe\xef not msgpack")
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        msgpack_ckpt.load_pytree(str(path))


# ---------------------------------------------------------------------------
# Incremental chains
# ---------------------------------------------------------------------------

def test_incremental_chain_restores_equal_to_full(tmp_path,
                                                  batched_state):
    state, (x, y, cfg, cls) = batched_state
    base_path = str(tmp_path / "c0.msgpack")
    hashes = msgpack_ckpt.save_pytree(base_path, state,
                                      treedef=batched.STATE_TREEDEF)
    state2 = batched.run_rounds(state, x, y, cfg, cls, n=2)
    tip = str(tmp_path / "c1.msgpack")
    msgpack_ckpt.save_pytree(tip, state2, treedef=batched.STATE_TREEDEF,
                             base=base_path, base_hashes=hashes)
    full = str(tmp_path / "full.msgpack")
    msgpack_ckpt.save_pytree(full, state2, treedef=batched.STATE_TREEDEF)
    assert msgpack_ckpt.snapshot_base(tip) == "c0.msgpack"
    assert msgpack_ckpt.snapshot_base(full) is None
    assert os.path.getsize(tip) < os.path.getsize(full)
    via_chain, _ = msgpack_ckpt.restore_pytree(tip, device="cpu")
    via_full, _ = msgpack_ckpt.restore_pytree(full, device="cpu")
    _assert_trees_equal(via_chain, via_full)
    _assert_trees_equal(via_chain, state2)


def test_incremental_unchanged_leaves_not_rewritten(tmp_path):
    t0 = {"big": torch.zeros(1024), "ctr": np.int32(0)}
    p0 = str(tmp_path / "a0.msgpack")
    h0 = msgpack_ckpt.save_pytree(p0, t0)
    t1 = dict(t0, ctr=np.int32(1))
    p1 = str(tmp_path / "a1.msgpack")
    msgpack_ckpt.save_pytree(p1, t1, base=p0, base_hashes=h0)
    payload = msgpack_ckpt._read_payload(p1)
    assert set(payload["arrays"]) == {"ctr"}
    got, _ = msgpack_ckpt.load_pytree(p1, like=t1)
    _assert_trees_equal(got, t1)


# ---------------------------------------------------------------------------
# Async writer
# ---------------------------------------------------------------------------

def test_async_writer_wait_is_a_durability_barrier(tmp_path,
                                                   batched_state):
    state, _ = batched_state
    w = msgpack_ckpt.AsyncCheckpointer(max_pending=2)
    paths = [str(tmp_path / f"a{i}.msgpack") for i in range(3)]
    for p in paths:
        w.save(p, state, treedef=batched.STATE_TREEDEF)
    w.wait()
    for p in paths:
        restored, _ = msgpack_ckpt.restore_pytree(p, device="cpu")
        _assert_trees_equal(state, restored)
    w.close()


def test_async_writer_chains_incrementally(tmp_path):
    w = msgpack_ckpt.AsyncCheckpointer()
    t0 = {"big": np.zeros(512, np.float32), "ctr": np.int32(0)}
    p0, p1, p2 = (str(tmp_path / f"c{i}.msgpack") for i in range(3))
    w.save(p0, t0, chain="d0")
    w.save(p1, dict(t0, ctr=np.int32(1)), chain="d0")
    w.wait()
    assert msgpack_ckpt.snapshot_base(p0) is None
    assert msgpack_ckpt.snapshot_base(p1) == "c0.msgpack"
    assert set(msgpack_ckpt._read_payload(p1)["arrays"]) == {"ctr"}
    w.forget("d0")
    w.save(p2, dict(t0, ctr=np.int32(2)), chain="d0")
    w.wait()
    assert msgpack_ckpt.snapshot_base(p2) is None
    w.close()


def test_async_writer_error_surfaces_in_wait(tmp_path):
    w = msgpack_ckpt.AsyncCheckpointer()
    blocker = tmp_path / "sub"
    blocker.write_text("a file where the save needs a directory")
    w.save(str(blocker / "x.msgpack"), {"a": np.zeros(2, np.int32)})
    with pytest.raises(RuntimeError, match="async checkpoint save"):
        w.wait()
    ok = str(tmp_path / "ok.msgpack")
    w.save(ok, {"a": np.ones(2, np.int32)})
    w.wait()
    assert os.path.exists(ok)
    w.close()


def test_save_pytree_async_module_level(tmp_path):
    path = str(tmp_path / "m.msgpack")
    w = msgpack_ckpt.save_pytree_async(path, {"a": torch.arange(3)})
    w.wait()
    arrays, _ = msgpack_ckpt.load_pytree(path)
    np.testing.assert_array_equal(arrays["a"], np.arange(3))


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def test_manager_keep_zero_raises(tmp_path):
    with pytest.raises(ValueError, match="keep=0"):
        msgpack_ckpt.CheckpointManager(str(tmp_path), keep=0)
    with pytest.raises(ValueError, match="full_every"):
        msgpack_ckpt.CheckpointManager(str(tmp_path), full_every=0)


def test_manager_steps_skips_stray_files(tmp_path):
    mgr = msgpack_ckpt.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(10, {"a": np.zeros(2, np.int32)})
    (tmp_path / "ckpt_garbage.msgpack").write_bytes(b"junk")
    (tmp_path / "ckpt_00000020.msgpack.tmp").write_bytes(b"junk")
    with pytest.warns(UserWarning, match="unparsable"):
        steps = mgr.steps()
    assert steps == [10]
    with pytest.warns(UserWarning, match="unparsable"):
        got, meta = mgr.restore_latest(device="cpu")
    assert meta["step"] == 10
    assert torch.equal(got["a"], torch.zeros(2, dtype=torch.int32))


def test_manager_restore_latest_empty_dir(tmp_path):
    mgr = msgpack_ckpt.CheckpointManager(str(tmp_path))
    assert mgr.restore_latest(device="cpu") == (None, None)


def test_manager_retention_protects_chain_ancestors(tmp_path):
    mgr = msgpack_ckpt.CheckpointManager(str(tmp_path), keep=1,
                                         incremental=True, full_every=10)
    tree = {"big": np.zeros(256, np.float32), "ctr": np.int32(0)}
    for step in range(4):
        mgr.save(step, dict(tree, ctr=np.int32(step)))
    assert mgr.steps() == [0, 1, 2, 3]
    got, meta = mgr.restore_latest(device="cpu")
    assert meta["step"] == 3
    assert int(got["ctr"]) == 3
    assert torch.equal(got["big"], torch.zeros(256))


def test_manager_full_every_bounds_chains(tmp_path):
    mgr = msgpack_ckpt.CheckpointManager(str(tmp_path), keep=1,
                                         incremental=True, full_every=2)
    tree = {"big": np.zeros(256, np.float32), "ctr": np.int32(0)}
    for step in range(7):
        mgr.save(step, dict(tree, ctr=np.int32(step)))
    kept = mgr.steps()
    assert kept[-1] == 6
    assert len(kept) <= 3
    got, _ = mgr.restore_latest(device="cpu")
    assert int(got["ctr"]) == 6


def test_manager_template_free_restore_roundtrip(tmp_path, batched_state):
    state, _ = batched_state
    mgr = msgpack_ckpt.CheckpointManager(str(tmp_path), keep=2,
                                         incremental=True,
                                         treedef=batched.STATE_TREEDEF)
    mgr.save(1, state)
    restored, meta = mgr.restore_latest(device="cpu")
    assert isinstance(restored, batched.StepState)
    assert meta["step"] == 1
    _assert_trees_equal(state, restored)
    via_like, _ = mgr.restore_latest(like=state)
    _assert_trees_equal(state, via_like)


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py's checkpoint cases on the port's engines
# ---------------------------------------------------------------------------

FT_CFG = BoostConfig(k=4, coreset_size=100, domain_size=1 << 12,
                     opt_budget=16)
FT_CLS = weak.Thresholds(n=1 << 12)


def _ft_batch(B=2, m=512, noise=3, seed0=11):
    x, y, _ = tasks.make_batch(FT_CLS, B, m, 4, noise, seed0=seed0)
    return x, y, prng.split(prng.key(5), B)


def test_checkpoint_resume_bit_identical(tmp_path):
    x, y, keys = _ft_batch()
    full = batched.run_accurately_classify_batched(x, y, keys, FT_CFG,
                                                   FT_CLS, device="cpu")
    state = batched.run_rounds(
        batched.init_state(x, y, keys, FT_CFG, device="cpu"), x, y, FT_CFG,
        FT_CLS, n=4)
    path = os.path.join(tmp_path, "engine_state.msgpack")
    msgpack_ckpt.save_pytree(path, state, meta={"rounds_done": 4})
    del state
    template = batched.init_state(x, y, keys, FT_CFG, device="cpu")
    restored, meta = msgpack_ckpt.load_pytree(path, like=template)
    assert meta["rounds_done"] == 4
    done = batched.run_rounds(restored, x, y, FT_CFG, FT_CLS)
    got = batched.finalize(done, x, y, full.alive0, FT_CFG, FT_CLS)
    assert_results_equal(full, got)
    np.testing.assert_array_equal(full.min_loss, got.min_loss)


def test_sharded_checkpoint_resume_bit_identical(tmp_path, group):
    x, y, keys = _ft_batch()
    full = sharded_batched.run_accurately_classify_sharded(
        x, y, keys, FT_CFG, FT_CLS, group=group)
    state = sharded_batched.init_state_sharded(x, y, keys, FT_CFG,
                                               device="cpu")
    state = sharded_batched.run_rounds_sharded(state, x, y, FT_CFG, FT_CLS,
                                               group=group, n=5)
    path = os.path.join(tmp_path, "sharded_state.msgpack")
    msgpack_ckpt.save_pytree(path, state, meta={})
    del state
    template = sharded_batched.init_state_sharded(x, y, keys, FT_CFG,
                                                  device="cpu")
    restored, _ = msgpack_ckpt.load_pytree(path, like=template)
    done = sharded_batched.run_rounds_sharded(restored, x, y, FT_CFG,
                                              FT_CLS, group=group)
    got = sharded_batched.finalize_sharded(done, x, y, full.alive0, FT_CFG,
                                           FT_CLS, group=group)
    assert_results_equal(full, got)
    for f in WIRE:
        np.testing.assert_array_equal(getattr(full, f), getattr(got, f), f)
    for b in range(full.batch):
        got.validate_ledger(b)


def test_checkpoint_shape_mismatch_fails_loudly(tmp_path):
    x, y, keys = _ft_batch(B=2, m=256)
    state = batched.run_rounds(
        batched.init_state(x, y, keys, FT_CFG, device="cpu"), x, y, FT_CFG,
        FT_CLS, n=2)
    path = os.path.join(tmp_path, "state.msgpack")
    msgpack_ckpt.save_pytree(path, state, meta={},
                             treedef=batched.STATE_TREEDEF)
    x3, y3, keys3 = _ft_batch(B=3, m=256)
    wrong = batched.init_state(x3, y3, keys3, FT_CFG, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        msgpack_ckpt.load_pytree(path, like=wrong)


@pytest.mark.parametrize("mode", ["histogram", "voting"])
def test_tree_comm_sharded_checkpoint_resume(mode, tmp_path, group):
    cls = weak.make_class("tree", num_features=4, tree_depth=2,
                          tree_bins=8, tree_comm_mode=mode,
                          tree_vote_topk=1)
    cfg = BoostConfig(k=4, coreset_size=64, domain_size=1 << 12,
                      opt_budget=16, deterministic_coreset=False)
    spec = scenarios.ScenarioSpec(name="xor", noise=2)
    x, y, _ = scenarios.make_scenario_batch(cls, 2, 256, 4, spec, seed0=21)
    keys = prng.split(prng.key(7), 2)
    full = sharded_batched.run_accurately_classify_sharded(
        x, y, keys, cfg, cls, group=group)
    state = sharded_batched.init_state_sharded(x, y, keys, cfg, cls=cls,
                                               device="cpu")
    state = sharded_batched.run_rounds_sharded(state, x, y, cfg, cls,
                                               group=group, n=3)
    path = os.path.join(tmp_path, f"tree_{mode}.msgpack")
    msgpack_ckpt.save_pytree(path, state,
                             treedef=sharded_batched.STATE_TREEDEF)
    del state
    restored, _ = msgpack_ckpt.restore_pytree(path, device="cpu")
    assert {"awire_hist", "awire_votes", "hist_wire_hist",
            "hist_wire_votes"} <= set(restored)
    done = sharded_batched.run_rounds_sharded(restored, x, y, cfg, cls,
                                              group=group)
    got = sharded_batched.finalize_sharded(done, x, y, full.alive0, cfg,
                                           cls, group=group)
    assert_results_equal(full, got)
    for f in WIRE:
        np.testing.assert_array_equal(getattr(full, f), getattr(got, f), f)
    for b in range(full.batch):
        got.validate_ledger(b)


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

J_CLS = j_weak.make_class("thresholds", n=1 << 12)
J_CFG = JConfig(k=4, coreset_size=100, domain_size=1 << 12, opt_budget=16)


def _jax_keys(B):
    return jax.random.split(jax.random.key(5), B)


def _assert_wire_equal(ref, got):
    for f in WIRE:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      np.asarray(getattr(got, f)), f)


@pytest.mark.parametrize("engine", ["batched", "sharded"])
def test_jax_checkpoint_is_finished_by_the_port(engine, tmp_path, group):
    """The JAX engine stops after 4 rounds and checkpoints; the port
    reads the file, carries it over with convert, and finishes it equal
    to the JAX engine's uninterrupted run on every protocol output,
    ledger field (and wire counter)."""
    x, y, keys = _ft_batch()
    jkeys = _jax_keys(2)
    path = str(tmp_path / "jax.msgpack")
    if engine == "batched":
        ref = j_batched.run_accurately_classify_batched(x, y, jkeys, J_CFG,
                                                        J_CLS)
        st = j_batched.run_rounds(j_batched.init_state(x, y, jkeys, J_CFG),
                                  x, y, J_CFG, J_CLS, n=4)
        j_ckpt.save_pytree(path, jax.device_get(st),
                           treedef=j_batched.STATE_TREEDEF)
        flat, _ = msgpack_ckpt.load_pytree(path)
        state = convert.from_jax(flat, device="cpu")
        done = batched.run_rounds(state, x, y, FT_CFG, FT_CLS)
        got = batched.finalize(done, x, y, np.ones(y.shape, bool), FT_CFG,
                               FT_CLS)
    else:
        ref = j_sharded.run_accurately_classify_sharded(x, y, jkeys, J_CFG,
                                                        J_CLS)
        st = j_sharded.init_state_sharded(x, y, jkeys, J_CFG, cls=J_CLS)
        st = j_sharded.run_rounds_sharded(st, x, y, J_CFG, J_CLS, n=4)
        j_ckpt.save_pytree(path, jax.device_get(st),
                           treedef=j_sharded.STATE_TREEDEF)
        flat, _ = msgpack_ckpt.load_pytree(path)
        state = convert.from_jax_sharded(flat, device="cpu")
        done = sharded_batched.run_rounds_sharded(state, x, y, FT_CFG,
                                                  FT_CLS, group=group)
        got = sharded_batched.finalize_sharded(
            done, x, y, np.ones(y.shape, bool), FT_CFG, FT_CLS, group=group)
        _assert_wire_equal(ref, got)
    assert bool(got.ok.all())
    assert_results_equal(ref, got)


@pytest.mark.parametrize("engine", ["batched", "sharded"])
def test_port_checkpoint_is_read_and_finished_by_jax(engine, tmp_path,
                                                     group):
    """The port stops after 4 rounds and checkpoints; the JAX
    ``load_pytree`` reads the file with ``convert.to_jax``'s leaves (flat
    and into a JAX template), and the JAX engine finishes it equal to
    its own uninterrupted run."""
    x, y, keys = _ft_batch()
    jkeys = _jax_keys(2)
    path = str(tmp_path / "port.msgpack")
    if engine == "batched":
        st = batched.run_rounds(
            batched.init_state(x, y, keys, FT_CFG, device="cpu"), x, y,
            FT_CFG, FT_CLS, n=4)
        msgpack_ckpt.save_pytree(path, st, treedef=batched.STATE_TREEDEF)
        want = convert.to_jax(st)
        template = j_batched.init_state(x, y, jkeys, J_CFG)
    else:
        st = sharded_batched.init_state_sharded(x, y, keys, FT_CFG,
                                                device="cpu")
        st = sharded_batched.run_rounds_sharded(st, x, y, FT_CFG, FT_CLS,
                                                group=group, n=4)
        msgpack_ckpt.save_pytree(path, st,
                                 treedef=sharded_batched.STATE_TREEDEF)
        want = convert.to_jax_sharded(st)
        template = j_sharded.init_state_sharded(x, y, jkeys, J_CFG,
                                                cls=J_CLS)
    flat, _ = j_ckpt.load_pytree(path)
    for name, v in want.items():
        assert flat[name].dtype == v.dtype, name
        np.testing.assert_array_equal(flat[name], v, err_msg=name)
    restored, _ = j_ckpt.load_pytree(path, like=template)
    if engine == "batched":
        for name, v in restored._asdict().items():
            np.testing.assert_array_equal(np.asarray(v), want[name], name)
        ref = j_batched.run_accurately_classify_batched(x, y, jkeys, J_CFG,
                                                        J_CLS)
        done = j_batched.run_rounds(restored, x, y, J_CFG, J_CLS)
        got = j_batched.finalize(done, x, y, np.ones(y.shape, bool), J_CFG,
                                 J_CLS)
    else:
        for name, v in restored.items():
            np.testing.assert_array_equal(np.asarray(v), want[name], name)
        ref = j_sharded.run_accurately_classify_sharded(x, y, jkeys, J_CFG,
                                                        J_CLS)
        done = j_sharded.run_rounds_sharded(restored, x, y, J_CFG, J_CLS)
        got = j_sharded.finalize_sharded(done, x, y, np.ones(y.shape, bool),
                                         J_CFG, J_CLS)
        _assert_wire_equal(ref, got)
    assert bool(np.asarray(got.ok).all())
    assert_results_equal(ref, got)
