"""Multi-pod dry run: place and run every (arch × shape × mesh) on a
fake world — the port of ``repro.launch.dryrun``.

The proof that the distribution config is coherent without hardware.
The reference lowers and compiles ``jit(step)`` on ShapeDtypeStructs
over 512 fake XLA devices; the port places the parameters, optimizer
state, batch and caches as DTensors of ``meta`` locals on the
production mesh (:mod:`repro_torch.launch.mesh`, a ``fake`` world of
256 or 512 ranks, this process rank 0), by the policy of
:mod:`repro_torch.launch.sharding`, and runs the step once.  DTensor
propagates each op's sharding, inserts the collectives and runs the
local op on rank 0's shard shapes; no value is computed.
:class:`DeviceCounter`, a ``TorchDispatchMode`` under DTensor, sees
those local ops and collectives and counts what one device does.  The
roofline terms (per device, against the H100 constants of
:mod:`repro_torch.launch.mesh`):

    compute_s    = flops_per_dev / PEAK_FLOPS_BF16
    memory_s     = bytes_per_dev / HBM_BW
    collective_s = wire bytes of the collectives / NVLINK_BW

The record keeps the reference's keys where they mean the same thing.
Its HLO-named fields take plain names: ``hlo_flops_per_dev`` is
``flops_per_dev`` (the FLOPs of the local products, as torch's
``flop_counter`` counts matmuls, batched matmuls, convolutions and
attention; XLA's count adds the elementwise ops), ``hlo_bytes_per_dev``
is ``bytes_per_dev`` (each local op's tensor operands and results, with
no fusion: an upper bound on XLA's "bytes accessed"), and the memory
analysis' argument and output sizes are the local shards' bytes.
``lower_s``/``compile_s`` are ``run_s``, the time of the placed run.
The reference's ``REPRO_SCAN_UNROLL`` has no counterpart: the port
loops over layers in Python, so the counter sees every layer.

The step is ``build(cfg)``'s with ``use_flash=False``, as the
reference's dry run builds it, so no kernel is on this path.  Plain
tensors that a step makes (positions, masks) count as replicated
(``implicit_replication``).  An op that DTensor has no sharding rule
for is given one here (:data:`FALLBACK_OPS`): its operands are
replicated and it runs whole on every device, as GSPMD falls back.  A
pair that still fails prints FAIL and makes ``main`` exit 1.

Usage:
    python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
    python -m repro_torch.launch.dryrun --protocol [--multi-pod]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import time
import traceback
import warnings

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor._dtensor_spec import DTensorSpec
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   register_sharding)
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                      MeshConfig, ModelConfig, ShapeConfig,
                                      get_config)
from repro_torch.core.sharded_batched import FoldInKeys, PlayersGroup
from repro_torch.data.pipeline import batch_specs
from repro_torch.launch import mesh as mesh_lib, sharding
from repro_torch.models import build
from repro_torch.models.frontend import embed_spec
from repro_torch.optim import adamw

META = torch.device("meta")
aten = torch.ops.aten

# ---------------------------------------------------------------------------
# Input specs (meta tensors stand for ShapeDtypeStructs)
# ---------------------------------------------------------------------------


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Model-input specs for a given input shape.

    VLM: seq_len positions = frontend patch positions + text tokens.
    audio (enc-dec): seq_len source frames + seq_len//4 target tokens.
    """
    B, S = shape.global_batch, shape.seq_len
    if cfg.encoder_layers:
        St = max(S // 4, 16)
        return {
            "frames": embed_spec(cfg, B, S),
            "tokens": _spec((B, St), torch.int32),
            "labels": _spec((B, St), torch.int32),
            "loss_mask": _spec((B, St), torch.float32),
            "weights": _spec((B,), torch.float32),
            "alive": _spec((B,), torch.float32),
        }
    specs = batch_specs(cfg, shape)
    if cfg.frontend == "vit_stub":
        P_ = min(cfg.frontend_tokens, S // 2)
        St = S - P_
        specs = dict(
            specs,
            tokens=_spec((B, St), torch.int32),
            labels=_spec((B, St), torch.int32),
            loss_mask=_spec((B, St), torch.float32),
            prefix_embeds=embed_spec(cfg, B, P_),
        )
    return specs


# ---------------------------------------------------------------------------
# What one device does: local FLOPs, bytes and collectives
# ---------------------------------------------------------------------------

# functional collectives (DTensor's redistributions) → the reference's
# HLO collective names
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _is_view(func) -> bool:
    """An op whose results alias an operand without writing it (a view:
    no memory moves)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class DeviceCounter(TorchDispatchMode):
    """Counts the local ops of one device under DTensor: an op on
    DTensors is left to DTensor (``NotImplemented``), which runs the
    local op on this rank's shards, and that op comes back here; the
    ops DTensor's sharding propagation runs on fake global tensors (or
    that make them) are skipped, so a count does not depend on what
    its caches already hold.  Records the products' FLOPs, the bytes
    of every op that is not a view, and every functional collective's
    result bytes by kind (the wire model of :func:`collective_bytes`).
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.bytes_by_op = dict.fromkeys(COLLECTIVES.values(), 0)
        self.count_by_op = dict.fromkeys(COLLECTIVES.values(), 0)
        self.sizes = collections.Counter()   # (kind, bytes) → calls
        self.view_copies = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs))):
            return func(*args, **kwargs)    # sharding propagation
        try:
            out = func(*args, **kwargs)
        except RuntimeError as e:
            if func is not aten.view.default or "view size" not in str(e):
                raise
            # DTensor decides a view on the global strides; a shard
            # whose own strides do not allow it is copied first, as a
            # compiler would copy it (its bytes count)
            self.view_copies += 1
            self.bytes += 2 * _nbytes(args[0])
            return aten._unsafe_view(args[0].contiguous(), args[1])
        if any(isinstance(t, FakeTensor) for t in _tensors(out)):
            return out                      # a propagation's fake input
        name = func._schema.name.split("::")[-1]
        if func.namespace in _COLLECTIVE_NAMESPACES:
            kind = COLLECTIVES.get(name)
            if kind is not None:
                nb = _nbytes(out)
                self.bytes_by_op[kind] += nb
                self.count_by_op[kind] += 1
                self.sizes[(kind, nb)] += 1
            return out
        if func._overloadpacket in flop_registry:
            self.flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        if not _is_view(func):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def collectives(self) -> dict:
        return collective_bytes(self.bytes_by_op, self.count_by_op)

    def largest_collective(self) -> int:
        """Bytes of the largest single collective result."""
        return max((nb for _, nb in self.sizes), default=0)


def collective_bytes(bytes_by_op: dict, count_by_op: dict) -> dict:
    """Per-kind result bytes of the collectives, plus an 'effective
    wire bytes per device' model:
      all-reduce       2× result (ring reduce-scatter + all-gather)
      all-gather       1× result
      reduce-scatter   1× result (per-device egress ≈ result bytes)
      all-to-all       1× result
      collective-permute 1× result
    """
    per = {k: int(bytes_by_op.get(k, 0)) for k in COLLECTIVES.values()}
    count = {k: int(count_by_op.get(k, 0)) for k in COLLECTIVES.values()}
    wire = (2 * per["all-reduce"] + per["all-gather"]
            + per["reduce-scatter"] + per["all-to-all"]
            + per["collective-permute"])
    return {"bytes_by_op": per, "count_by_op": count, "wire_bytes": wire}


# ---------------------------------------------------------------------------
# Ops DTensor cannot place: replicate their operands (GSPMD's fallback)
# ---------------------------------------------------------------------------

def _pointwise_rule(*args, **kwargs):
    """A sharding rule for a pointwise op: its operands replicated (the
    fallback), or every operand of the result's rank sharded alike on
    one dim (an operand of another rank, such as an empty buffer,
    replicated)."""
    ins = list(args) + list(kwargs.values())
    specs = [a for a in ins if isinstance(a, DTensorSpec)]
    ndim = max(len(a.shape) for a in specs)
    out = [([Replicate()],
            [Replicate() if isinstance(a, DTensorSpec) else None
             for a in ins])]
    for d in range(ndim):
        out.append(([Shard(d)],
                    [(Shard(d) if len(a.shape) == ndim else Replicate())
                     if isinstance(a, DTensorSpec) else None for a in ins]))
    return out


# op → (its rule, why DTensor has none in the port's models)
FALLBACK_OPS = {
    aten.log_sigmoid_backward.default: (
        _pointwise_rule, "the backward of F.logsigmoid (the mLSTM forget "
        "gate, the sLSTM's) has no DTensor rule in torch 2.13"),
}

_REGISTERED = False


def register_fallbacks() -> None:
    """Register the rules of :data:`FALLBACK_OPS` (once per process)."""
    global _REGISTERED
    if _REGISTERED:
        return
    for op, (rule, _) in FALLBACK_OPS.items():
        register_sharding(op)(rule)
    _REGISTERED = True


# ---------------------------------------------------------------------------
# Place and run one (arch, shape, mesh)
# ---------------------------------------------------------------------------

def _step_and_args(cfg: ModelConfig, shape: ShapeConfig,
                   mesh_cfg: MeshConfig, mesh):
    """Returns (step, placed args, out_fn): the shape's step, its
    arguments as DTensors of meta locals, and what to do with its
    outputs (the prefill places its caches by ``cache_partition``, as
    the reference's out_shardings)."""
    model = build(cfg, use_flash=False)
    params = model.init(0, device=META)
    pspecs = sharding.param_specs(params, cfg, mesh_cfg)
    pd = sharding.distribute(params, pspecs, mesh)
    if shape.kind == "train":
        opt = adamw.adamw_init(params)
        od = sharding.distribute(opt, sharding.opt_specs(pspecs), mesh)
        batch = input_specs(cfg, shape)
        bparts = sharding.batch_partition(cfg, shape, mesh_cfg)
        bd = sharding.distribute(batch, {k: bparts[k] for k in batch}, mesh)
        return model.make_train_step(), (pd, od, bd), None
    if shape.kind == "prefill":
        batch = {k: v for k, v in input_specs(cfg, shape).items()
                 if k in ("tokens", "frames", "prefix_embeds")}
        bparts = sharding.batch_partition(cfg, shape, mesh_cfg)
        bd = sharding.distribute(batch, {k: bparts[k] for k in batch}, mesh)

        def out_fn(out):
            logits, caches = out
            cspecs = sharding.cache_partition(caches, cfg, shape, mesh_cfg)
            return logits, sharding.distribute(caches, cspecs, mesh)

        return (model.make_prefill_step(window=model.decode_window(shape)),
                (pd, bd), out_fn)
    cache = model.init_serve_cache(shape, filled=True, device=META)
    cd = sharding.distribute(
        cache, sharding.cache_partition(cache, cfg, shape, mesh_cfg), mesh)
    dp = mesh_cfg.data * mesh_cfg.pod
    tparts = (sharding.P(mesh_cfg.batch_axes, None)
              if shape.global_batch % dp == 0 else sharding.P(None, None))
    tok = sharding.distribute(_spec((shape.global_batch, 1), torch.int32),
                              tparts, mesh)
    return (model.make_decode_step(window=model.decode_window(shape)),
            (pd, cd, tok), None)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in _tensors(tree))


def _apply_overrides(cfg: ModelConfig, overrides):
    """--set key=value config overrides for §Perf variants."""
    if not overrides:
        return cfg
    kw = {}
    for kv in overrides:
        k, v = kv.split("=", 1)
        field = {f.name: f for f in dataclasses.fields(cfg)}[k]
        typ = field.type if isinstance(field.type, type) else type(
            getattr(cfg, k))
        if typ is bool or isinstance(getattr(cfg, k), bool):
            kw[k] = v.lower() in ("1", "true", "yes")
        elif isinstance(getattr(cfg, k), int):
            kw[k] = int(v)
        elif isinstance(getattr(cfg, k), float):
            kw[k] = float(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


@contextlib.contextmanager
def _alltoall_on_cpu_mesh():
    """Within the block, DTensor moves a shard from one tensor dim to
    another with its all-to-all op, as on a CUDA mesh, where on a CPU
    mesh it falls back to an all-gather and a local chunk (gloo has no
    all-to-all): the production mesh is one of cards, and the fake
    backend takes either.  Patches ``placement_types.
    shard_dim_alltoall`` (a private name of torch 2.13; where it is
    missing the fallback stays, and its all-gathers are counted)."""
    from torch.distributed.tensor import placement_types as pt

    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def alltoall(local, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            local, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


def step_mesh(mesh, mesh_cfg: MeshConfig, shape: ShapeConfig):
    """The mesh a step's DTensors live on.  On the multi-pod mesh the
    policy names "pod" only beside "data", as the batch axes: a batch
    that shards over them lives on the mesh with (pod, data) flattened
    into one dim, "pod_data" (the same ranks in the same order), and a
    batch that does not (B = 1) on the (data, model) mesh of this
    rank's pod, replicated over pods.  Either is a 2-D mesh: DTensor's
    redistribution planner searches placement states per mesh dim, and
    on the 3-D mesh that search takes minutes for one attention
    einsum."""
    if mesh_cfg.pod == 1:
        return mesh
    if shape.global_batch % (mesh_cfg.data * mesh_cfg.pod):
        return mesh["data", "model"]
    return DeviceMesh(mesh.device_type,
                      mesh.mesh.reshape(-1, mesh_cfg.model),
                      mesh_dim_names=("pod_data", "model"))


def run_placed(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
               mesh) -> tuple:
    """Place (cfg, shape) on ``mesh`` (:func:`step_mesh`) and run its
    step once under a :class:`DeviceCounter`: returns (counter,
    argument bytes, output bytes) per device."""
    register_fallbacks()
    mesh = step_mesh(mesh, mesh_cfg, shape)
    step, args, out_fn = _step_and_args(cfg, shape, mesh_cfg, mesh)
    counter = DeviceCounter()
    grad = (torch.enable_grad() if shape.kind == "train"
            else torch.no_grad())
    with grad, implicit_replication(), _alltoall_on_cpu_mesh(), counter, \
            warnings.catch_warnings():
        # plain tensors of one element that the step makes (B = 1
        # positions) replicate as all others do, with a warning apiece
        warnings.filterwarnings("ignore", "Found a non-scalar tensor with "
                                "numel=1", UserWarning)
        out = step(*args)
        if out_fn is not None:
            out = out_fn(out)
    return counter, _local_bytes(args), _local_bytes(out)


def dry_run_one(arch: str, shape_name, multi_pod: bool = False,
                overrides=None, *, mesh_cfg: MeshConfig | None = None,
                cfg: ModelConfig | None = None) -> dict:
    """One pair on the production mesh (or ``mesh_cfg``'s).
    ``shape_name`` names an ``INPUT_SHAPES`` entry or is a
    ``ShapeConfig`` itself; ``cfg`` replaces the registered config (a
    test's reduced one)."""
    cfg = _apply_overrides(cfg or get_config(arch), overrides)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else INPUT_SHAPES[shape_name])
    shape_name = shape.name
    mesh_cfg = mesh_cfg or MeshConfig(pod=2 if multi_pod else 1)
    t0 = time.time()
    with mesh_lib.make_production_mesh(mesh_cfg=mesh_cfg) as mesh:
        counter, arg_bytes, out_bytes = run_placed(cfg, shape, mesh_cfg,
                                                   mesh)
    run_s = time.time() - t0
    coll = counter.collectives()
    chips = mesh_cfg.num_devices
    flops, nbytes = float(counter.flops), float(counter.bytes)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": list(mesh_cfg.shape), "chips": chips,
        "kind": shape.kind,
        "run_s": round(run_s, 2),
        "flops_per_dev": flops,
        "bytes_per_dev": nbytes,
        "collectives": coll,
        "largest_collective_bytes": counter.largest_collective(),
        "view_copies": counter.view_copies,
        "compute_s": flops / mesh_lib.PEAK_FLOPS_BF16,
        "memory_s": nbytes / mesh_lib.HBM_BW,
        "collective_s": coll["wire_bytes"] / mesh_lib.NVLINK_BW,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
    }
    terms = {"compute": result["compute_s"], "memory": result["memory_s"],
             "collective": result["collective_s"]}
    result["dominant"] = max(terms, key=terms.get)
    # model FLOPs: 6·N_active·tokens (train), 2·N_active·tokens (fwd),
    # per device against the counted per-device FLOPs
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = 6 if shape.kind == "train" else 2
    result["model_flops_per_dev"] = (factor * cfg.active_param_count()
                                     * tokens / chips)
    result["useful_ratio"] = (result["model_flops_per_dev"] / flops
                              if flops else 0.0)
    return result


# ---------------------------------------------------------------------------
# The paper's own workload on the production mesh
# ---------------------------------------------------------------------------

def protocol_dry_run(multi_pod: bool = False, m_total: int = 1 << 24,
                     coreset: int = 512, *,
                     mesh_cfg: MeshConfig | None = None) -> dict:
    """The paper's workload: one BoostAttempt round (coreset gather →
    center ERM → MW update) with the sample sharded over data(×pod)
    players — 16 (or 32) players, 2^24 examples — through
    ``core.boost_attempt.boost_attempt_sharded`` over a players group
    of k ranks on the fake backend, this process player 0.

    The fake backend's collectives leave their buffers unfilled, so the
    dry run's wire fills each gathered buffer from this rank's own part
    (the round goes on with k copies of player 0's coreset) and
    records every exchange's kind and bytes; a :class:`DeviceCounter`
    counts the bytes of the round's ops (``memory_s``; the round has no
    products, so no ``compute_s``: XLA's count would be elementwise).
    The attempt's round makes the coreset and weight-sum gathers; the
    round's control message of the sharded engine, the alive-example
    count (a psum, the ledger's psum site), is issued here before it,
    as the engine issues it each round.  One round runs; its exchanges
    are charged T = ``cfg.num_rounds(m_total)`` times, as the reference
    multiplies its while-loop body.  Like the reference it does not
    claim to run the protocol.

    The round computes on real CPU tensors (the sample, its labels and
    weights: the coreset and the ERM need values to pick what they
    send), and no caller can move it to a card: this path counts the
    exchanges and their bytes, and its ``run_s`` is a host time, never
    a device time."""
    import numpy as np

    from repro_torch.core import boost_attempt, ledger, weak
    from repro_torch.core.types import BoostConfig

    mesh_cfg = mesh_cfg or MeshConfig(pod=2 if multi_pod else 1)
    k = mesh_cfg.data * mesh_cfg.pod
    cfg = BoostConfig(k=k, coreset_size=coreset, domain_size=1 << 20,
                      deterministic_coreset=True)
    cls = weak.Thresholds(n=1 << 20)
    T = cfg.num_rounds(m_total)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 1 << 20, m_total, dtype=np.int32))
    y = torch.where(x >= 1 << 19, 1, -1).to(torch.int8)
    alive = torch.ones(m_total, dtype=torch.bool)
    hits = torch.zeros(m_total, dtype=torch.int32)
    key = np.array([0, 0], dtype=np.uint32)
    t0 = time.time()
    if dist.is_initialized():
        raise RuntimeError("the protocol dry run makes its own fake world; "
                           "torch.distributed is already initialised here")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=k)
    try:
        wire = RecordingPlayers(k)
        fn = boost_attempt.boost_attempt_sharded(wire, cfg, cls, 1)
        counter = DeviceCounter()
        with counter:
            wire.psum(alive.reshape(k, -1)[wire.rank].sum()[None])
            t, stuck, *_ = fn(x, y, alive, hits, key)
    finally:
        dist.destroy_process_group()
    sites = ledger.collective_sites_per_round(cls)
    coll = collective_bytes(wire.bytes_by_op, wire.count_by_op)
    res = {
        "arch": "boosting-protocol", "shape": f"m{m_total}",
        "mesh": list(mesh_cfg.shape), "kind": "protocol",
        "rounds": T, "coreset": coreset, "players": k,
        "run_s": round(time.time() - t0, 2),
        "round_ran": int(t), "round_stuck": bool(stuck),
        "calls_per_round": dict(wire.calls),
        "ledger_sites_per_round": sites,
        "bytes_per_dev": float(counter.bytes),
        "collectives": coll,
        "memory_s": counter.bytes / mesh_lib.HBM_BW,
        "collective_s": coll["wire_bytes"] / mesh_lib.NVLINK_BW,
    }
    # every exchange of the round runs once per round: T rounds an attempt
    res["per_attempt_collective_s"] = res["collective_s"] * T
    return res


class RecordingPlayers(FoldInKeys):
    """The single-attempt wire over a fake world of k ranks, this rank
    player 0.  A gather issues its collective and fills the result
    with k copies of this rank's part (the fake backend leaves it
    unfilled); a sum keeps this rank's value.  ``calls`` counts the
    round's exchanges by kind, as ``ledger.collective_sites_per_round``
    does, and every exchange's result bytes are recorded by kind."""

    def __init__(self, k: int):
        PlayersGroup.__init__(self, None, k, torch.device("cpu"))
        self.bytes_by_op = dict.fromkeys(COLLECTIVES.values(), 0)
        self.count_by_op = dict.fromkeys(COLLECTIVES.values(), 0)

    def _record(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        self.bytes_by_op[kind] += t.numel() * t.element_size()
        self.count_by_op[kind] += 1
        return t

    def _all_gather(self, t):
        super()._all_gather(t)
        return torch.cat([t] * self.size, dim=1)

    def gather(self, t):
        return self._record("all-gather", super().gather(t))

    def psum(self, t):
        return self._record("all-reduce", super().psum(t))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--protocol", action="store_true")
    ap.add_argument("--set", dest="overrides", nargs="*", default=None,
                    help="config overrides, e.g. moe_dispatch=sort")
    ap.add_argument("--tag", default="",
                    help="suffix for the output JSON (variant name)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.protocol:
        res = protocol_dry_run(multi_pod=args.multi_pod)
        tag = "boosting-protocol_" + _mesh_tag(args.multi_pod)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
        ok = res["calls_per_round"] == res["ledger_sites_per_round"]
        print(f"{'OK  ' if ok else 'FAIL'} {tag}: "
              f"calls/round={res['calls_per_round']} "
              f"collective={res['collective_s']:.6f}s/round "
              f"per_attempt={res['per_attempt_collective_s']:.6f}s "
              f"(run {res['run_s']:.0f}s)")
        raise SystemExit(0 if ok else 1)
    pairs = []
    if args.all:
        for arch in ASSIGNED_ARCHS:
            for shape in INPUT_SHAPES:
                pairs.append((arch, shape))
    else:
        pairs.append((args.arch, args.shape))
    failures = 0
    for arch, shape in pairs:
        tag = f"{arch}_{shape}_{_mesh_tag(args.multi_pod)}"
        if args.tag:
            tag += "_" + args.tag
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"SKIP {tag} (exists)")
            continue
        try:
            res = dry_run_one(arch, shape, multi_pod=args.multi_pod,
                              overrides=args.overrides)
            res["variant"] = args.tag or "baseline"
            res["overrides"] = args.overrides or []
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            print(f"OK   {tag}: dominant={res['dominant']} "
                  f"compute={res['compute_s']:.4f}s "
                  f"memory={res['memory_s']:.4f}s "
                  f"collective={res['collective_s']:.4f}s "
                  f"(run {res['run_s']:.0f}s)", flush=True)
        except Exception as e:
            failures += 1
            print(f"FAIL {tag}: {type(e).__name__}: {str(e)[:400]}",
                  flush=True)
            traceback.print_exc()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
