"""The launch tooling's dry run against the reference's, on the fake
backend.

``repro_torch.launch.dryrun`` places a step's parameters, optimizer
state, batch and caches as DTensors of ``meta`` locals on a fake world
and counts what one device computes and sends.  Here: its configs and
input specs against the reference's; the shape-only init against the
CPU init; a column-parallel product counting 1/16 of its FLOPs on the
16-wide model axis and a Megatron pair making exactly the one
all-reduce the policy implies; ``dry_run_one`` on a small fake mesh
(data 2, model 2; pod 1 and 2) at reduced dense and MoE configs with
its per-device FLOPs equal to a hand count; granite's head-layout hint
shrinking the prefill's largest collective (the reference's G-P3
finding, as a direction, at granite's own widths on the production
mesh); the protocol's dry run with its round's calls equal to the
ledger's sites and its bytes to a hand count; the CLI; and no process
group left behind.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro.configs import base as j_base
from repro.data import pipeline as j_pipeline
from repro.models import frontend as j_frontend
from repro_torch.configs import base
from repro_torch.core import ledger, weak
from repro_torch.core.types import BoostConfig
from repro_torch.data import pipeline
from repro_torch.launch import dryrun, mesh as mesh_lib, sharding
from repro_torch.models import build, frontend, layers as L, moe
from repro_torch.optim import adamw

from test_torch_sharding import _leaves

# the reference's dry run sets XLA_FLAGS (512 host devices) when it is
# imported; nothing here runs a jax computation, and the flag is put
# back before jax could read it, so the worker's other files keep
# their one device
_saved = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as j_dryrun  # noqa: E402

if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

torch.set_num_threads(1)

ARCHS = base.ASSIGNED_ARCHS
SMALL = {"pod1": dict(data=2, model=2), "pod2": dict(data=2, model=2, pod=2)}


@pytest.fixture(autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a process group outlived its call"


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


# ---------------------------------------------------------------------------
# configs and specs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(pod=2), dict(data=2, model=2),
                                dict(data=2, model=2, pod=2)])
def test_mesh_config_equals_reference(kw):
    got, want = base.MeshConfig(**kw), j_base.MeshConfig(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("num_devices", "axis_names", "shape", "batch_axes"):
        assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("shape", sorted(base.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape):
    cfg, j_cfg = base.get_config(arch), j_base.get_config(arch)
    shp, j_shp = base.INPUT_SHAPES[shape], j_base.INPUT_SHAPES[shape]
    got, want = dryrun.input_specs(cfg, shp), j_dryrun.input_specs(j_cfg,
                                                                    j_shp)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.is_meta
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert _dtype_name(v.dtype) == str(want[k].dtype), k
    got, want = (pipeline.batch_specs(cfg, shp),
                 j_pipeline.batch_specs(j_cfg, j_shp))
    assert {k: (tuple(v.shape), _dtype_name(v.dtype))
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    e, j_e = frontend.embed_spec(cfg, 3, 17), j_frontend.embed_spec(j_cfg, 3,
                                                                    17)
    assert e.is_meta and tuple(e.shape) == tuple(j_e.shape)
    assert _dtype_name(e.dtype) == str(j_e.dtype)


@pytest.mark.parametrize("overrides", [
    None, ["moe_dispatch=sort"], ["remat=false", "capacity_factor=2.0"],
    ["attn_layout_constraint=1", "num_layers=4", "rope_theta=5e5"]])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-7b"])
def test_apply_overrides_equals_reference(arch, overrides):
    got = dryrun._apply_overrides(base.get_config(arch), overrides)
    want = j_dryrun._apply_overrides(j_base.get_config(arch), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the shape-only init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_equals_cpu_init(arch):
    """At reduced width (d_model 64: the CPU init's draws are emulated
    bit for bit and take their time)."""
    model = build(base.reduced(base.get_config(arch), d_model=64, vocab=128))
    meta, cpu = model.init(0, "meta"), model.init(0, "cpu")
    got, want = _leaves(meta), _leaves(cpu)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, m), (_, c) in zip(got, want):
        assert m.is_meta and not c.is_meta
        assert (m.shape, m.dtype) == (c.shape, c.dtype), path
    # the optimizer state of meta parameters is meta too
    opt = adamw.adamw_init(meta)
    assert opt["step"].is_meta and opt["step"].dtype == torch.int32
    for moment in ("m", "v"):
        for (path, t), (_, p) in zip(_leaves(opt[moment]), got):
            assert t.is_meta and t.shape == p.shape, path
            assert t.dtype == torch.float32


def test_meta_is_refused_by_other_entry_points():
    from repro_torch.device import resolve_device

    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("meta", meta=True).type == "meta"


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_owns_its_world(multi_pod):
    with mesh_lib.make_production_mesh(multi_pod=multi_pod) as mesh:
        cfg = base.MeshConfig(pod=2 if multi_pod else 1)
        assert dist.get_world_size() == cfg.num_devices
        assert tuple(mesh.shape) == cfg.shape
        assert tuple(mesh.mesh_dim_names) == cfg.axis_names
        with pytest.raises(RuntimeError):
            with mesh_lib.make_production_mesh():
                pass
    assert not dist.is_initialized()


def test_host_mesh_on_the_cpu():
    with mesh_lib.make_host_mesh(device="cpu") as mesh:
        assert tuple(mesh.shape) == (1, 1)
        assert dist.get_backend() == "gloo"
        assert tuple(mesh.mesh_dim_names) == ("data", "model")


# ---------------------------------------------------------------------------
# per-device FLOPs and the collectives the policy implies
# ---------------------------------------------------------------------------

def _placed_mlp(mesh, cfg, mcfg, tokens, seq, batch_sharded):
    D, F = cfg.d_model, cfg.d_ff
    p = {"ffn": {n: {"w": torch.empty(shape, device="meta")}
                 for n, shape in (("wg", (D, F)), ("wu", (D, F)),
                                  ("wd", (F, D)))}}
    pd = sharding.distribute(p, sharding.param_specs(p, cfg, mcfg), mesh)
    spec = sharding.P(mcfg.batch_axes if batch_sharded else None, None, None)
    x = sharding.distribute(
        {"x": torch.empty(tokens, seq, D, dtype=torch.bfloat16,
                          device="meta")}, {"x": spec}, mesh)["x"]
    return pd["ffn"], x


def test_column_parallel_product_counts_a_sixteenth():
    """x @ wg with wg column-parallel on the 16-wide model axis and x
    replicated: each device multiplies by its 1/16 of the columns."""
    cfg = base.get_config("deepseek-7b")
    mcfg = base.MeshConfig()
    B, S = 4, 8
    with mesh_lib.make_production_mesh() as mesh:
        p, x = _placed_mlp(mesh, cfg, mcfg, B, S, batch_sharded=False)
        counter = dryrun.DeviceCounter()
        with torch.no_grad(), implicit_replication(), counter:
            y = L.linear(p["wg"], x)
        assert tuple(y.to_local().shape) == (B, S, cfg.d_ff // 16)
    glob = 2 * B * S * cfg.d_model * cfg.d_ff
    assert counter.flops * 16 == glob
    assert sum(counter.count_by_op.values()) == 0


@pytest.mark.parametrize("mesh_kw", [dict(), dict(data=2, model=2),
                                     dict(data=2, model=2, pod=2)])
def test_megatron_pair_makes_one_all_reduce(mesh_kw):
    """SwiGLU with wg/wu column- and wd row-parallel, the residual stream
    batch-sharded: every device does 1/(dp·tp) of the FLOPs, and the
    row-parallel product's partial sums are reduced over the model axis
    by exactly one all-reduce of the device's [B/dp, S, D] bf16
    stream — the policy's one collective, nothing else."""
    cfg = base.get_config("deepseek-7b")
    mcfg = base.MeshConfig(**mesh_kw)
    dp = mcfg.data * mcfg.pod
    B, S = 2 * dp, 8
    with mesh_lib.make_production_mesh(mesh_cfg=mcfg) as mesh:
        mesh = dryrun.step_mesh(mesh, mcfg, base.ShapeConfig("t", S, B,
                                                             "prefill"))
        p, x = _placed_mlp(mesh, cfg, mcfg, B, S, batch_sharded=True)
        counter = dryrun.DeviceCounter()
        with torch.no_grad(), implicit_replication(), counter:
            y = (x + L.mlp(p, x)).redistribute(mesh, x.placements)
        assert y.placements == x.placements
    glob = 3 * 2 * B * S * cfg.d_model * cfg.d_ff
    assert counter.flops * mcfg.num_devices == glob
    coll = counter.collectives()
    assert coll["count_by_op"]["all-reduce"] == 1
    assert sum(coll["count_by_op"].values()) == 1
    assert coll["bytes_by_op"]["all-reduce"] == (B // dp) * S * cfg.d_model * 2
    assert coll["wire_bytes"] == 2 * coll["bytes_by_op"]["all-reduce"]


def _attention_core_flops(cfg, shape) -> int:
    """The einsum attention's q·k and p·v over the full sequence, every
    layer, global."""
    return (cfg.num_layers * 4 * shape.global_batch * cfg.num_heads
            * shape.seq_len ** 2 * cfg.hd)


def _hand_flops(cfg, shape) -> int:
    """The step's product FLOPs, global: each projection, expert and
    head product 2·M·N·K; the einsum attention over the full S (or the
    C-slot cache and the token's own score); training 3× the forward's
    (the backward's two products a product) less the MoE dispatch
    product's gradient toward the dispatch tensor, which nothing
    needs."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    V, L_ = cfg.padded_vocab, cfg.num_layers
    B, S = shape.global_batch, shape.seq_len

    def proj(T):
        return 2 * T * D * (2 * H * hd + 2 * KV * hd)

    def ffn(T, exact):
        if not cfg.num_experts:
            return 6 * T * D * cfg.d_ff, 0
        E, Fe = cfg.num_experts, cfg.expert_d_ff
        g = max(1, T // moe.GROUP_SIZE) if T >= moe.GROUP_SIZE else 1
        while T % g:
            g -= 1
        C = moe.capacity(cfg, T // g, exact)
        dispatch = 2 * T * E * C * D
        return 2 * T * D * E + 2 * dispatch + 6 * g * E * C * D * Fe, dispatch

    if shape.kind == "decode":
        # q·k and p·v over the C cached slots; the token's own score
        # (q·k_new, a product over hd; its p·v_new takes none)
        f, _ = ffn(B, True)
        return (L_ * (4 * B * H * S * hd + proj(B) + f + 2 * B * H * hd)
                + 2 * B * D * V)
    T = B * S
    f, dispatch = ffn(T, False)
    fwd = _attention_core_flops(cfg, shape) + L_ * (proj(T) + f)
    if shape.kind == "prefill":
        return fwd + 2 * B * D * V
    return 3 * (fwd + 2 * T * D * V) - L_ * dispatch


CASES = [("deepseek-7b", "train_4k"), ("deepseek-7b", "prefill_32k"),
         ("deepseek-7b", "decode_32k"), ("granite-moe-3b-a800m", "train_4k"),
         ("granite-moe-3b-a800m", "prefill_32k")]


@pytest.mark.parametrize("mesh", sorted(SMALL))
@pytest.mark.parametrize("arch,shape", CASES)
def test_dry_run_flops_equal_hand_count(arch, shape, mesh):
    """Per-device FLOPs of the placed step equal the hand count: every
    product split over all devices (a decode's attention core runs on
    each device's batch rows and heads, the heads taken locally from
    the cache's model-replicated copy)."""
    cfg = base.reduced(base.get_config(arch))
    mcfg = base.MeshConfig(**SMALL[mesh])
    r = dryrun.dry_run_one(arch, shape, mesh_cfg=mcfg, cfg=cfg)
    shp = base.INPUT_SHAPES[shape]
    assert r["flops_per_dev"] == _hand_flops(cfg, shp) // mcfg.num_devices
    assert r["chips"] == mcfg.num_devices and r["kind"] == shp.kind
    for term in ("compute_s", "memory_s", "collective_s"):
        assert np.isfinite(r[term]) and r[term] > 0, term
    assert r["compute_s"] == r["flops_per_dev"] / mesh_lib.PEAK_FLOPS_BF16
    assert r["collective_s"] == (r["collectives"]["wire_bytes"]
                                 / mesh_lib.NVLINK_BW)
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["argument_size_in_bytes"] > 0 and r["output_size_in_bytes"] > 0


@pytest.mark.parametrize("mesh", sorted(SMALL))
def test_moe_decode_runs_on_the_small_mesh(mesh):
    """Granite's decode places and runs: its 128 tokens form one
    dispatch group, which the batch axes cannot split, so its FLOPs lie
    between an even split and no split at all."""
    cfg = base.reduced(base.get_config("granite-moe-3b-a800m"))
    mcfg = base.MeshConfig(**SMALL[mesh])
    r = dryrun.dry_run_one("granite-moe-3b-a800m", "decode_32k",
                           mesh_cfg=mcfg, cfg=cfg)
    total = _hand_flops(cfg, base.INPUT_SHAPES["decode_32k"])
    assert total / mcfg.num_devices <= r["flops_per_dev"] <= total


def test_granite_production_flops_equal_hand_count():
    """Granite's widths at depth 2 on the 16×16 production mesh: every
    product splits over all 256 devices but the attention core.  Neither
    granite's 24 heads nor its 8 KV heads divide the 16-wide model axis,
    so the head-layout hint replicates q, k and v there, and the core
    splits over the data axis only, as the reference's hint has GSPMD do.
    A product that runs whole on every device of an axis fails the
    count: torch 2.11's plan all-reduces the residual stream where
    2.13's reduce-scatters it, and then runs the MoE's dispatch,
    combine and router products whole on the model axis."""
    cfg = dataclasses.replace(base.get_config("granite-moe-3b-a800m"),
                              num_layers=2)
    shape = base.INPUT_SHAPES["prefill_32k"]
    mcfg = base.MeshConfig()
    r = dryrun.dry_run_one("granite-moe-3b-a800m", "prefill_32k", cfg=cfg)
    core = _attention_core_flops(cfg, shape)
    rest = _hand_flops(cfg, shape) - core
    assert rest % mcfg.num_devices == 0 and core % mcfg.data == 0
    assert r["flops_per_dev"] == rest // mcfg.num_devices + core // mcfg.data


def test_granite_head_hint_shrinks_the_largest_prefill_collective():
    """The reference's G-P3 finding as a direction: with granite's 8 KV
    heads on the 16-wide model axis, the hint (replicate K/V there)
    keeps DTensor from splitting the hd contraction, whose S×S partial
    scores are the prefill's largest collective without it.  Granite's
    own widths at depth 2 on the production mesh: on a 2-wide axis with
    reduced widths every head count divides, and there is nothing for
    the hint to prevent."""
    cfg = dataclasses.replace(base.get_config("granite-moe-3b-a800m"),
                              num_layers=2)
    sizes = {}
    for hint in ("true", "false"):
        r = dryrun.dry_run_one("granite-moe-3b-a800m", "prefill_32k",
                               cfg=cfg,
                               overrides=[f"attn_layout_constraint={hint}"])
        sizes[hint] = r["largest_collective_bytes"]
    assert 0 < sizes["true"] < sizes["false"]


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(SMALL))
def test_protocol_dry_run_round_equals_ledger(mesh):
    mcfg = base.MeshConfig(**SMALL[mesh])
    m, c = 1 << 16, 512
    r = dryrun.protocol_dry_run(m_total=m, coreset=c, mesh_cfg=mcfg)
    k = mcfg.data * mcfg.pod
    cls = weak.Thresholds(n=1 << 20)
    assert r["players"] == k
    assert r["calls_per_round"] == ledger.collective_sites_per_round(cls)
    assert r["round_ran"] == 1 and not r["round_stuck"]
    assert r["rounds"] == BoostConfig(k=k, coreset_size=c,
                                      domain_size=1 << 20).num_rounds(m)
    # coreset x (int32) and y (int8) of every player, their log weight
    # sums (float32); the alive count (int64)
    assert r["collectives"]["bytes_by_op"]["all-gather"] == k * c * 5 + k * 4
    assert r["collectives"]["bytes_by_op"]["all-reduce"] == 8
    assert r["per_attempt_collective_s"] == r["collective_s"] * r["rounds"]
    assert r["memory_s"] > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_writes_a_pair_and_fails_loudly(tmp_path, capsys):
    out = str(tmp_path)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "deepseek-7b", "--shape", "decode_32k",
                     "--set", "num_layers=2", "--tag", "l2", "--out", out])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "deepseek-7b_decode_32k_16x16_l2.json")
                     .read_text())
    assert rec["overrides"] == ["num_layers=2"] and rec["variant"] == "l2"
    assert rec["mesh"] == [16, 16] and rec["chips"] == 256
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                     "--out", out])
    assert e.value.code == 1
    assert "FAIL no-such-arch_decode_32k_16x16" in capsys.readouterr().out
