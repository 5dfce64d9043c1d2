"""The models' DTensor paths against their plain paths, on real values.

The launch tooling places the models on a mesh as DTensors
(``repro_torch.launch``).  Where a DTensor needs more than the plain
op, the models fork: the MoE's one-hot dispatch (an indexed write has
no DTensor rule), the attention cache's slot-mask write, the gold logit
as a one-hot masked sum, ``layers.reshape`` (uneven shards fitted before
a split), and ``layers.on_local``/``on_rows`` (attention's core on each
device's batch and head block, the xLSTM recurrences on its batch
rows).  Each fork is held here against the plain path on the same
inputs: on plain tensors where the fork takes them, on a 1-rank gloo
mesh for the rest, and in a 4-rank gloo world on a (2, 2) host mesh,
where every mesh dim shards, through reduced granite-moe and xLSTM
prefill, decode and loss gradients.  Products run in float32 in the
world's comparison, so what differs is the summation order only.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils import _pytree as pytree

from repro_torch.configs import base
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention, build, layers as L, moe, xlstm
from repro_torch.models.model import cross_entropy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a process group outlived its test"


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------------------
# the MoE's one-hot dispatch, on plain tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,Tg,Ep,K,C", [(2, 16, 4, 2, 3), (3, 32, 8, 2, 16),
                                         (1, 64, 40, 8, 5), (2, 8, 4, 1, 8)])
def test_one_hot_dispatch_equals_indexed_dispatch(G, Tg, Ep, K, C):
    """The DTensor fork's dispatch and combine tensors are the indexed
    write's, bit for bit, with choices dropped past capacity (C small)
    and with none dropped."""
    g = _gen(G * Tg + Ep)
    idx = torch.stack([torch.randperm(Ep, generator=g)[:K]
                       for _ in range(G * Tg)]).reshape(G, Tg, K)
    gates = torch.rand(G, Tg, K, generator=g)
    want = moe._indexed_dispatch(idx, gates, Ep, C)
    got = moe._one_hot_dispatch(idx, gates, Ep, C)
    for w, o in zip(want, got):
        assert o.dtype == w.dtype and o.shape == w.shape
        torch.testing.assert_close(o, w, rtol=0, atol=0)
    if C < Tg * K // Ep:
        assert want[0].sum() < G * Tg * K          # some choices dropped


# ---------------------------------------------------------------------------
# forks on a 1-rank gloo mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh():
    with mesh_lib.make_host_mesh(device="cpu") as m:
        yield m


def _place(t, mesh, *placements):
    return distribute_tensor(t.clone(), mesh, placements)


def _replicated(tree, mesh):
    return pytree.tree_map(lambda t: _place(t, mesh, Replicate(), Replicate()),
                           tree)


@pytest.mark.parametrize("placement", [Replicate(), Shard(0), Shard(1),
                                       Shard(2)])
def test_write_slot_equals_index_write(mesh, placement):
    """The slot-mask write of a DTensor cache puts each row's new K/V in
    its slot and leaves every other slot as it was, as the index write
    does, whatever dim the cache shards."""
    B, C, KV, hd = 3, 5, 2, 4
    g = _gen(1)
    cache = torch.randn(B, C, KV, hd, generator=g)
    new = torch.randn(B, 1, KV, hd, generator=g)
    widx = torch.tensor([0, 3, 4])
    want = cache.clone()
    want[torch.arange(B), widx] = new[:, 0]
    placed = _place(cache, mesh, placement, Replicate())
    hit = (torch.arange(C)[None, :] == widx[:, None])[:, :, None, None]
    rep = (Replicate(), Replicate())
    attention._write_slot(placed, _place(new, mesh, *rep),
                          _place(hit, mesh, *rep))
    assert placed.placements == (placement, Replicate())
    torch.testing.assert_close(placed.full_tensor(), want, rtol=0, atol=0)


def test_dtensor_cross_entropy_equals_gather(mesh):
    """The gold logit as a one-hot masked sum (vocab-sharded logits)
    equals ``torch.gather``'s, loss and gradient."""
    B, S, V = 2, 6, 40
    g = _gen(2)
    logits = torch.randn(B, S, V, generator=g)
    labels = torch.randint(0, V, (B, S), generator=g, dtype=torch.int32)
    mask = (torch.rand(B, S, generator=g) > 0.3).float()
    plain = logits.clone().requires_grad_()
    want = cross_entropy(plain, labels, mask)
    want.sum().backward()
    placed = _place(logits, mesh, Shard(0), Shard(2)).requires_grad_()
    with implicit_replication():        # the vocab's arange is plain
        got = cross_entropy(placed,
                            _place(labels, mesh, Shard(0), Replicate()),
                            _place(mask, mesh, Shard(0), Replicate()))
        got.sum().backward()
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(placed.grad.full_tensor(), plain.grad,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("old,new,placement", [
    ((2, 3, 24), (2, 3, 8, 3), Shard(2)),       # split (the heads)
    ((2, 3, 8, 3), (2, 3, 24), Shard(2)),       # merge
    ((4, 6, 5), (2, 12, 5), Shard(0)),          # regroup (the MoE's)
    ((4, 1, 5), (1, 4, 5), Shard(0)),           # regroup of one token
])
def test_reshape_equals_plain_reshape(mesh, old, new, placement):
    """``layers.reshape`` of a DTensor: the plain reshape's values, and
    its gradient."""
    x = torch.randn(*old, generator=_gen(3))
    up = torch.randn(*new, generator=_gen(4))
    plain = x.clone().requires_grad_()
    (plain.reshape(new) * up).sum().backward()
    placed = _place(x, mesh, placement, Replicate()).requires_grad_()
    y = L.reshape(placed, *new)
    assert isinstance(y, DTensor) and tuple(y.shape) == new
    (y * _place(up, mesh, Replicate(), Replicate())).sum().backward()
    torch.testing.assert_close(y.full_tensor(), x.reshape(new), rtol=0,
                               atol=0)
    torch.testing.assert_close(placed.grad.full_tensor(), plain.grad,
                               rtol=0, atol=0)


def test_attention_on_blocks_equals_direct_call(mesh):
    """q, k, v that shard both their batch and their heads take the
    block path (``layers.on_local``): the direct call's output, for the
    full-sequence core and for decode over a cache."""
    B, S, H, KV, hd, C = 2, 5, 4, 2, 8, 6
    g = _gen(5)
    q, k, v = (torch.randn(B, S, n, hd, generator=g) for n in (H, KV, KV))
    mask = attention.causal_mask(S, S)[None].expand(B, S, S)
    place = (Shard(0), Shard(2))
    pq, pk, pv = (_place(t, mesh, *place) for t in (q, k, v))
    assert attention._blocks(pq, pk, pv) is not None
    got = attention.gqa_scores_mask(pq, pk, pv, mask)
    want = attention._gqa_core(q, k, v, mask)
    torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=0)

    q1, kn, vn = (torch.randn(B, 1, n, hd, generator=g) for n in (H, KV, KV))
    ka, va = (torch.randn(B, C, KV, hd, generator=g) for _ in "kv")
    live = torch.rand(B, C, generator=g) > 0.4
    blocks = attention._blocks(*(_place(t, mesh, *place)
                                 for t in (q1, kn, vn)))
    run = L.on_local(attention._decode_core, *blocks, "hhhhhm", "h")
    got = run(*(_place(t, mesh, *place) for t in (q1, kn, vn, ka, va)), live)
    want = attention._decode_core(q1, kn, vn, ka, va, live)
    torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_on_rows_equals_direct_call(mesh, kind):
    """An xLSTM layer on batch-sharded DTensors runs its recurrence on
    each device's rows (``layers.on_rows``): the plain layer's output
    and final state."""
    cfg = base.reduced(base.get_config("xlstm-1.3b"), d_model=32)
    init, fwd = ((xlstm.mlstm_init, xlstm.mlstm_forward) if kind == "mlstm"
                 else (xlstm.slstm_init, xlstm.slstm_forward))
    from repro_torch.core import prng

    p = init(prng.key(0, "cpu"), cfg)
    x = torch.randn(2, 9, cfg.d_model, generator=_gen(6)).to(torch.bfloat16)
    y, st = fwd(p, cfg, x)
    with implicit_replication():
        gy, gst = fwd(_replicated(p, mesh), cfg,
                      _place(x, mesh, Shard(0), Replicate()))
    assert isinstance(gy, DTensor)
    torch.testing.assert_close(gy.full_tensor(), y, rtol=0, atol=0)
    for n in st:
        torch.testing.assert_close(gst[n].full_tensor(), st[n], rtol=0,
                                   atol=0)


def test_moe_apply_on_dtensor_equals_plain(mesh):
    """The MoE FFN on a DTensor batch (the regrouping reshape, the
    one-hot dispatch) against the plain FFN (the indexed dispatch)."""
    cfg = base.reduced(base.get_config("granite-moe-3b-a800m"), d_model=64)
    from repro_torch.core import prng

    p = moe.init(prng.key(0, "cpu"), cfg)
    x = torch.randn(4, 512, cfg.d_model, generator=_gen(7)).to(torch.bfloat16)
    y, aux = moe.apply(p, cfg, x)
    with implicit_replication():
        gy, gaux = moe.apply(_replicated(p, mesh), cfg,
                             _place(x, mesh, Shard(0), Replicate()))
    torch.testing.assert_close(gy.full_tensor(), y, rtol=0, atol=0)
    torch.testing.assert_close(gaux.full_tensor(), aux, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# a 4-rank gloo world on a (2, 2) host mesh
# ---------------------------------------------------------------------------

WORLD_TOL = 1e-4            # float32 products, summed in other orders

_RANK = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils import _pytree as pytree

torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
from repro_torch.configs import base
from repro_torch.core import prng
from repro_torch.launch import dryrun, mesh as mesh_lib, sharding
from repro_torch.models import build, layers as L, moe

# float32 products on both paths: what differs is the summation order
for f in (L.linear, L.mlp, L.embed, L.unembed):
    f.__defaults__ = (torch.float32,)
moe.BF16 = torch.float32
# the backward of F.logsigmoid has no DTensor rule (xLSTM's gates)
dryrun.register_fallbacks()


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def err(got, want):
    return max(((full(a).double() - b.double()).abs().max().item()
                for a, b in zip(pytree.tree_leaves(got),
                                pytree.tree_leaves(want))
                if torch.is_tensor(b) and b.is_floating_point()), default=0.0)


def scale(want):
    return max(b.double().abs().max().item() for b in pytree.tree_leaves(want)
               if torch.is_tensor(b) and b.is_floating_point())


mcfg = base.MeshConfig(data=2, model=2)
B, S = 4, 12
res = {}
with mesh_lib.make_host_mesh(model=2, device="cpu") as mesh:
    assert tuple(mesh.shape) == (2, 2)
    for arch in ARCHS:
        cfg = base.reduced(base.get_config(arch), d_model=64, vocab=96)
        model = build(cfg, use_flash=False)
        params = model.init(0, "cpu")
        pspecs = sharding.param_specs(params, cfg, mcfg)
        placed = sharding.distribute(params, pspecs, mesh)
        n_sharded = sum(any(not p.is_replicate() for p in t.placements)
                        for t in pytree.tree_leaves(placed))
        shape = base.ShapeConfig("t", S, B, "train")
        parts = sharding.batch_partition(cfg, shape, mcfg)
        g = torch.Generator().manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=g, dtype=torch.int32),
                 "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=g, dtype=torch.int32),
                 "loss_mask": (torch.rand(B, S, generator=g) > 0.2).float(),
                 "weights": torch.rand(B, generator=g) + 0.5,
                 "alive": torch.tensor([1.0, 1.0, 0.0, 1.0])}
        pbatch = sharding.distribute(batch, {k: parts[k] for k in batch},
                                     mesh)
        prefill = model.make_prefill_step()
        decode = model.make_decode_step()
        r = {"sharded_leaves": n_sharded}
        with torch.no_grad(), implicit_replication():
            want, wc = prefill(params, {"tokens": batch["tokens"]})
            got, gc = prefill(placed, {"tokens": pbatch["tokens"]})
            r["prefill"] = err(got, want) / scale(want)
            dshape = base.ShapeConfig("t", S, B, "decode")
            gc = sharding.distribute(
                gc, sharding.cache_partition(gc, cfg, dshape, mcfg), mesh)
            r["cache"] = err(gc, wc) / scale(wc)
            r["decode"] = 0.0
            tok = want.argmax(-1).to(torch.int32)[:, None]
            for _ in range(3):
                ptok = sharding.distribute(
                    tok, sharding.P(mcfg.batch_axes, None), mesh)
                want, wc = decode(params, wc, tok)
                got, gc = decode(placed, gc, ptok)
                r["decode"] = max(r["decode"], err(got, want) / scale(want))
                tok = want.argmax(-1).to(torch.int32)[:, None]
            r["decode_cache"] = err(gc, wc) / scale(wc)
        leaves = [t.requires_grad_() for t in pytree.tree_leaves(params)]
        pleaves = [t.requires_grad_() for t in pytree.tree_leaves(placed)]
        with implicit_replication():
            want, _ = model.loss_fn(params, batch)
            want.backward()
            got, _ = model.loss_fn(placed, pbatch)
            got.backward()
        r["loss"] = abs(full(got).item() - want.item()) / abs(want.item())
        r["grads"] = max(err(b.grad, a.grad) / max(a.grad.abs().max().item(),
                                                   1e-30)
                         for a, b in zip(leaves, pleaves))
        res[arch] = r
if rank == 0:
    with open(out, "w") as f:
        json.dump(res, f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""

WORLD_ARCHS = ["granite-moe-3b-a800m", "xlstm-1.3b"]


@pytest.mark.xdist_group(name="device_mesh_subprocess")
def test_four_rank_host_mesh_equals_plain_model(tmp_path):
    """Reduced granite-moe (head-sharded attention blocks under the
    head-layout hint, the one-hot dispatch, the slot-mask cache write)
    and xLSTM (the recurrences on each device's rows) on a (2, 2) host
    mesh of 4 gloo ranks, parameters placed by ``param_specs``, the
    batch by ``batch_partition``, the caches by ``cache_partition``:
    prefill logits and caches, 3 decode steps, the loss and every
    parameter's gradient equal the plain model's within WORLD_TOL of
    their scale."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = str(tmp_path / "world.json")
    src = f"ARCHS = {WORLD_ARCHS!r}\n" + _RANK
    procs = [subprocess.Popen(
        [sys.executable, "-c", src, str(r), str(tmp_path / "store"), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-4000:]
        assert "RANK_OK" in stdout
    with open(out) as f:
        res = json.load(f)
    assert sorted(res) == sorted(WORLD_ARCHS)
    for arch, r in res.items():
        assert r["sharded_leaves"] > 0, arch
        for k in ("prefill", "cache", "decode", "decode_cache", "loss",
                  "grads"):
            assert r[k] <= WORLD_TOL, (arch, k, r[k])
