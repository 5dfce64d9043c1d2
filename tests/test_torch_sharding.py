"""The port's sharding policy against the reference's, leaf by leaf.

``repro_torch.launch.sharding`` makes the reference's per-leaf
decisions over the port's per-layer trees.  Every port leaf is mapped
to its reference leaf as ``convert.lm_params_from_jax`` maps it (block
layer l is pattern position l mod P at stack index l div P; encoder and
decoder layer i the i-th of their stacks), the reference's spec loses
its stack axis, and the two must be equal, for all ten assigned archs
at full config on the single-pod and the multi-pod mesh.  The port's
trees come from the shape-only init (``Model.init(seed, "meta")``) and
``init_serve_cache(device="meta")``; the reference's from
``jax.eval_shape``.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as j_base
from repro.launch import sharding as j_sharding
from repro.models import build as j_build
from repro_torch.configs import base
from repro_torch.launch import sharding
from repro_torch.models import build

torch.set_num_threads(1)

ARCHS = base.ASSIGNED_ARCHS
MESHES = {"16x16": dict(), "2x16x16": dict(pod=2)}
STACKS = ("blocks", "encoder", "decoder")


@functools.cache
def _ref_params(arch):
    model = j_build(j_base.get_config(arch))
    return jax.eval_shape(model.init, jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.cache
def _port_params(arch):
    return build(base.get_config(arch)).init(0, "meta")


def _ref_path(cfg, path):
    """(reference path, whether its leaf carries a stack axis) of the
    port leaf at ``path``."""
    if path[0] == "blocks":
        return ("blocks", path[1] % cfg.pattern_len) + path[2:], True
    if path[0] in ("encoder", "decoder"):
        return (path[0],) + path[2:], True
    return path, False


def _ref_cache_path(cfg, path):
    if cfg.encoder_layers:                   # (cross, self) stacks
        return (path[0],) + path[2:], True
    return (path[0] % cfg.pattern_len,) + path[1:], True


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _check_tree(port_tree, port_specs, ref_specs, to_ref):
    """Every port leaf's spec against its reference leaf's, less the
    stack axis; returns the number of leaves checked."""
    n = 0
    for path, leaf in _leaves(port_tree):
        rpath, stacked = to_ref(path)
        want = tuple(_at(ref_specs, rpath))
        if stacked:
            assert want[0] is None, (path, want)
            want = want[1:]
        got = tuple(_at(port_specs, path))
        assert got == want, (path, tuple(leaf.shape), got, want)
        assert len(got) == leaf.ndim, (path, got)
        n += 1
    return n


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    cfg, j_cfg = base.get_config(arch), j_base.get_config(arch)
    params = _port_params(arch)
    got = sharding.param_specs(params, cfg, base.MeshConfig(**MESHES[mesh]))
    want = j_sharding.param_specs(_ref_params(arch), j_cfg,
                                  j_base.MeshConfig(**MESHES[mesh]))
    n = _check_tree(params, got, want, lambda p: _ref_path(cfg, p))
    assert n == len(_leaves(params))
    # optimizer state: moments shard like the parameters, step replicated
    opt = sharding.opt_specs(got)
    j_opt = j_sharding.opt_specs(want)
    assert tuple(opt["step"]) == tuple(j_opt["step"]) == ()
    for moment in ("m", "v"):
        _check_tree(params, opt[moment], j_opt[moment],
                    lambda p: _ref_path(cfg, p))


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_equals_eval_shape(arch):
    """The shape-only init is the reference's ``jax.eval_shape(init)``:
    every leaf's shape (less the stack axis) and dtype."""
    cfg = base.get_config(arch)
    params = _port_params(arch)
    ref = _ref_params(arch)
    leaves = _leaves(params)
    for path, leaf in leaves:
        assert leaf.is_meta
        rpath, stacked = _ref_path(cfg, path)
        want = _at(ref, rpath)
        shape = tuple(want.shape[1:] if stacked else want.shape)
        assert tuple(leaf.shape) == shape, (path, leaf.shape, shape)
        assert str(leaf.dtype).split(".")[-1] == str(want.dtype), path
    # and nothing else: one port leaf per layer of each stacked leaf
    assert len(leaves) == sum(leaf.shape[0] if path[0] in STACKS else 1
                              for path, leaf in _leaves(ref))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_partition_equal_reference(arch, mesh, shape):
    cfg, j_cfg = base.get_config(arch), j_base.get_config(arch)
    shp = base.INPUT_SHAPES[shape]
    cache = build(cfg).init_serve_cache(shp, filled=True, device="meta")
    j_model = j_build(j_cfg)
    j_cache = jax.eval_shape(
        lambda: j_model.init_serve_cache(j_base.INPUT_SHAPES[shape],
                                         filled=True))
    got = sharding.cache_partition(cache, cfg, shp,
                                   base.MeshConfig(**MESHES[mesh]))
    want = j_sharding.cache_partition(j_cache, j_cfg,
                                      j_base.INPUT_SHAPES[shape],
                                      j_base.MeshConfig(**MESHES[mesh]))
    for path, leaf in _leaves(cache):
        rpath, _ = _ref_cache_path(cfg, path)
        assert tuple(leaf.shape) == tuple(_at(j_cache, rpath).shape[1:]), path
    n = _check_tree(cache, got, want, lambda p: _ref_cache_path(cfg, p))
    assert n == len(_leaves(cache))


@pytest.mark.parametrize("shape", sorted(base.INPUT_SHAPES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_partition_equal_reference(arch, mesh, shape):
    got = sharding.batch_partition(base.get_config(arch),
                                   base.INPUT_SHAPES[shape],
                                   base.MeshConfig(**MESHES[mesh]))
    want = j_sharding.batch_partition(j_base.get_config(arch),
                                      j_base.INPUT_SHAPES[shape],
                                      j_base.MeshConfig(**MESHES[mesh]))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisibility(arch):
    """Every sharded dim divides the production model axis (16), and
    something shards (the reference's substrate property)."""
    cfg = base.get_config(arch)
    mesh_cfg = base.MeshConfig()
    params = _port_params(arch)
    specs = sharding.param_specs(params, cfg, mesh_cfg)
    n_sharded = 0
    for path, leaf in _leaves(params):
        for dim, ax in enumerate(_at(specs, path)):
            if ax == "model":
                assert leaf.shape[dim] % mesh_cfg.model == 0, (
                    arch, path, leaf.shape)
                n_sharded += 1
    assert n_sharded > 0


class _Mesh:
    """Stands in for a DeviceMesh: ``placements`` reads its dim names
    and sizes."""

    def __init__(self, cfg):
        self.mesh_dim_names = cfg.axis_names
        self.sizes = cfg.shape

    def size(self, i):
        return self.sizes[i]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_placements_of_the_two_axis_batch(mesh):
    mcfg = base.MeshConfig(**MESHES[mesh])
    m = _Mesh(mcfg)
    specs = sharding.batch_partition(base.get_config("deepseek-7b"),
                                     base.INPUT_SHAPES["train_4k"], mcfg)
    tokens = sharding.placements(specs["tokens"], m)
    if mcfg.pod > 1:
        # both dims of ("pod", "data") shard tensor dim 0
        assert tokens == (Shard(0), Shard(0), Replicate())
    else:
        assert tokens == (Shard(0), Replicate())
    assert sharding.placements(sharding.P(None, "model"), m)[-1] == Shard(1)
    assert sharding.placements(sharding.P(), m) == \
        (Replicate(),) * len(mcfg.axis_names)
    # a mesh dim of size 1 replicates
    one = _Mesh(base.MeshConfig(data=1, model=1))
    assert sharding.placements(sharding.P("data", "model"), one) == \
        (Replicate(), Replicate())
    # long_500k (B = 1) is not batch-sharded: replicated everywhere
    long = sharding.batch_partition(base.get_config("deepseek-7b"),
                                    base.INPUT_SHAPES["long_500k"], mcfg)
    assert sharding.placements(long["tokens"], m) == \
        (Replicate(),) * len(mcfg.axis_names)
