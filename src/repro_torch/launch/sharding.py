"""Sharding policy: parameter, batch and cache partition specs per
(arch, shape) — the port of ``repro.launch.sharding``.

Megatron-style tensor parallel on the ``model`` axis with a safe
fallback: any dimension that does not divide the axis size is
replicated (granite's 40 experts → the per-expert hidden dim is sharded
instead; the K/V projections are sharded on the flattened KV·hd dim,
which divides 16 for every assigned arch).  The batch is sharded over
(pod, data); for the B = 1 long-context decode shape the KV cache is
sharded over ``data`` along its *sequence* axis instead (sequence
parallelism over the cache).

The per-leaf decisions are the reference's.  The port keeps one dict
per layer (``convert.lm_params_from_jax``), so the reference's leading
stack axis on block, encoder and decoder leaves does not exist here
and every spec drops it.  A spec is a :class:`PartitionSpec`: one entry
per tensor dim, each a mesh axis name, a tuple of names or None.
:func:`placements` turns one into DTensor placements on a mesh, and
:func:`distribute` places a tree leaf by leaf.
"""

from __future__ import annotations

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: a tuple with one
    entry per tensor dim; a 1-tuple of names is its one name, as in
    jax."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple)
                                     and len(p) == 1 else p
                                     for p in parts))

    def __repr__(self):
        return "P" + super().__repr__()


P = PartitionSpec

# param leaf names whose matmul OUTPUT dim is sharded (col-parallel)
_COL = {"wq", "wk", "wv", "wg", "wu", "up", "in_proj", "wx", "x_proj",
        "lm_head", "router", "wi", "wf", "dt_proj"}
# names whose INPUT dim is sharded (row-parallel: follows a col-parallel)
_ROW = {"wo", "wd", "down", "out_proj"}


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; a path
    is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_names(path):
    return [str(p) for p in path]


def param_spec_for(path, shape, cfg: ModelConfig, model_size: int):
    names = _path_names(path)

    def ok(dim_size):
        return dim_size % model_size == 0

    # --- embeddings -----------------------------------------------------
    if names[-1] == "emb":
        return P("model", None) if ok(shape[0]) else P(None, None)
    # find owning module name (parent of "w"/"b", or the leaf itself)
    owner = names[-2] if names[-1] in ("w", "b") else names[-1]
    # --- MoE expert tensors [E, D, F] / [E, F, D] ------------------------
    if owner in ("wg", "wu", "wd") and len(shape) == 3:
        if ok(shape[0]):
            return P("model", None, None)              # expert parallel
        # tensor parallel inside experts: shard the per-expert hidden dim
        hid_axis = 2 if owner in ("wg", "wu") else 1
        if ok(shape[hid_axis]):
            spec = [None, None, None]
            spec[hid_axis] = "model"
            return P(*spec)
        return P(None, None, None)
    # --- 2-D matmul weights ----------------------------------------------
    if names[-1] == "w" and len(shape) == 2:
        if owner in _COL and ok(shape[-1]):
            return P(None, "model")
        if owner in _ROW and ok(shape[-2]):
            return P("model", None)
        return P(None, None)
    if names[-1] == "b" and len(shape) == 1:
        if owner in _COL and ok(shape[-1]):
            return P("model")
        return P(None)
    # --- mamba/xlstm vectors over d_inner --------------------------------
    if names[-1] == "A_log" and len(shape) == 2:
        return P("model", None) if ok(shape[0]) else P(None, None)
    if names[-1] in ("D", "dt_bias", "conv_b") and len(shape) == 1:
        return P("model") if ok(shape[-1]) else P(None)
    if names[-1] == "conv_w" and len(shape) == 2:          # [cw, di]
        return P(None, "model") if ok(shape[-1]) else P(None, None)
    # norms, scalars, recurrent R (heads rarely divide): replicate
    return P(*([None] * len(shape)))


def param_specs(params, cfg: ModelConfig, mesh_cfg: MeshConfig):
    """A tree of specs matching the parameter tree (of any device, meta
    included)."""
    return tree_map_with_path(
        lambda path, leaf: param_spec_for(path, tuple(leaf.shape), cfg,
                                          mesh_cfg.model), params)


def batch_partition(cfg: ModelConfig, shape: ShapeConfig,
                    mesh_cfg: MeshConfig):
    """Specs for a training/prefill batch dict."""
    axes = mesh_cfg.batch_axes
    dp = mesh_cfg.data * mesh_cfg.pod
    baxes = axes if shape.global_batch % dp == 0 else ()
    b = baxes if baxes else None

    def spec2(extra=1):
        return P(b, *([None] * extra))

    specs = {
        "tokens": spec2(), "labels": spec2(), "loss_mask": spec2(),
        "weights": P(b), "alive": P(b),
    }
    if cfg.frontend == "vit_stub":
        specs["prefix_embeds"] = P(b, None, None)
    if cfg.encoder_layers:
        specs["frames"] = P(b, None, None)
    return specs


def cache_partition(cache, cfg: ModelConfig, shape: ShapeConfig,
                    mesh_cfg: MeshConfig):
    """Specs for the serving cache tree, keyed on each leaf's name and
    rank (the reference's rank less its stack axis).

    Batch-shard when divisible; otherwise (long_500k, B = 1) shard the
    attention cache over its sequence axis and the recurrent states
    over their (model-sharded) feature axes.
    """
    dp = mesh_cfg.data * mesh_cfg.pod
    batch_ok = shape.global_batch % dp == 0
    baxes = mesh_cfg.batch_axes
    model = mesh_cfg.model

    def leaf_spec(path, leaf):
        nd = leaf.ndim
        shp = tuple(leaf.shape)
        name = _path_names(path)[-1]
        if batch_ok:
            # [B, ...]: shard dim 0
            if nd >= 1:
                return P(baxes, *([None] * (nd - 1)))
            return P()
        # B = 1 long-context: shard the attention cache's sequence (dim
        # 1 of [B, C, KV, hd]) over data; states over model where legal
        if name in ("k", "v") and nd == 4:
            if shp[1] % mesh_cfg.data == 0:
                return P(None, "data", None, None)
            return P(None, None, None, None)
        if name == "h" and nd == 3:                     # mamba [B, di, ds]
            return P(None, "model", None) if shp[1] % model == 0 \
                else P(None, None, None)
        if name == "C" and nd == 4:                     # mlstm C
            return P(None, None, "model", None) if shp[2] % model == 0 \
                else P(None, None, None, None)
        if name == "n" and nd == 3:
            return P(None, None, "model") if shp[2] % model == 0 \
                else P(None, None, None)
        if name in ("h", "c", "n", "m") and nd == 2:    # slstm [B, D]
            return P(None, "model") if shp[1] % model == 0 \
                else P(None, None)
        if name == "conv" and nd == 3:                  # [B, cw-1, di]
            return P(None, None, "model") if shp[2] % model == 0 \
                else P(None, None, None)
        return P(*([None] * nd))

    return tree_map_with_path(leaf_spec, cache)


def opt_specs(pspecs):
    """AdamW state: moments shard like params; step replicated."""
    return {"step": P(), "m": pspecs, "v": pspecs}


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim that the spec names for tensor dim d (both dims of
    ("pod", "data")), ``Replicate()`` on the others and on a mesh dim of
    size 1 (one device holds the whole dim either way).  A tuple of
    names that the mesh holds as one flattened dim, named by joining
    them with "_" as torch names a flattened mesh dim ("pod_data"),
    shards on that dim."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if isinstance(part, tuple) and "_".join(part) in names:
            part = "_".join(part)
        for axis in (part if isinstance(part, tuple) else (part,)):
            if axis is not None and mesh.size(names.index(axis)) > 1:
                out[names.index(axis)] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """``tree`` with every tensor placed on ``mesh`` by its spec in
    ``specs`` (a tree of the same structure): a plain tensor is split
    where it lies, each rank keeping its own shard of its own data
    (``src_data_rank=None``: nothing is sent), and a DTensor is
    redistributed (its collectives run)."""
    def place(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, placements(spec, mesh))
        return distribute_tensor(leaf, mesh, placements(spec, mesh),
                                 src_data_rank=None)

    return tree_map_with_path(place, tree)
