"""The model's weights, drawn by the benchmark from ``--seed``.

The parameter tree's layout (names, shapes, float32) comes from the
port's shape-only init, ``Model.init(seed, "meta")``.  Every leaf is a
view of one flat float32 buffer on the device, filled by one
``torch.Generator`` in a few large calls, then scaled as the
configuration's ``assumed.weight_draw`` says: a norm's ``scale`` leaf
is ``mean + std · z``, every other leaf ``std · z``.  The same tensors
go to the program and to the plain reference.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 28            # elements a call of the generator fills


def leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def rebuild(tree, values: dict, prefix: str = ""):
    """``tree`` with each leaf replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, values, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return values[prefix]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed``: the
    weights are stream 0, each kind of input its own stream."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def draw(shapes, seed: int, device, rule: dict):
    """A tree like ``shapes`` (meta tensors) of float32 leaves on
    ``device``, drawn from ``seed``."""
    items = list(leaves(shapes))
    total = sum(t.numel() for _, t in items)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    g = generator(seed, 0, device)
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=g)
    norm = rule["norm_scale"]
    values, off = {}, 0
    for path, t in items:
        leaf = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
        if path.endswith("/scale"):
            leaf.mul_(norm["std"]).add_(norm["mean"])
        else:
            leaf.mul_(rule["std"])
        values[path] = leaf
    return rebuild(shapes, values)
