"""AdamW and SGD over nested dicts and lists of tensors, plus schedules
and clipping — the port of ``repro.optim.adamw``.

Plain functions in the reference's order of operations, in float32 on
the parameters' device; no ``torch.optim``.  Leaves are visited in the
reference's tree order (dict keys sorted, lists in order), so the
global norm sums them as the reference does.  Schedules take the step
as an int (or an int tensor) and return a float32 0-d tensor.
"""

from __future__ import annotations

import math

import torch


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def clip_by_global_norm(grads, max_norm: float):
    """(grads · min(1, max_norm / max(‖g‖, 1e-9)), ‖g‖)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def cosine_schedule(step, base_lr: float, total_steps: int,
                    final_frac: float = 0.1):
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    return base_lr * (final_frac + (1 - final_frac)
                      * 0.5 * (1 + torch.cos(math.pi * t)))


def linear_warmup_cosine(step, base_lr: float, warmup: int,
                         total_steps: int, final_frac: float = 0.1):
    step = _f32(step)
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    cos = cosine_schedule(torch.clamp(step - warmup, min=0.0), base_lr,
                          max(total_steps - warmup, 1), final_frac)
    return torch.where(step < warmup, warm, cos)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> dict:
    first = tree_leaves(params)[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                          params)}


def adamw_update(params, grads, state, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step: (new params, new state); ``lr`` a float or a
    0-d tensor."""
    step = state["step"] + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    return _unzip(out, 0), {"step": step, "m": _unzip(out, 1),
                            "v": _unzip(out, 2)}


def _unzip(tree, i):
    """The i-th member of every tuple leaf of a :func:`tree_map`
    result."""
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unzip(t, i) for t in tree]
    return tree[i]


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------

def sgd_init(params) -> dict:
    first = tree_leaves(params)[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=first.device),
            "mom": tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)}


def sgd_update(params, grads, state, *, lr, momentum: float = 0.9,
               weight_decay: float = 0.0):
    step = state["step"] + 1

    def upd(p, g, m):
        g = g.float() + weight_decay * p.float()
        m = momentum * m + g
        return (p.float() - lr * m).to(p.dtype), m

    out = tree_map(upd, params, grads, state["mom"])
    return _unzip(out, 0), {"step": step, "mom": _unzip(out, 1)}
