"""Carry protocol state and LM parameters between the JAX package and
the port.

A JAX ``repro.core.batched.StepState`` arrives as a dict of numpy
arrays (``jax.device_get(state)._asdict()``); the port's
:class:`repro_torch.core.batched.StepState` holds the same fields as
tensors — the uint32 key words in int64 — plus ``wsum`` and its
``wsum_shift``, recomputed from ``hits`` and ``alive`` in the mw_update
kernel's summation order, shifted by each row's least alive hit count.
A JAX run stopped after n rounds can so be finished by the port, and
the other way round.  The data ``x``/``y`` stays plain numpy on both
sides.

LM parameters: :func:`lm_params_from_jax` loads the reference's params
pytree (numpy leaves, ``jax.device_get(params)``) into the port's
layout, so both implementations compute the same model in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import batched
from repro_torch.core.approximation import least_alive_hits
from repro_torch.device import resolve_device
from repro_torch.kernels.mw_update import ops as mw_ops


def from_jax(leaves: dict, device=None) -> batched.StepState:
    """Port state from a JAX StepState's numpy leaves."""
    dev = resolve_device(device)
    for name, want in batched.STATE_DTYPES.items():
        if name in leaves and np.asarray(leaves[name]).dtype != want:
            raise ValueError(f"state leaf {name!r} has dtype "
                             f"{np.asarray(leaves[name]).dtype}, the engine "
                             f"expects {want}: refusing a silent cast")
    fields = {}
    for f in batched.StepState._fields:
        if f in batched.PORT_FIELDS:
            continue
        v = np.array(leaves[f])
        if f in batched.KEY_FIELDS:
            v = v.astype(np.int64)
        fields[f] = torch.as_tensor(v, device=dev)
    hits, alive = fields["hits"], fields["alive"]
    B, k, mloc = hits.shape
    shift = least_alive_hits(hits, alive)
    _, wsum = mw_ops.mw_update(hits.reshape(B * k, mloc),
                               torch.zeros_like(alive).reshape(B * k, mloc),
                               alive.reshape(B * k, mloc),
                               shift.reshape(B * k), interpret=True)
    return batched.StepState(**fields, wsum=wsum.reshape(B, k),
                             wsum_shift=shift)


def to_jax(state: batched.StepState) -> dict:
    """JAX StepState leaves (numpy) from port state, key words as
    uint32."""
    out = {}
    for f, v in state._asdict().items():
        if f in batched.PORT_FIELDS:
            continue
        v = v.cpu().numpy()
        out[f] = v.astype(np.uint32) if f in batched.KEY_FIELDS else v
    return out


def lm_params_from_jax(tree: dict, cfg, device=None) -> dict:
    """The port's LM parameters from the reference's params pytree.

    In the reference every block leaf carries a leading
    [num_superblocks] axis (the vmapped init) and ``blocks`` holds one
    stack per pattern position; the port keeps one dict per layer.
    ``linear`` weights are [in, out] in both.  Leaves keep their float32
    values and land on ``device``."""
    from repro_torch.models import transformer

    transformer.check_dense(cfg)
    dev = resolve_device(device)

    def load(leaf):
        return torch.as_tensor(np.array(leaf, dtype=np.float32), device=dev)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return load(np.asarray(node)[i])

    (stack,) = tree["blocks"]
    params = {k: {n: load(v) for n, v in tree[k].items()}
              for k in ("embed", "final_norm", "lm_head") if k in tree}
    params["blocks"] = [layer(stack, i) for i in range(cfg.num_layers)]
    return params
