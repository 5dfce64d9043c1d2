"""Carry protocol state between the JAX engine and the port.

A JAX ``repro.core.batched.StepState`` arrives as a dict of numpy
arrays (``jax.device_get(state)._asdict()``); the port's
:class:`repro_torch.core.batched.StepState` holds the same fields as
tensors — the uint32 key words in int64 — plus ``wsum``, recomputed
from ``hits`` and ``alive`` in the mw_update kernel's summation order.
A JAX run stopped after n rounds can so be finished by the port, and
the other way round.  The data ``x``/``y`` stays plain numpy on both
sides.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import batched
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
        if f == "wsum":
            continue
        v = np.array(leaves[f])
        if f in batched.KEY_FIELDS:
            v = v.astype(np.int64)
        fields[f] = torch.as_tensor(v, device=dev)
    hits, alive = fields["hits"], fields["alive"]
    B, k, mloc = hits.shape
    _, wsum = mw_ops.mw_update(hits.reshape(B * k, mloc),
                               torch.zeros_like(alive).reshape(B * k, mloc),
                               alive.reshape(B * k, mloc), interpret=True)
    return batched.StepState(**fields, wsum=wsum.reshape(B, k))


def to_jax(state: batched.StepState) -> dict:
    """JAX StepState leaves (numpy) from port state, key words as
    uint32."""
    out = {}
    for f, v in state._asdict().items():
        if f == "wsum":
            continue
        v = v.cpu().numpy()
        out[f] = v.astype(np.uint32) if f in batched.KEY_FIELDS else v
    return out
