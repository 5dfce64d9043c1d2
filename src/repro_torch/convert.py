"""Carry protocol state and LM parameters between the JAX package and
the port.

A JAX ``repro.core.batched.StepState`` arrives as a dict of numpy
arrays (``jax.device_get(state)._asdict()``); the port's
:class:`repro_torch.core.batched.StepState` holds the same fields as
tensors — the uint32 key words in int64 — plus ``wsum`` and its
``wsum_shift``, recomputed from ``hits`` and ``alive`` in the mw_update
kernel's summation order, shifted by each row's least alive hit count.
A JAX run stopped after n rounds can so be finished by the port, and
the other way round.  The sharded engines' state dicts carry the same
fields plus their int32 wire counters (:func:`from_jax_sharded`,
:func:`to_jax_sharded`).  The data ``x``/``y`` stays plain numpy on
both sides.

LM parameters: :func:`lm_params_from_jax` loads the reference's params
pytree (numpy leaves, ``jax.device_get(params)``) into the port's
layout, so both implementations compute the same model in the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import batched, sharded_batched
from repro_torch.core.weights import wsums_from_hits
from repro_torch.device import resolve_device


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
    wsum, shift = wsums_from_hits(fields["hits"], fields["alive"],
                                  interpret=True)
    return batched.StepState(**fields, wsum=wsum, wsum_shift=shift)


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


def from_jax_sharded(leaves: dict, device=None) -> dict:
    """Port sharded state (a dict of global tensors) from the numpy
    leaves of a ``repro.core.sharded_batched`` state dict."""
    for name in sharded_batched.WIRE_FIELDS:
        if np.asarray(leaves[name]).dtype != np.int32:
            raise ValueError(f"state leaf {name!r} has dtype "
                             f"{np.asarray(leaves[name]).dtype}, the engine "
                             f"expects int32: refusing a silent cast")
    state = from_jax(leaves, device=device)._asdict()
    dev = state["hits"].device
    for name in sharded_batched.WIRE_FIELDS:
        state[name] = torch.as_tensor(np.array(leaves[name]), device=dev)
    return state


def to_jax_sharded(state: dict) -> dict:
    """The reference's sharded state leaves (numpy) from port sharded
    state."""
    proto = batched.StepState(**{f: state[f]
                                 for f in batched.StepState._fields})
    out = to_jax(proto)
    for name in sharded_batched.WIRE_FIELDS:
        out[name] = state[name].cpu().numpy()
    return out


def lm_params_from_jax(tree: dict, cfg, device=None) -> dict:
    """The port's LM parameters from the reference's params pytree.

    In the reference every block leaf carries a leading
    [num_superblocks] axis (the vmapped init) and ``blocks`` holds one
    stack per pattern position; the port keeps one dict per layer,
    layer s·P + i being superblock s of pattern position i.  The
    encoder-decoder's ``encoder``/``decoder`` stacks (a leading layer
    axis) become lists the same way.  ``linear`` weights are [in, out]
    in both.  Leaves keep their float32 values and land on
    ``device``."""
    from repro_torch.models import transformer

    dev = resolve_device(device)

    def load(node, i=None):
        if isinstance(node, dict):
            return {k: load(v, i) for k, v in node.items()}
        leaf = np.asarray(node) if i is None else np.asarray(node)[i]
        return torch.as_tensor(np.array(leaf, dtype=np.float32), device=dev)

    heads = ("embed", "enc_norm", "final_norm", "lm_head")
    params = {k: load(tree[k]) for k in heads if k in tree}
    if cfg.encoder_layers:
        params["encoder"] = [load(tree["encoder"], i)
                             for i in range(cfg.encoder_layers)]
        params["decoder"] = [load(tree["decoder"], i)
                             for i in range(cfg.num_layers)]
        return params
    transformer.check_pattern(cfg)
    P = cfg.pattern_len
    params["blocks"] = [load(tree["blocks"][layer % P], layer // P)
                        for layer in range(cfg.num_layers)]
    return params
