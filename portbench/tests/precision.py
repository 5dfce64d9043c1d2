"""The port's model with its bf16 products run in float32, for tests
whose comparison with the float32 reference is about something other
than the precision of the products."""

import contextlib

import torch

from repro_torch.models import layers, moe


@contextlib.contextmanager
def float32_products():
    """The model's bf16 products (layers' casts, the MoE's buffers) in
    float32."""
    fns = (layers.linear, layers.mlp, layers.embed, layers.unembed)
    saved = [f.__defaults__ for f in fns]
    for f in fns:
        f.__defaults__ = (torch.float32,)
    old = moe.BF16
    moe.BF16 = torch.float32
    try:
        yield
    finally:
        for f, d in zip(fns, saved):
            f.__defaults__ = d
        moe.BF16 = old
