"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None, meta: bool = False) -> torch.device:
    """``cuda`` unless the caller asks for ``cpu`` (or, where ``meta``
    allows it, ``meta``: shapes and dtypes without memory, as the
    launch tooling's dry run needs).

    Raises when CUDA is asked for (the default) and this host has no
    CUDA device: a run meant for the card never falls back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if meta and dev.type == "meta":
        return dev
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (use 'cuda' or 'cpu')")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "the port on the CPU")
    return dev
