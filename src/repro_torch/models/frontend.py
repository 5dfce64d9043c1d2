"""Modality frontends, stubbed as in the reference
(``repro.models.frontend``): the audio feature extractor and the vision
encoder are not part of the assigned backbones, so a run feeds random
frame or patch embeddings at d_model in their place, and the dry run
places a ``meta`` tensor of their shape (``embed_spec``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng


def embed_spec(cfg, batch: int, positions: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Precomputed frontend embeddings at d_model as a ``meta`` tensor
    (the reference's ShapeDtypeStruct)."""
    return torch.empty((batch, positions, cfg.d_model), dtype=dtype,
                       device="meta")


def synth_embeds(key: torch.Tensor, cfg, batch: int, positions: int,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """``(jax.random.normal(key, (batch, positions, d_model)) · 0.02)``
    cast to ``dtype``, bit for bit, on the key's device."""
    x = prng.normal(key, (batch, positions, cfg.d_model))
    return x.mul_(float(np.float32(0.02))).to(dtype)
