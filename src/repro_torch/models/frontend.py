"""Modality frontends, stubbed as in the reference
(``repro.models.frontend``): the audio feature extractor and the vision
encoder are not part of the assigned backbones, so a run feeds random
frame or patch embeddings at d_model in their place.

The reference's ``embed_spec`` (a ``jax.ShapeDtypeStruct`` for the TPU
dry run's ``.lower()``) belongs to the launch tooling and is not here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng


def synth_embeds(key: torch.Tensor, cfg, batch: int, positions: int,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """``(jax.random.normal(key, (batch, positions, d_model)) · 0.02)``
    cast to ``dtype``, bit for bit, on the key's device."""
    x = prng.normal(key, (batch, positions, cfg.d_model))
    return x.mul_(float(np.float32(0.02))).to(dtype)
