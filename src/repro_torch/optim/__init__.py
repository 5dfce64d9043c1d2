"""Optimizers of the port (counterpart of ``repro.optim``)."""

from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule,
                                     linear_warmup_cosine, sgd_init,
                                     sgd_update)

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine", "sgd_init",
           "sgd_update"]
