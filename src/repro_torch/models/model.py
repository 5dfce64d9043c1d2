"""Top-level model API — the port of ``repro.models.model`` for serving.

``build(cfg, use_flash)`` returns a :class:`Model` with ``init``,
``logits``, ``make_prefill_step`` and ``make_decode_step``, as in the
reference.  Training (``loss_fn``, ``make_train_step``), the serving
cache spec (``init_serve_cache``) and the encoder-decoder branches wait
(ROADMAP queue 1, item 15).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    use_flash: bool = False

    def init(self, seed: int = 0, device=None) -> dict:
        """Random parameters from ``torch.Generator(device).manual_seed
        (seed)``, on ``device`` (``cuda`` unless the caller asks for
        the CPU).  They are not the reference's numbers for the same
        seed: a test carries the reference's params over with
        :func:`repro_torch.convert.lm_params_from_jax`."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_params(gen, self.cfg)

    def logits(self, params, batch):
        return transformer.forward(params, self.cfg, batch["tokens"],
                                   use_flash=self.use_flash)

    def make_prefill_step(self, window: int = 0):
        cfg = self.cfg

        def prefill_step(params, batch):
            logits, _, caches = transformer.prefill(
                params, cfg, batch["tokens"], use_flash=self.use_flash,
                window=window)
            return logits, caches

        return prefill_step

    def make_decode_step(self, window: int = 0):
        cfg = self.cfg

        def decode_step(params, caches, tokens):
            return transformer.decode_step(params, cfg, caches, tokens,
                                           window=window)

        return decode_step


def build(cfg: ModelConfig, use_flash: bool = False) -> Model:
    transformer.check_dense(cfg)
    return Model(cfg=cfg, use_flash=use_flash)
