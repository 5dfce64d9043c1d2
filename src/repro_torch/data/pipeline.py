"""Synthetic LM corpus with stable example identity — the port of
``repro.data.pipeline``.

Every example has a persistent id, so the resilient-boosting state
(multiplicative weights and quarantine, :mod:`repro_torch.core.
resilient`) attaches to examples as the paper attaches weights to
sample elements.  A fraction of the examples is noisy: their targets
are an independent random walk, which no model can fit.  The corpus is
built in numpy with the reference's generator calls, so a seed gives
the reference's arrays; batches come out as tensors on the caller's
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 64
    num_examples: int = 4096
    noise_frac: float = 0.0        # fraction of unlearnable examples
    branching: int = 4             # Markov successors per token
    seed: int = 0


class SyntheticCorpus:
    """Materialized synthetic corpus (host memory, numpy): a Markov
    chain over the vocab, fixed per seed."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, S, N = cfg.vocab_size, cfg.seq_len, cfg.num_examples
        self.successors = rng.integers(0, V, size=(V, cfg.branching))
        starts = rng.integers(0, V, size=N)
        choices = rng.integers(0, cfg.branching, size=(N, S))
        toks = np.empty((N, S + 1), np.int32)
        toks[:, 0] = starts
        for s in range(S):
            toks[:, s + 1] = self.successors[toks[:, s], choices[:, s]]
        self.tokens = toks[:, :-1]
        self.labels = toks[:, 1:].copy()
        n_noise = int(cfg.noise_frac * N)
        self.noisy_ids = rng.choice(N, size=n_noise, replace=False)
        if n_noise:
            self.labels[self.noisy_ids] = rng.integers(
                0, V, size=(n_noise, S))
        self.ids = np.arange(N, dtype=np.int32)

    def batch(self, rng: np.random.Generator, batch_size: int,
              alive: np.ndarray | None = None, device=None) -> dict:
        """A batch of alive examples (uniform over alive), drawn with the
        reference's generator call.  ``ids`` stays a host int array (the
        resilient bookkeeping runs on the host); the rest are tensors
        on ``device`` (``cuda`` unless the caller asks for the CPU)."""
        dev = resolve_device(device)
        pool = self.ids if alive is None else self.ids[alive]
        idx = rng.choice(pool, size=batch_size,
                         replace=batch_size > pool.size)
        return {
            "ids": np.asarray(idx),
            "tokens": torch.from_numpy(self.tokens[idx]).to(dev),
            "labels": torch.from_numpy(self.labels[idx]).to(dev),
            "loss_mask": torch.ones((batch_size, self.cfg.seq_len),
                                    dtype=torch.float32, device=dev),
        }


def make_batch(key: torch.Tensor, cfg, batch: int, seq: int) -> dict:
    """Random batch for shape and smoke tests (no corpus), on the key's
    device: tokens from ``prng.randint``, as ``jax.random.randint``."""
    toks = prng.randint(key, (batch, seq), 0, min(cfg.vocab_size, 1 << 15))
    dev = key.device
    return {
        "tokens": toks,
        "labels": torch.roll(toks, -1, dims=1),
        "loss_mask": torch.ones((batch, seq), dtype=torch.float32,
                                device=dev),
        "weights": torch.ones((batch,), dtype=torch.float32, device=dev),
        "alive": torch.ones((batch,), dtype=torch.float32, device=dev),
    }


def batch_specs(cfg, shape, dtype_tokens=torch.int32) -> dict:
    """A training batch's shapes and dtypes as ``meta`` tensors (the
    reference's ShapeDtypeStructs for its dry run)."""
    B, S = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    return {
        "tokens": spec((B, S), dtype_tokens),
        "labels": spec((B, S), dtype_tokens),
        "loss_mask": spec((B, S), torch.float32),
        "weights": spec((B,), torch.float32),
        "alive": spec((B,), torch.float32),
    }
