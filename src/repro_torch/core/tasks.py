"""Synthetic learning tasks for the protocol track (counterpart of
repro.core.tasks, without scenarios, which wait for ROADMAP queue 1,
item 11).

The same numpy RNG calls in the same order as the reference, so the
same seeds give identical arrays: a sample labelled by a random target
from the class, exactly ``noise`` distinct labels flipped (OPT ≤
noise), split among k players contiguously by sort order (the
adversarial split).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Task:
    x: np.ndarray            # [k, m_loc] int32 or [k, m_loc, F] float32
    y: np.ndarray            # [k, m_loc] int8 ±1
    target_params: np.ndarray
    noise_count: int         # flipped labels (OPT ≤ this)
    cls: object

    @property
    def flat_x(self):
        return self.x.reshape((-1,) + self.x.shape[2:])

    @property
    def flat_y(self):
        return self.y.reshape(-1)


def _split(rng, x, y, k, adversarial=True):
    m = x.shape[0]
    if m % k:
        raise ValueError(f"sample size {m} must divide among k={k} players")
    if adversarial:
        order = np.argsort(x if x.ndim == 1 else x[:, 0], kind="stable")
    else:
        order = rng.permutation(m)
    x, y = x[order], y[order]
    return x.reshape((k, m // k) + x.shape[1:]), y.reshape(k, m // k)


def make_task(cls, m: int, k: int, noise: int, seed: int = 0,
              adversarial_split: bool = True) -> Task:
    """Sample m points, label them by a random target in ``cls``, flip
    ``noise`` distinct labels, split among k players.  Labels come from
    the class's own predict on CPU tensors — the rule the engine scores
    hypotheses with."""
    rng = np.random.default_rng(seed)
    x = np.asarray(cls.sample_points(rng, m))
    params = np.asarray(cls.sample_target(rng, x), np.float32)
    y = cls.predict(torch.from_numpy(params), torch.from_numpy(x)).numpy()
    y = y.astype(np.int8)
    if noise > 0:
        flip = rng.choice(m, size=noise, replace=False)
        y[flip] = -y[flip]
    xs, ys = _split(rng, x, y, k, adversarial_split)
    return Task(x=xs, y=ys, target_params=params, noise_count=noise,
                cls=cls)


def make_batch(cls, B: int, m: int, k: int, noise: int, seed0: int = 0,
               adversarial_split: bool = True, scenario: str | None = None):
    """B independent tasks stacked for the batched engine: (x [B, k,
    m/k(, F)], y [B, k, m/k], tasks), task b seeded ``seed0 + b``."""
    if scenario is not None:
        raise NotImplementedError(
            "scenarios need repro.core.scenarios, ROADMAP queue 1, "
            "item 11")
    ts = [make_task(cls, m=m, k=k, noise=noise, seed=seed0 + b,
                    adversarial_split=adversarial_split)
          for b in range(B)]
    return (np.stack([t.x for t in ts]), np.stack([t.y for t in ts]), ts)
