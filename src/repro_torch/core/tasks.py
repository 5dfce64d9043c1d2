"""Synthetic learning tasks for the protocol track (counterpart of
repro.core.tasks).

The same numpy RNG calls in the same order as the reference, so the
same seeds give identical arrays: a sample labelled by a random target
from the class, exactly ``noise`` distinct labels flipped (OPT ≤
noise), split among k players contiguously by sort order (the
adversarial split).  ``make_batch(scenario=…)`` corrupts through
:mod:`repro_torch.core.scenarios` instead.

:func:`opt_counts` is OPT, the best uniform-weight error count of the
class on the whole sample: the class's own ERM at weights 1/m, rounded
(the reference's ``true_opt``), except for axis stumps, whose counts
come exactly from one launch of the stump kernel.  :func:`pad_shards`
pads shards to a bucket's width with dead rows, and
:func:`shard_chunk_feed` is the streaming tier's double-buffered feed
of one player's shard (``repro_torch.data.chunks``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import weak
from repro_torch.device import resolve_device
from repro_torch.kernels.stump import ops as stump_ops

# the pad threshold of the stump OPT: no finite point reaches it, so it
# gives the two constant classifiers (the reference's j = K candidate)
PAD_THETA = 3.4e38


@dataclasses.dataclass
class Task:
    x: np.ndarray            # [k, m_loc] int32 or [k, m_loc, F] float32
    y: np.ndarray            # [k, m_loc] int8 ±1
    target_params: np.ndarray
    noise_count: int         # flipped labels (OPT ≤ this)
    cls: object
    flipped: np.ndarray | None = None   # [k, m_loc] bool — planted noise
    scenario: str = "uniform"           # which adversary corrupted S

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
    m/k(, F)], y [B, k, m/k], tasks), task b seeded ``seed0 + b``.
    ``scenario`` routes corruption through core/scenarios.py instead of
    the uniform flips (None keeps the uniform flips' RNG stream)."""
    if scenario is not None:
        from repro_torch.core import scenarios
        spec = scenarios.ScenarioSpec(name=scenario, noise=noise)
        return scenarios.make_scenario_batch(
            cls, B, m, k, spec, seed0=seed0,
            adversarial_split=adversarial_split)
    ts = [make_task(cls, m=m, k=k, noise=noise, seed=seed0 + b,
                    adversarial_split=adversarial_split)
          for b in range(B)]
    return (np.stack([t.x for t in ts]), np.stack([t.y for t in ts]), ts)


def pad_shards(x: np.ndarray, y: np.ndarray, mloc: int):
    """Pad one task's per-player shards up to ``mloc`` rows for shape
    bucketing: x [k, mloc0(, F)], y [k, mloc0] → (x_pad, y_pad, alive)
    at [k, mloc(, F)], the appended rows repeating each shard's last
    example and dead in the alive mask, so the engines ignore them."""
    k, mloc0 = y.shape
    if mloc < mloc0:
        raise ValueError(f"bucket mloc={mloc} < task mloc={mloc0}")
    alive = np.ones((k, mloc0), bool)
    pad = mloc - mloc0
    if pad == 0:
        return x, y, alive
    reps = [(0, 0)] * x.ndim
    reps[1] = (0, pad)
    return (np.pad(x, reps, mode="edge"),
            np.pad(y, [(0, 0), (0, pad)], mode="edge"),
            np.pad(alive, [(0, 0), (0, pad)], constant_values=False))


def shard_chunk_feed(task: Task, player: int, chunk_size: int,
                     weights: np.ndarray | None = None, depth: int = 1,
                     device=None):
    """The streaming tier's feed of one player's shard: double-buffered
    ``(x, y, w, start)`` tiles of ``task.x[player]`` on ``device`` (the
    card unless the caller asks for ``cpu``), what
    :func:`repro_torch.core.streaming.build_sketch` consumes.
    ``weights`` defaults to uniform; the integer track feeds its domain
    points, the feature track its first column (the engines' sort
    axis)."""
    from repro_torch.data import chunks

    x = task.x[player]
    if x.ndim > 1:
        x = x[:, 0]
    y = task.y[player]
    w = (np.ones(y.shape, np.float32) if weights is None
         else np.asarray(weights, np.float32))
    return chunks.iter_shard_chunks(x, y, w, chunk_size, depth=depth,
                                    device=device)


def _stump_opt_counts(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Exact OPT of axis stumps on B samples: xs [B, m, F] float32,
    ys [B, m] int8 → int64 [B], from one batched stump-kernel launch.

    The thresholds are the points' own values plus :data:`PAD_THETA`:
    every first occurrence of a sorted value and the constant, the
    reference's candidates (duplicates only repeat one).  With w = 1
    every partial sum is an integer below 2^24, so the errors
    ½(m ∓ (2S − Σy)) are exact in any summation order.
    """
    B, m, F = xs.shape
    if m >= 1 << 24:
        raise ValueError(f"m = {m}: float32 counts are exact below 2^24")
    pad = torch.full((B, F, 1), PAD_THETA, dtype=torch.float32,
                     device=xs.device)
    thetas = torch.cat([xs.transpose(1, 2), pad], dim=-1)    # [B, F, m+1]
    w = torch.ones((B, m), dtype=torch.float32, device=xs.device)
    err = stump_ops.stump_errors(xs, w, ys, thetas.contiguous())
    return torch.round(err.reshape(B, -1).amin(dim=-1)).to(torch.int64)


def opt_counts(cls, xs, ys, device=None) -> np.ndarray:
    """OPT of ``cls`` on each of B samples of one size: xs [B, m(, F)],
    ys [B, m] (numpy or tensors) → int64 [B] on the host, computed on
    ``device`` (the card unless the caller asks for ``cpu``).

    Axis stumps take the exact counts of one stump-kernel launch
    (:func:`_stump_opt_counts`); every other class runs its own ERM at
    weights 1/m and rounds ``loss·m``, as the reference's ``true_opt``
    does (exact for the integer classes, the greedy floor for trees).
    """
    device = resolve_device(device)
    xt = torch.as_tensor(xs, device=device)
    yt = torch.as_tensor(ys, device=device)
    if isinstance(cls, weak.AxisStumps):
        return _stump_opt_counts(xt, yt).cpu().numpy()
    m = yt.shape[-1]
    w = torch.ones(yt.shape, dtype=torch.float32, device=device) / m
    _, loss = cls.erm(xt, yt, w)
    return np.array([int(round(float(v) * m)) for v in loss.cpu()],
                    np.int64)


def true_opt(task: Task, device=None) -> int:
    """OPT of the task's own class on its whole sample (see
    :func:`opt_counts`)."""
    return int(opt_counts(task.cls, task.flat_x[None], task.flat_y[None],
                          device)[0])
