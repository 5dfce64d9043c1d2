"""The one generator of traffic: token ids and arrival times from
``--seed`` and a traffic file's parameters.

A traffic file (``traffic/<name>.json``) names its driver and gives its
sizes; the drivers read them through this module, so a new mix at other
lengths, batches or rates is a new data file.  Every seed gets the same
sizes and arrivals; the seed changes only which token ids are drawn.
"""

from __future__ import annotations

import time

import torch

from portbench import weights

# generator streams of one seed (stream 0 draws the weights)
PROMPTS, WARMUP, FRESH, SAMPLE = 1, 2, 3, 4


class Prompts:
    """Batches of ``batch`` prompts of ``length`` token ids in
    [0, vocab), drawn in order from one stream: batch i is the same for
    a seed whatever else the run does."""

    def __init__(self, seed, stream, batch, length, vocab, device):
        self._g = weights.generator(seed, stream, device)
        self._shape = (batch, length)
        self._vocab = vocab
        self._device = device
        self._drawn = []

    def __getitem__(self, i: int) -> torch.Tensor:
        while len(self._drawn) <= i:
            self._drawn.append(torch.randint(
                0, self._vocab, self._shape, generator=self._g,
                device=self._device, dtype=torch.int32))
        return self._drawn[i]


def sample(seed: int, n: int, k: int) -> list:
    """``k`` of ``n`` indices, drawn from the seed (on the CPU), sorted;
    the last index is always in it."""
    if n <= k:
        return list(range(n))
    g = weights.generator(seed, SAMPLE, "cpu")
    pick = torch.randperm(n - 1, generator=g)[:k - 1].tolist()
    return sorted(pick) + [n - 1]


def wait_until(t: float) -> None:
    """Sleep, then spin, until ``time.perf_counter()`` reaches ``t``."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 2e-3:
            time.sleep(left - 1e-3)
