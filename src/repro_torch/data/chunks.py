"""Chunked host→device feed for million-point tasks, the streaming tier
(counterpart of repro.data.chunks).

The streaming consumers (:func:`repro_torch.core.streaming.build_sketch`,
the chunked histograms) fold fixed-size tiles, so a task of m ≥ 10^6
points never needs one monolithic transfer: :func:`iter_chunks` tiles
host arrays, and :func:`prefetch_to_device` hands the consumer
device-resident tiles while the copy of the next ones is in flight.

On the card each tile is staged in pinned host memory and copied on a
stream of its own with ``non_blocking=True``; the copy of tile i+1 is
enqueued before tile i is yielded, the consumer's stream waits on tile
i's copy event, and ``record_stream`` keeps the tile's memory alive for
the consumer.  On the CPU the tiles pass through as CPU tensors over
the same host memory.  Order and values never change.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device


def iter_chunks(arrays: Sequence, chunk_size: int) -> Iterator[tuple]:
    """Tile equal-length host arrays: yields ``(*slices, start)`` per
    ``chunk_size`` tile in index order (the last tile may be ragged);
    ``start`` (an int) is the tile's offset in the whole sample."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be ≥ 1, got {chunk_size}")
    m = len(arrays[0])
    for a in arrays[1:]:
        if len(a) != m:
            raise ValueError("chunked arrays must share their length "
                             f"({len(a)} != {m})")
    for s in range(0, m, chunk_size):
        yield tuple(a[s:min(s + chunk_size, m)] for a in arrays) + (s,)


def _is_array(a) -> bool:
    return isinstance(a, (np.ndarray, torch.Tensor))


class _PinnedCopier:
    """Copies tiles to the card through a ring of pinned host buffers on
    a copy stream of its own.  A ring slot is reused only after the copy
    that last read it has finished (its event)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.bufs: list[dict] = [{} for _ in range(slots)]   # member → buffer
        self.events: list = [None] * slots
        self.turn = 0

    def put(self, chunk: tuple):
        """Stage ``chunk``'s arrays in the next ring slot and enqueue
        their copies (``non_blocking``) on the copy stream: (the tile
        with device tensors, the copies' event)."""
        k = self.turn % len(self.bufs)
        self.turn += 1
        if self.events[k] is not None:
            self.events[k].synchronize()          # the slot's last copy
        out = []
        with torch.cuda.stream(self.stream):
            for j, a in enumerate(chunk):
                if not _is_array(a):
                    out.append(a)
                    continue
                src = torch.as_tensor(a)
                buf = self.bufs[k].get(j)
                if buf is None or buf.numel() < src.numel() \
                        or buf.dtype != src.dtype:
                    buf = torch.empty(src.numel(), dtype=src.dtype,
                                      pin_memory=True)
                    self.bufs[k][j] = buf
                staged = buf[:src.numel()].view(src.shape)
                staged.copy_(src)
                out.append(staged.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[k] = event
        return tuple(out), event

    def hand_over(self, chunk: tuple, event) -> tuple:
        """Make the consumer's stream wait for the tile's copies and keep
        its memory alive there."""
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for a in chunk:
            if isinstance(a, torch.Tensor):
                a.record_stream(consumer)
        return chunk


def prefetch_to_device(chunks: Iterable[tuple], depth: int = 1,
                       device=None) -> Iterator[tuple]:
    """Double-buffered device feed over any chunk iterator: ``depth``
    tiles (default 1, classic double buffering) are in flight beyond
    the one being consumed.  Array members (numpy arrays or tensors)
    arrive on ``device`` (the card unless the caller asks for ``cpu``);
    the trailing ``start`` and any other member pass through untouched,
    and tiles come out in input order."""
    if depth < 1:
        raise ValueError(f"depth must be ≥ 1, got {depth}")
    device = resolve_device(device)
    if device.type == "cpu":
        for chunk in chunks:
            yield tuple(torch.as_tensor(a) if _is_array(a) else a
                        for a in chunk)
        return
    copier = _PinnedCopier(device, depth + 1)
    buf: list[tuple] = []
    for chunk in chunks:
        buf.append(copier.put(chunk))            # enqueue the copy now
        if len(buf) > depth:
            yield copier.hand_over(*buf.pop(0))
    while buf:
        yield copier.hand_over(*buf.pop(0))


def iter_shard_chunks(x: np.ndarray, y: np.ndarray, w: np.ndarray,
                      chunk_size: int, depth: int = 1,
                      device=None) -> Iterator[tuple]:
    """``streaming.build_sketch``'s feed: ``(x, y, w, start)`` tiles of one
    player's shard, double-buffered onto ``device`` — compose with
    ``streaming.build_sketch(iter_shard_chunks(...), cap)``."""
    return prefetch_to_device(iter_chunks((x, y, w), chunk_size),
                              depth=depth, device=device)
