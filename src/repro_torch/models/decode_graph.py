"""The decode step replayed as one CUDA graph.

A decode step of a decoder-only attention stack launches the same
kernels on the same buffers every step: only the tokens and each
layer's ``len`` change, and the decode attention kernel reads ``len``
on the device.  :class:`DecodeGraphs` records the step once as a
``torch.cuda.CUDAGraph`` and replays it, so the host enqueues a step
with one graph launch instead of one launch per kernel.  No kernel,
precision or piece of the maths changes: the graph records the same
eager step that runs otherwise.

It engages only on what it can observe in its input
(:func:`eager_reason`): a stack whose mixers are all attention with an
MLP or MoE FFN and no encoder (Mamba and xLSTM states come back as new
tensors, so their steps stay eager), CUDA tensors, plain caches (not
the dry run's DTensors), no tensor that requires grad, and no capture
already running.  Every other step runs eagerly, as before.

Graphs are kept per key: the device, the tokens' shape and dtype, the
storage, shape, strides and dtype of every parameter and of each
layer's K/V, each ``len``'s shape and dtype, and the decode attention
entry point (a patched entry point, such as a plain version swapped
in, is captured anew).  The eager step's ``window`` is fixed for the
closure that owns the graphs.  For a new key the first call runs the
step eagerly on a side stream (the warm-up ``torch.cuda.graphs``
requires: cuBLAS's workspace for that stream, the kernel's module
load), the second captures the step on that stream and replays it,
and every later call replays it.  At most ``MAX_GRAPHS`` keys are
kept, the least recently used dropped first.

Before a replay the caller's tokens, and each ``len`` that is not
already the graph's own buffer, are copied into the graph's buffers;
the graph advances its ``len`` buffers in place (``len + 1``) and the
returned caches hold them.  K/V is never copied: the graph writes the
caller's cache in place, as the eager step does.  The logits are a
fresh copy of the graph's output, so they survive the next replay; the
copies come from a memory pool of the graph's own, where the blocks of
dropped copies wait for the next ones (no ``cudaMalloc`` once warm).

The decode attention wrapper counts its launches in Python, which a
replay does not run: at capture the count the step added is recorded
and each replay adds it again.  The default metrics registry counts
``decode_graph.captures``, ``decode_graph.replays`` and
``decode_graph.eager_steps`` (warm-up steps included), and each replay
runs inside a ``decode_graph`` span (category ``model``).
"""

from __future__ import annotations

import collections
import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.models import transformer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

MAX_GRAPHS = 4


def graphable(cfg) -> bool:
    """Whether the step of ``cfg``'s stack can be recorded: every mixer
    attention (whose K/V ring is written in place), every FFN an MLP
    or MoE, no encoder."""
    return not cfg.encoder_layers and all(
        mixer == "attn" and ffn in ("mlp", "moe")
        for mixer, ffn in transformer.layer_kinds(cfg))


def eager_reason(cfg, leaves, caches, tokens) -> str | None:
    """Why a step must run eagerly (``"stack"``, ``"dtensor"``,
    ``"grad"``, ``"device"``, ``"capturing"``), or None where the graph
    may record it; ``leaves`` are the parameters' tensors."""
    if not graphable(cfg):
        return "stack"
    tensors = [*leaves, tokens, *(t for c in caches for t in c.values())]
    # lists, not generators: this runs every step over every parameter
    if any([isinstance(t, DTensor) for t in tensors]):
        return "dtensor"
    if any([t.requires_grad for t in tensors]):
        return "grad"
    if not all([t.is_cuda for t in tensors]):
        return "device"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


def leaves(tree, out=None) -> list:
    """The tensors of a tree of dicts, lists and tuples, in the order
    its containers hold them (no sort: this runs every step)."""
    out = [] if out is None else out
    if isinstance(tree, (dict, list, tuple)):
        for sub in tree.values() if isinstance(tree, dict) else tree:
            leaves(sub, out)
    else:
        out.append(tree)
    return out


def _sig(t: torch.Tensor) -> tuple:
    return t.data_ptr(), t.shape, t.stride(), t.dtype


def graph_key(leaves, caches, tokens) -> tuple:
    """What a recorded step depends on beyond the values the replay
    copies in (tokens, ``len``)."""
    return (tokens.device, tokens.shape, tokens.dtype,
            decode_ops.decode_attention, tuple([_sig(t) for t in leaves]),
            tuple([(_sig(c["k"]), _sig(c["v"]), c["len"].shape,
                    c["len"].dtype) for c in caches]))


@dataclasses.dataclass
class _Entry:
    """One key's stream (the warm-up's and the capture's) and, once
    captured, its graph, static buffers, the pool its replays' logits
    are allocated from, and its launch count."""
    stream: torch.cuda.Stream
    graph: torch.cuda.CUDAGraph | None = None
    tokens: torch.Tensor | None = None
    lens: list = dataclasses.field(default_factory=list)
    logits: torch.Tensor | None = None
    outputs: torch.cuda.MemPool | None = None
    launches: int = 0


class DecodeGraphs:
    """``step(params, caches, tokens) → (logits, caches)``, the eager
    decode step of ``cfg``, replayed as a CUDA graph where
    :func:`eager_reason` allows; one instance per
    ``Model.make_decode_step`` closure."""

    def __init__(self, cfg, step):
        self.cfg = cfg
        self._step = step
        self._graphable = graphable(cfg)
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def __call__(self, params, caches, tokens):
        reg = obs_metrics.default_registry()
        found = leaves(params) if self._graphable else []
        if eager_reason(self.cfg, found, caches, tokens) is not None:
            reg.counter("decode_graph.eager_steps").inc()
            return self._step(params, caches, tokens)
        key = graph_key(found, caches, tokens)
        entry = self._entries.get(key)
        if entry is None:
            entry = _Entry(torch.cuda.Stream(tokens.device))
            self._entries[key] = entry
            while len(self._entries) > MAX_GRAPHS:
                self._entries.popitem(last=False)
            reg.counter("decode_graph.eager_steps").inc()
            return self._warm_up(entry, params, caches, tokens)
        self._entries.move_to_end(key)
        if entry.graph is None:
            self._capture(entry, params, caches, tokens)
            reg.counter("decode_graph.captures").inc()
        reg.counter("decode_graph.replays").inc()
        return self._replay(entry, caches, tokens)

    def _warm_up(self, entry, params, caches, tokens):
        """The eager step on the entry's side stream."""
        cur = torch.cuda.current_stream(tokens.device)
        entry.stream.wait_stream(cur)
        with torch.cuda.stream(entry.stream):
            out = self._step(params, caches, tokens)
        cur.wait_stream(entry.stream)
        return out

    def _capture(self, entry, params, caches, tokens):
        """Record the step on the entry's stream, over static tokens and
        ``len`` buffers, the caller's K/V and parameters; the decode
        attention launches it counted are put back and kept for the
        replays."""
        entry.tokens = torch.empty_like(tokens,
                                        memory_format=torch.contiguous_format)
        entry.lens = [torch.empty_like(c["len"]) for c in caches]
        own = [dict(c, len=n) for c, n in zip(caches, entry.lens)]
        before = decode_ops.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=entry.stream):
            logits, out = self._step(params, own, entry.tokens)
            torch._foreach_copy_(entry.lens, [c["len"] for c in out])
        entry.launches = decode_ops.launches - before
        decode_ops.launches = before
        entry.graph, entry.logits = graph, logits
        entry.outputs = torch.cuda.MemPool()

    def _replay(self, entry, caches, tokens):
        with obs_trace.span("decode_graph", "model"):
            # the logits come from the entry's own pool: in the shared
            # one the caller's allocations split the block a dropped output
            # leaves, and the cudaMalloc that then made the next output
            # held the host 50-77 ms a time on the H100
            with torch.cuda.use_mem_pool(entry.outputs, tokens.device):
                logits = torch.empty_like(entry.logits)
            dst, src = [entry.tokens], [tokens]
            for n, c in zip(entry.lens, caches):
                if c["len"] is not n:
                    dst.append(n)
                    src.append(c["len"])
            torch._foreach_copy_(dst, src)
            entry.graph.replay()
            logits.copy_(entry.logits)
        decode_ops.launches += entry.launches
        for c, n in zip(caches, entry.lens):
            c["len"] = n
        return logits, caches
