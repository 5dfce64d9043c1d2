"""Host-side span/event tracing in Chrome trace-event format
(counterpart of ``repro.obs.trace``).

A :class:`TraceRecorder` collects *complete* events (``ph: "X"`` —
named spans with microsecond ``ts``/``dur``) and *instant* events
(``ph: "i"``), the subset of the Chrome trace-event spec that Perfetto
and ``chrome://tracing`` render natively.  Load the JSON written by
:meth:`TraceRecorder.save` into https://ui.perfetto.dev.

Span taxonomy, names, categories and args are the reference's:
``attempt``, ``round``, ``run_rounds``, ``finalize``, ``quarantine``,
``compile``, ``dispatch``, ``preempt``, ``resume``, ``ckpt_save`` /
``ckpt_write`` / ``ckpt_restore``, ``boost_attempt``.  Round and
attempt spans carry a ``task_bits`` args dict — per-task wire bits by
ledger category — which :func:`repro_torch.obs.roundtrace.validate_trace`
holds bit for bit to the Theorem 4.1 ledger, so one trace validator
reads the reference's traces and the port's.  The LM path adds the
category ``model``: ``prefill_step`` and ``decode_step`` around a
serving step, ``attention``, ``mlp`` and ``moe_ffn`` inside each
layer (``models/model.py``, ``models/transformer.py``), and
``decode_graph`` around a decode step replayed as one CUDA graph
(``models/decode_graph.py``; a replay runs none of the step's inner
spans).

Tracing is disabled by default.  :func:`span` and :func:`instant`
return a preallocated no-op when no recorder is active, so an
instrumented call pays one ``is None`` test.  No span synchronises:
an engine that wants its span to cover the device's work calls
:func:`sync_if_tracing` inside it.

Device-side nesting: a span also opens
``torch.profiler.record_function`` of its name, so a profiler capture
(:func:`device_trace`) shows each span as a range with the kernels
launched inside it.  The recorder stamps ``ts`` on the profiler's
clock, Unix microseconds (what an exported capture's ``ts +
baseTimeNanoseconds / 1000`` gives), so a ``serve --trace-out`` file
and a capture of the same process line up; durations come from a
monotonic clock.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

# Ledger-category ↔ Ledger-field mapping: the ``task_bits`` dicts that
# round/attempt spans carry are keyed by these categories, and
# roundtrace.validate_trace compares their sums field by field with
# the Theorem 4.1 Ledger.
CATEGORY_FIELDS = {
    "coreset": "bits_coresets",
    "ws": "bits_weight_sums",
    "hypotheses": "bits_hypotheses",
    "control": "bits_control",
    "histograms": "bits_histograms",
    "votes": "bits_votes",
    "quarantine": "bits_dispute",
}


def ledger_bits(led) -> dict:
    """A ``Ledger`` (or delta of one) as a per-category bits dict — the
    span ``task_bits`` payload format."""
    return {cat: int(getattr(led, field))
            for cat, field in CATEGORY_FIELDS.items()}


class _NullSpan:
    """Shared no-op span: the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def update(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """One complete event; a context manager timing its ``with`` body.

    ``update(**args)`` merges into the event's args — callable after
    the timed work, so spans can carry results (round counts, wire
    bits) computed inside the region.
    """

    __slots__ = ("_rec", "name", "cat", "args", "_t0", "_range")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str,
                 args: dict):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._range = None

    def update(self, **args) -> None:
        self.args.update(args)

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._range.__exit__(*exc)
        self._rec._complete(self.name, self.cat, self._t0,
                            time.perf_counter(), self.args)
        return False


class TraceRecorder:
    """Append-only event sink (list.append is atomic, so the checkpoint
    writer thread may emit into it too).

    ``ts`` is Unix microseconds, the profiler's clock: one
    (``perf_counter``, ``time_ns``) pair taken at construction maps the
    monotonic clock onto it, and ``dur`` is the monotonic clock's.  The
    ledger validator reads ``args`` payloads, never timestamps.
    """

    def __init__(self):
        self.events: list[dict] = []
        self._epoch = time.perf_counter()
        self._unix_us = time.time_ns() / 1e3
        self._pid = os.getpid()

    def _us(self, t: float) -> float:
        return self._unix_us + (t - self._epoch) * 1e6

    def _complete(self, name: str, cat: str, t0: float, t1: float,
                  args: dict) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": self._us(t0), "dur": max((t1 - t0) * 1e6, 0.0),
            "pid": self._pid, "tid": threading.get_ident(),
            "args": args})

    def span(self, name: str, cat: str = "protocol", **args) -> Span:
        return Span(self, name, cat, dict(args))

    def instant(self, name: str, cat: str = "protocol", **args) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._us(time.perf_counter()),
            "pid": self._pid, "tid": threading.get_ident(),
            "args": dict(args)})

    def extend(self, events) -> None:
        """Merge events from another recorder (e.g. the segment before a
        preemption): validation spans both segments."""
        self.events.extend(events)

    def chrome_trace(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        """Write Perfetto-loadable JSON (atomic: tmp + rename)."""
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)
        os.replace(tmp, path)


# ---------------------------------------------------------------------------
# module-level switchboard: the instrumentation sites call these
# ---------------------------------------------------------------------------

_ACTIVE: TraceRecorder | None = None


def enable(recorder: TraceRecorder | None = None) -> TraceRecorder:
    """Install (and return) the active recorder; pass an existing one
    to keep appending to it."""
    global _ACTIVE
    _ACTIVE = recorder if recorder is not None else TraceRecorder()
    return _ACTIVE


def disable() -> TraceRecorder | None:
    """Deactivate tracing; returns the recorder that was active."""
    global _ACTIVE
    rec, _ACTIVE = _ACTIVE, None
    return rec


def active() -> TraceRecorder | None:
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


@contextlib.contextmanager
def recording(recorder: TraceRecorder | None = None):
    """Scoped enable/disable; yields the recorder."""
    rec = enable(recorder)
    try:
        yield rec
    finally:
        if _ACTIVE is rec:
            disable()


def span(name: str, cat: str = "protocol", **args):
    """A timing span, and a profiler range of its name, when tracing is
    on; the shared no-op when off."""
    rec = _ACTIVE
    if rec is None:
        return _NULL_SPAN
    return rec.span(name, cat, **args)


def instant(name: str, cat: str = "protocol", **args) -> None:
    rec = _ACTIVE
    if rec is not None:
        rec.instant(name, cat, **args)


def sync_if_tracing(device: torch.device) -> None:
    """End the work a span names before the span ends: a device
    synchronise when tracing is on and ``device`` is a card, nothing
    otherwise (an untraced run adds no synchronise)."""
    if _ACTIVE is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (CPU and, on a host with a
    card, CUDA activity) and write it as Chrome trace JSON into
    ``log_dir`` (``trace.json``); yields the profiler, whose events the
    caller may read after the block.  Under an active recorder the
    spans frame the device activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts, acc_events=True)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
