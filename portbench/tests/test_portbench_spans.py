"""The readers of the program's ranges, on a ``devtrace.Trace`` built
from hand-written events: a window of two steps, one step before it
(the profiler's own first step), the model's ranges, launches with
their correlations, kernels and a copy, and blocking runtime calls
inside and outside the step's range.  Each reader's number is worked
out by hand; each reads None where the run had no device activity (a
CPU run) or no trace."""

import types

import pytest

from portbench import devtrace, spec


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _range(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 5, corr)


def _events(step, device=True):
    """Window [1000, 2000] µs holding two harness steps, each with one
    ``step`` range (``prefill_step`` or ``decode_step``) holding an
    ``attention`` and an ``mlp`` range; a third ``step`` range before
    the window."""
    ev = [_range(devtrace.WINDOW, 1000, 1000),
          _range(devtrace.STEP, 1000, 400), _range(devtrace.STEP, 1500, 400),
          _range(step, 100, 800), _range("attention", 120, 80),
          _range(step, 1010, 300), _range(step, 1510, 200),
          _range("attention", 1020, 30), _range("mlp", 1060, 40),
          _range("attention", 1520, 30), _range("mlp", 1560, 40),
          # launches: in attention, mlp, the step alone, attention (a copy),
          # and attention before the window
          _launch(1030, 1), _launch(1070, 2), _launch(1200, 5),
          _launch(1530, 3), _launch(1570, 4), _launch(1540, 6),
          _launch(150, 7),
          # blocking calls: two in the first step's range, one past it
          # (the harness's copy), two in the second, one before the window;
          # an asynchronous copy does not block
          _x("cuda_runtime", "cudaStreamSynchronize", 1250, 10),
          _x("cuda_runtime", "cudaMemcpyAsync", 1260, 10),
          _x("cuda_runtime", "cudaDeviceSynchronize", 1290, 5),
          _x("cuda_runtime", "cudaStreamSynchronize", 1350, 10),
          _x("cuda_runtime", "cudaMemcpy", 1600, 10),
          _x("cuda_runtime", "cudaEventSynchronize", 1700, 5),
          _x("cuda_runtime", "cudaStreamSynchronize", 250, 10)]
    if device:
        ev += [_x("kernel", "attn_a", 1100, 20, 1),
               _x("kernel", "mlp_a", 1130, 30, 2),
               _x("kernel", "other", 1200, 50, 5),
               _x("kernel", "attn_b", 1600, 40, 3),
               _x("kernel", "mlp_b", 1650, 50, 4),
               _x("gpu_memcpy", "Memcpy DtoD", 1700, 10, 6),
               _x("kernel", "attn_early", 210, 50, 7)]
    return ev


def _read(metric, events):
    run = types.SimpleNamespace(
        trace=None if events is None else devtrace.Trace(events))
    return spec.load_module(spec.PKG / "metrics" / f"{metric}.py").read(run)


@pytest.mark.parametrize("metric, step, want", [
    # kernels launched in attention ranges inside the window: 20 + 40 µs
    # over 2 steps (the copy is no kernel; the early kernel lies before
    # the window)
    ("attention_ms.prefill", "prefill_step", 0.030),
    ("attention_ms.decode", "decode_step", 0.030),
    # in mlp ranges: 30 + 50 µs over 2 steps
    ("mlp_ms.prefill", "prefill_step", 0.040),
    # blocking calls in the window's prefill_step ranges: 2 + 2 over 2 steps
    ("syncs_per_step.prefill", "prefill_step", 2.0),
    # the window's decode_step ranges: 300 and 200 µs
    ("host_ms.decode", "decode_step", 0.250),
])
def test_span_readers_read_their_ranges(metric, step, want):
    assert _read(metric, _events(step)) == pytest.approx(want)
    assert _read(metric, _events(step, device=False)) is None
    assert _read(metric, None) is None


@pytest.mark.parametrize("metric", ["attention_ms.prefill", "mlp_ms.prefill",
                                    "syncs_per_step.prefill",
                                    "attention_ms.decode", "host_ms.decode"])
def test_span_readers_read_nothing_without_the_ranges(metric):
    """A program without the ranges (the parent of the spans) reads
    None, not 0: the metric is left out of the line."""
    names = {"attention", "mlp", "prefill_step", "decode_step"}
    ev = [e for e in _events("prefill_step" if "prefill" in metric
                             else "decode_step")
          if e["name"] not in names]
    assert _read(metric, ev) is None


def test_syncs_are_zero_where_the_step_waits_on_nothing():
    ev = [e for e in _events("prefill_step")
          if "Synchronize" not in e["name"] and e["name"] != "cudaMemcpy"]
    assert _read("syncs_per_step.prefill", ev) == 0
