"""``graph_share.decode`` on a ``devtrace.Trace`` built from hand-written
events: a window holding four ``decode_step`` ranges, three of them
holding a ``decode_graph`` range, one more step with its graph range
before the window; each reading worked out by hand."""

import types

import pytest

from portbench import devtrace, spec


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _range(name, ts, dur):
    return _x("user_annotation", name, ts, dur)


def _events(graphs=(1, 2, 3), device=True):
    """Window [1000, 2000] µs; decode_step ranges at 1000, 1250, 1500
    and 1750 (200 µs each), a ``decode_graph`` range inside those
    numbered in ``graphs``; a step and its graph range before the
    window."""
    ev = [_range(devtrace.WINDOW, 1000, 1000),
          _range("decode_step", 100, 200), _range("decode_graph", 120, 50)]
    for i in range(4):
        ev.append(_range("decode_step", 1000 + 250 * i, 200))
        if i in graphs:
            ev.append(_range("decode_graph", 1010 + 250 * i, 100))
    if device:
        ev.append(_x("kernel", "k", 1100, 50))
    return ev


def _read(events):
    run = types.SimpleNamespace(
        trace=None if events is None else devtrace.Trace(events))
    return spec.load_module(
        spec.PKG / "metrics" / "graph_share.decode.py").read(run)


@pytest.mark.parametrize("graphs, want", [((0, 1, 2, 3), 100.0),
                                          ((1, 2, 3), 75.0),
                                          ((3,), 25.0)])
def test_share_of_steps_holding_a_graph_range(graphs, want):
    assert _read(_events(graphs)) == pytest.approx(want)


def test_a_graph_range_outside_its_step_does_not_count():
    """A ``decode_graph`` range that spills past its step is not held by
    it."""
    ev = _events((0,))
    ev.append(_range("decode_graph", 1450, 100))   # across step 1's end
    assert _read(ev) == pytest.approx(25.0)


@pytest.mark.parametrize("case", ["no_graph_ranges", "no_device", "no_trace",
                                  "no_steps"])
def test_reads_nothing_where_there_is_nothing_to_read(case):
    """A program without the graph (the parent) reads None, not 0, so
    the metric is left out of the line; so do a CPU run and a run
    without a trace."""
    if case == "no_graph_ranges":
        ev = [e for e in _events() if e["name"] != "decode_graph"]
    elif case == "no_device":
        ev = _events(device=False)
    elif case == "no_trace":
        ev = None
    else:
        ev = [e for e in _events() if e["name"] != "decode_step"]
    assert _read(ev) is None
