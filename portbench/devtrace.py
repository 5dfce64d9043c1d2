"""A ``torch.profiler`` capture of a few steps, read from its timeline.

The harness wraps the captured steps in a ``portbench.window`` range and
each step in ``portbench.step``; the capture also turns on the
program's trace recorder, so the program's own ranges (the MoE's
``moe_ffn``) appear.  :class:`Trace` reads the exported Chrome trace:

* device activity: kernels, copies and sets, clipped to the window;
* busy time: the length of the union of those intervals;
* idle gaps: the rest of the window, each named by the innermost host
  event running at its middle (an ATen op, a runtime call, a range);
* a range's kernels: those whose launch call lies inside the range.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import heapq
import json
import os
import tempfile

import torch

WINDOW, STEP = "portbench.window", "portbench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 120
NOISE = ("void ", "at::native::", "(anonymous namespace)::", "c10::")


def short(name: str) -> str:
    """A kernel's name without the namespaces that every ATen kernel
    repeats, cut to ``NAME_CHARS``."""
    for junk in NOISE:
        name = name.replace(junk, "")
    return name[:NAME_CHARS]


class Trace:
    def __init__(self, events: list):
        ann = collections.defaultdict(list)
        launch, host, dev = {}, [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat"), float(e["ts"])
            end = ts + float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                dev.append((ts, end, e["name"], cat, corr))
            if cat in LAUNCH_CATS and corr is not None:
                launch[corr] = ts
            if cat == "user_annotation":
                ann[e["name"]].append((ts, end))
            if cat in HOST_CATS:
                host.append((ts, end, e["name"]))
        if not ann[WINDOW]:
            raise ValueError(f"the capture holds no {WINDOW!r} range")
        self.start = min(a for a, _ in ann[WINDOW])
        self.end = max(b for _, b in ann[WINDOW])
        self.steps = sum(1 for a, b in ann[STEP]
                         if a >= self.start and b <= self.end)
        self.annotations = dict(ann)
        self._launch = launch
        self._host = host
        self.device = sorted((max(a, self.start), min(b, self.end), n, c, k)
                             for a, b, n, c, k in dev
                             if b > self.start and a < self.end)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self) -> list:
        return [d for d in self.device if d[3] == "kernel"]

    def busy_intervals(self) -> list:
        merged = []
        for a, b, *_ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def gaps(self) -> list:
        out, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def host_at(self, times) -> list:
        """The innermost host event running at each of ``times`` (sorted):
        one sweep over the host events, keeping those still open."""
        events = sorted(self._host)
        names, open_, i = [], [], 0
        for t in times:
            while i < len(events) and events[i][0] <= t:
                a, b, n = events[i]
                heapq.heappush(open_, (b, a, n))
                i += 1
            while open_ and open_[0][0] < t:
                heapq.heappop(open_)
            inner = min(((b - a, n) for b, a, n in open_), default=None)
            names.append(short(inner[1]) if inner else "python")
        return names

    def launched_in(self, name: str) -> list:
        """Device activity whose launch call lies inside a ``name``
        range."""
        spans = sorted(self.annotations.get(name, []))
        starts = [a for a, _ in spans]
        out = []
        for d in self.device:
            t = self._launch.get(d[4])
            if t is None:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= spans[j][1]:
                out.append(d)
        return out

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for a, b, n, *_ in self.device:
            ops[short(n)] += (b - a) / 1e6
        idle = collections.Counter()
        gaps = self.gaps()
        for (a, b), n in zip(gaps, self.host_at([(a + b) / 2
                                                 for a, b in gaps])):
            idle[n] += (b - a) / 1e6
        return {"device_ops": [[n, s] for n, s in ops.most_common(TOP)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(TOP)]}


def idle_percent(trace) -> float | None:
    """The share of the traced window with no device activity, in %;
    None without a trace or without device activity in it."""
    if trace is None or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


class Capture:
    """``with Capture() as cap: …`` profiles the block; ``cap.trace`` is
    its :class:`Trace` afterwards.  Inside, ``cap.window()`` and
    ``cap.step()`` are the ranges the trace is read by."""

    def __init__(self):
        self.trace = None

    @staticmethod
    def window():
        return torch.profiler.record_function(WINDOW)

    @staticmethod
    def step():
        return torch.profiler.record_function(STEP)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.obs import trace as obs_trace

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(obs_trace.recording())
        self._prof = self._stack.enter_context(profile(activities=acts,
                                                        acc_events=True))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        if exc[0] is None:
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "trace.json")
                self._prof.export_chrome_trace(path)
                with open(path, encoding="utf-8") as f:
                    self.trace = Trace(json.load(f)["traceEvents"])
        return False
