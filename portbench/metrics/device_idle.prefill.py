"""device_idle.prefill (%): the share of the traced prefills' window in
which no kernel, copy or set ran on the device (the union of their
intervals on the profiler's timeline)."""

from portbench import devtrace


def read(run):
    return devtrace.idle_percent(run.trace)
