"""itl_p95_ms.decode (ms): the 95th percentile of the gaps between a
sequence's output tokens over the window's decode steps (every
sequence gets its token at the same step; untraced; host clock)."""

import numpy as np


def read(run):
    s = run.stats
    if not run.on_gpu or not s.get("step_s"):
        return None
    return float(np.percentile(s["step_s"], 95) * 1e3)
