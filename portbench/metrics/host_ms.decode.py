"""host_ms.decode (ms): the mean host duration of the model's
``decode_step`` ranges (``Model.make_decode_step``) in the traced
window: the time the host takes to enqueue one decode step, taken under
the profiler, so an upper bound on it.  The argmax and the copy of the
tokens to the host lie outside the range."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    spans = [b - a for a, b in t.annotations.get("decode_step", [])
             if a >= t.start and b <= t.end]
    if not spans:
        return None
    return sum(spans) / len(spans) / 1e3
