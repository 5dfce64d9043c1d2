"""attention_ms.decode (ms): device time a traced decode step spends in
the kernels launched inside the model's ``attention`` ranges
(``transformer._decode_block``: the projections, RoPE, the cache write
and the attention over the cache, not the norm before them), per
step."""


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    inside = [d for d in t.launched_in("attention") if d[3] == "kernel"]
    if not inside:
        return None
    return sum(b - a for a, b, *_ in inside) / 1e3 / t.steps
