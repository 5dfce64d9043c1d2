"""attention_ms.prefill (ms): device time a traced prefill spends in the
kernels launched inside the model's ``attention`` ranges
(``transformer._apply_block``: the projections, RoPE and the flash
kernel, not the norm before them), per prefill."""


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    inside = [d for d in t.launched_in("attention") if d[3] == "kernel"]
    if not inside:
        return None
    return sum(b - a for a, b, *_ in inside) / 1e3 / t.steps
