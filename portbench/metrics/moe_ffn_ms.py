"""moe_ffn_ms (ms): device time a traced step spends in the kernels
launched inside the model's ``moe_ffn`` ranges (``models/moe.py``,
framed by ``transformer._ffn``), per step."""


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    inside = [d for d in t.launched_in("moe_ffn") if d[3] == "kernel"]
    if not inside:
        return None
    return sum(b - a for a, b, *_ in inside) / 1e3 / t.steps
