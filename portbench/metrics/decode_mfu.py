"""decode_mfu (%): a decode step's share of the chip's peak: the larger
of its model FLOPs at the bf16 peak and the bytes it needs at the HBM
peak (``counts.decode_flops``, ``counts.decode_bytes``: the weights
once in bf16, the live K/V cache read once and the new slot written),
over the mean gap between the window's steps (untraced; host
clock)."""

from portbench import counts


def read(run):
    s = run.stats
    if not run.on_gpu or not s.get("step_s"):
        return None
    wall = sum(s["step_s"]) / len(s["step_s"])
    bound = counts.bound_s(
        counts.decode_flops(run.config, s["batch"], s["live_mean"]),
        counts.decode_bytes(run.config, s["batch"], s["live_mean"]))
    return 100.0 * bound / wall
