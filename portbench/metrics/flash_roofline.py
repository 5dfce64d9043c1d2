"""flash_roofline (%): the flash attention kernel's share of its
roofline in the traced prefills: per launch the least time the chip
could take (``counts.flash_work`` at the bf16 and HBM peaks), summed
over the launches, over the kernel's device time."""

from portbench import counts


def read(run):
    t, s, c = run.trace, run.stats, run.config
    if t is None or "length" not in s:
        return None
    flash = [d for d in t.kernels() if "flash" in d[2]]
    if not flash:
        return None
    hd = c.get("head_dim") or c["d_model"] // c["num_heads"]
    bound = counts.bound_s(*counts.flash_work(
        s["batch"], s["length"], c["num_heads"], c["num_kv_heads"], hd))
    busy = sum(b - a for a, b, *_ in flash) / 1e6
    return 100.0 * bound * len(flash) / busy
