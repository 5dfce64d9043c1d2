"""prefill_mfu (%): a prefill's model FLOPs (``counts.prefill_flops``)
over its wall time at the bf16 peak.  The wall time is the mean, over
the window's batches, of the time from issuing a batch to its first
tokens on the host (untraced; host clock)."""

from portbench import counts


def read(run):
    s = run.stats
    if not run.on_gpu or not s.get("service_s"):
        return None
    wall = sum(s["service_s"]) / len(s["service_s"])
    flops = counts.prefill_flops(run.config, s["batch"], s["length"])
    return 100.0 * flops / counts.BF16_FLOPS / wall
