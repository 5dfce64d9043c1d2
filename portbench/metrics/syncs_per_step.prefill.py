"""syncs_per_step.prefill (count): CUDA runtime calls that block the
host until the device has caught up, made inside the model's
``prefill_step`` ranges (``Model.make_prefill_step``) in the traced
window, per prefill.  Counted: ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` and the blocking
``cudaMemcpy``.  On the H100 under torch 2.11 (cu128) a copy to the
host, ``.item()``, ``nonzero``, a boolean mask and a tensor made from
host values each showed one ``cudaMemcpyAsync`` and one
``cudaStreamSynchronize``; ``torch.cuda.synchronize`` one
``cudaDeviceSynchronize``; ``Event.synchronize`` one
``cudaEventSynchronize``; none showed a ``cudaMemcpy``.  The harness's
copy of the first tokens to the host lies outside the range and is not
counted, nor is the profiler's own synchronise when it starts.  The
runtime calls are read from the host events ``devtrace.Trace`` keeps
(its ``_host``: start, end and name of each)."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.device:
        return None
    spans = sorted((a, b) for a, b in t.annotations.get("prefill_step", [])
                   if a >= t.start and b <= t.end)
    if not spans:
        return None
    calls = [e for e in t._host if e[2] in SYNCS]
    inside = sum(1 for c, *_ in calls if any(a <= c <= b for a, b in spans))
    return inside / t.steps
