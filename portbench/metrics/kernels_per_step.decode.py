"""kernels_per_step.decode (count): CUDA kernels a decode step
launches, in the traced steps (profiler timeline)."""


def read(run):
    t = run.trace
    if t is None or not t.steps or not t.kernels():
        return None
    return len(t.kernels()) / t.steps
