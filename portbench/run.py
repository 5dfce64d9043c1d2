"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from process start to the first timed request):
import the port, build its kernels, draw the weights and the traffic
from the seed, warm every shape the window uses.  The window runs the
cell's driver for ``--seconds``.  Afterwards: the device's peak memory
is read, the program's state freed, and the plain reference checks a
sample of what the window served (``correct``).  With ``--trace 1`` a
profiler capture of a few more steps follows the window, and the
line's metrics are the cell's per-layer ones.

The last line of standard output is the JSON result; the numbers
compared, each with its limit, are the last lines of standard error
and the result's last key.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The port's sources on the path.  The port builds its kernels into
    ``build/repro_torch/`` inside the checkout, a fixed place, so only a
    checkout's first run compiles."""
    sys.path.insert(0, str(ROOT / "src"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


@dataclasses.dataclass
class Outcome:
    window_start: float           # perf_counter at the first timed request
    window_s: float
    e2e: dict                     # end-to-end readings the driver can give
    stats: dict                   # what the per-layer readers read
    attempted: int
    failed: int
    requests: list                # check.Request of the sampled requests
    trace: object                 # devtrace.Trace or None


@dataclasses.dataclass
class Context:
    cell: object
    config: dict                  # the configuration file
    cfg: object                   # the port's ModelConfig as run
    model: object
    params: dict
    device: object
    seed: int
    seconds: float
    trace: bool

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    @staticmethod
    def outcome(**kw) -> Outcome:
        # drivers build their result through the context: under
        # ``python -m portbench.run`` this module is ``__main__``, and an
        # import of ``portbench.run`` would load a second copy
        return Outcome(**kw)


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader gets."""
    cell: object
    config: dict
    outcome: Outcome
    on_gpu: bool

    @property
    def stats(self) -> dict:
        return self.outcome.stats

    @property
    def trace(self):
        return self.outcome.trace


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell, seed: int, seconds: float, trace: bool, device="cuda",
            process_start: float = PROCESS_START, wrap_model=None,
            control: bool = False) -> dict:
    """One run of ``cell``; returns the result dict.  ``wrap_model``
    lets a test break the program's steps underneath; ``control`` adds
    the control's readings on the same requests (``"control"``), which
    the benchmark's own runs never compute."""
    import torch

    from portbench import check, spec, weights
    from repro_torch import models

    marks = [("import", time.perf_counter())]
    dev = torch.device(device)
    cfg = spec.port_config(cell.config)
    model = models.build(cfg, use_flash=True)
    if wrap_model is not None:
        model = wrap_model(model)
    if dev.type == "cuda":
        from repro_torch.kernels.flash_attention import kernel as flash

        flash.library()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("kernels", time.perf_counter()))
    params = weights.draw(model.init(0, "meta"), seed, dev,
                          cell.config["assumed"]["weight_draw"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("weights", time.perf_counter()))
    ctx = Context(cell=cell, config=cell.config, cfg=cfg, model=model,
                  params=params, device=dev, seed=seed, seconds=seconds,
                  trace=trace)
    out = cell.driver().run(ctx)
    setup_s = out.window_start - process_start
    marks.append(("warm-up", out.window_start))
    marks.append(("window", out.window_start + out.window_s))
    device_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                   "memory_peak_bytes": 0}
    if dev.type == "cuda":
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(dev),
                       "count": cell.chips,
                       "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
        torch.cuda.empty_cache()

    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    reading = Run(cell=cell, config=cell.config, outcome=out,
                  on_gpu=dev.type == "cuda")
    for m in wanted:
        name = m["name"]
        if trace:
            value = cell.reader(name).read(reading)
        elif name == "setup_s":
            value = setup_s
        else:
            value = out.e2e[name]
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    result = {"correct": False, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device_info}
    if trace and out.trace is not None:
        device_info["busy_s"] = out.trace.busy_s
        device_info["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()

    marks.append(("trace", time.perf_counter()))
    worst = check.compare(cell.reference(), params, cell.config, out.requests)
    marks.append(("check", time.perf_counter()))
    ok, checks = check.verdict(worst, cell.workload["check"]["limits"],
                               out.failed == 0)
    result["correct"] = ok
    if control:
        result["control"] = check.compare(cell.reference(), params,
                                          cell.config, out.requests,
                                          products="fp8")
        marks.append(("control", time.perf_counter()))
    print("portbench: seconds " + ", ".join(
        f"{name} {at - t:.3f}" for (name, at), t in
        zip(marks, [process_start] + [at for _, at in marks])),
        file=sys.stderr)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _paths()
    from portbench import spec

    cell = spec.cell(spec.benchmark(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: the benchmark measures "
              f"the PyTorch port only", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
