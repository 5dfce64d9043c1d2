"""What the LM path's spans cost: the wall and host time of one
benchmark cell's serving steps with tracing off, under the trace
recorder alone, and under a profiler capture with the recorder (what
``portbench.run --trace 1`` takes).

    PYTHONPATH=src python3 scripts/lm_span_cost.py --cell deepseek-7b.decode-b32

Run it on a card, once with a tree's ``src`` on ``PYTHONPATH`` and once
with another's, in one call, to compare the two.  The cell's shapes,
weights and first inputs are the benchmark's (``portbench``); a decode
cell's cache is the cell's, zero-filled, at the prompt's length.  Prints
one JSON line per mode (``off``, ``recorder``, ``capture``, ``off``
again): the wall ms a step (the step, its argmax and the copy of its
tokens to the host, as ``portbench``'s serving loops take it), the host ms of
the step call alone, the recorder's mean ``prefill_step`` or
``decode_step`` span where the program has one, and under the capture
the cell's ``host_ms.decode`` or ``syncs_per_step.prefill`` reading.
"""

import argparse
import json
import pathlib
import statistics
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import devtrace, spec, traffic, weights  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

WARMUP = 3


def stepper(cell, seed, dev):
    """(a function running one step to its host tokens and returning
    its host ms, the step's span name, its reader)."""
    cfg = spec.port_config(cell.config)
    model = models.build(cfg, use_flash=True)
    params = weights.draw(model.init(0, "meta"), seed, dev,
                          cell.config["assumed"]["weight_draw"])
    T, V = cell.traffic, cell.config["vocab_size"]
    if "sequences" in T:
        B, P, C = T["sequences"], T["prompt_len"], T["cache_capacity"]
        decode = model.make_decode_step()
        caches = model.init_serve_cache(ShapeConfig("cost", C, B, "decode"),
                                        filled=False, device=dev)
        for c in caches:
            c["len"] = torch.full((B,), P, dtype=torch.int32, device=dev)
        tok = torch.randint(0, V, (B, 1), device=dev, dtype=torch.int32)

        def one():
            nonlocal caches
            t0 = time.perf_counter()
            logits, caches = decode(params, caches, tok)
            host = time.perf_counter() - t0
            logits[:, :V].argmax(-1).cpu()
            for c in caches:
                c["len"].fill_(P)
            return host
        return one, "decode_step", "host_ms.decode"
    prefill = model.make_prefill_step()
    prompts = traffic.Prompts(seed, traffic.PROMPTS, T["batch"],
                              T["prompt_len"], V, dev)

    def one():
        t0 = time.perf_counter()
        logits, _ = prefill(params, {"tokens": prompts[0]})
        host = time.perf_counter() - t0
        logits[:, :V].argmax(-1).cpu()
        return host
    return one, "prefill_step", "syncs_per_step.prefill"


def timed(one, steps, step_cm=None):
    walls, hosts = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        if step_cm is None:
            hosts.append(one())
        else:
            with step_cm():
                hosts.append(one())
        walls.append(time.perf_counter() - t0)
    return walls, hosts


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--seed", type=int, default=2**31 + 11)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--traced-steps", type=int, default=8)
    p.add_argument("--label", default="")
    args = p.parse_args()
    dev = torch.device("cuda")
    cell = spec.cell(spec.benchmark(), args.cell)
    one, span, metric = stepper(cell, args.seed, dev)
    for _ in range(WARMUP):
        one()
    torch.cuda.synchronize(dev)

    def line(mode, walls, hosts, **extra):
        ms = [w * 1e3 for w in walls]
        print(json.dumps({
            "label": args.label, "cell": args.cell, "mode": mode,
            "steps": len(ms), "wall_ms_mean": statistics.fmean(ms),
            "wall_ms_median": statistics.median(ms),
            "host_ms_mean": statistics.fmean(hosts) * 1e3, **extra}),
            flush=True)

    line("off", *timed(one, args.steps))
    with obs_trace.recording() as rec:
        walls, hosts = timed(one, args.steps)
    spans = [e["dur"] / 1e3 for e in rec.events if e["name"] == span]
    line("recorder", walls, hosts,
         span_ms_mean=statistics.fmean(spans) if spans else None)
    with devtrace.Capture() as cap:
        one()
        with cap.window():
            walls, hosts = timed(one, args.traced_steps, cap.step)
    run = type("Run", (), {"trace": cap.trace})
    line("capture", walls, hosts,
         **{metric: cell.reader(metric).read(run),
            "kernels_per_step": len(cap.trace.kernels()) / cap.trace.steps})
    line("off", *timed(one, args.steps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
