"""Serve a batch of AccuratelyClassify tasks with the port's batched
engine (counterpart of ``repro.launch.serve --workload classify``).

Usage:
    python -m repro_torch.launch.serve --workload classify \\
        --batch 16 --m 1048576 --k 4 --noise 8 --domain 65536
    python -m repro_torch.launch.serve --workload classify --device cpu \\
        --batch 4 --m 512

Prints one JSON line with the reference's keys plus ``device`` and
``kernel_launches`` (mw_update launches of the timed run; 0 on the
CPU, where the plain version runs).  The run is timed once, after the
kernel library is built, and ends in a device synchronise.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import batched, tasks, weak
from repro_torch.core.types import BoostConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.mw_update import kernel as mw_kernel
from repro_torch.kernels.mw_update import ops as mw_ops

_NOT_YET = {
    "lm": "the LM substrate, ROADMAP queue 1, item 15",
    "serve-stream": "the scheduler, ROADMAP queue 1, item 13",
}


def run_classify(args):
    """Run B tasks to completion; returns (JSON dict, result, tasks)."""
    if args.engine != "batched":
        raise NotImplementedError(
            "--engine sharded comes with the mesh-sharded engine over "
            "torch.distributed, ROADMAP queue 1, item 9")
    if args.scenario is not None:
        raise NotImplementedError(
            "--scenario needs repro.core.scenarios, ROADMAP queue 1, "
            "item 11")
    dev = resolve_device(args.device)
    cls = weak.make_class(args.cls, n=args.domain)
    cfg = BoostConfig(k=args.k, coreset_size=args.coreset,
                      domain_size=args.domain, opt_budget=args.opt_budget)
    x, y, ts = tasks.make_batch(cls, args.batch, args.m, args.k, args.noise,
                                seed0=args.seed)
    if dev.type == "cuda":
        mw_kernel.library()              # build outside the timed run
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mw_ops.launches = 0
    t0 = time.perf_counter()
    res = batched.run_accurately_classify_batched(xt, yt, cfg, cls,
                                                  device=dev)
    wall = time.perf_counter() - t0
    B = args.batch
    result = {
        "workload": "classify", "engine": args.engine, "batch": B,
        "m": args.m, "k": args.k, "class": args.cls,
        "noise": args.noise, "scenario": "uniform",
        "ok": int(res.ok.sum()), "attempts_max": int(res.attempts.max()),
        "wall_s": round(wall, 4),
        "tasks_per_s": round(B / max(wall, 1e-9), 2),
        "device": dev.type, "steps": res.steps,
        "kernel_launches": mw_ops.launches,
    }
    return result, res, ts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="classify",
                    choices=["lm", "classify", "serve-stream"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--noise", type=int, default=2)
    ap.add_argument("--cls", default="thresholds",
                    choices=["singletons", "thresholds", "intervals",
                             "stumps", "tree"])
    ap.add_argument("--domain", type=int, default=1 << 12)
    ap.add_argument("--coreset", type=int, default=100)
    ap.add_argument("--opt-budget", type=int, default=16)
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "sharded"])
    ap.add_argument("--scenario", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main():
    args = build_parser().parse_args()
    if args.workload in _NOT_YET:
        raise SystemExit(f"--workload {args.workload} is not ported yet: "
                         f"{_NOT_YET[args.workload]}")
    print(json.dumps(run_classify(args)[0]))


if __name__ == "__main__":
    main()
