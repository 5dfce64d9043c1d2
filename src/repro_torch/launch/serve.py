"""Serve a batch of AccuratelyClassify tasks with the port's batched
engine (counterpart of ``repro.launch.serve --workload classify``).

Usage:
    python -m repro_torch.launch.serve --workload classify \\
        --batch 16 --m 1048576 --k 4 --noise 8 --domain 65536
    python -m repro_torch.launch.serve --workload classify --cls tree \\
        --features 8 --tree-depth 2 --tree-bins 32 --comm-mode coreset \\
        --batch 16 --m 65536 --k 4 --noise 8
    python -m repro_torch.launch.serve --workload classify --device cpu \\
        --cls stumps --batch 4 --m 512

Prints one JSON line with the reference's keys plus ``device``,
``steps`` and ``kernel_launches`` (each kernel's launches in the timed
run; 0 on the CPU, where the plain versions run).  Keys come from
``split(key(seed), B)`` as in the reference.  The run is timed once,
after the kernel libraries are built, and ends in a device
synchronise.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import batched, prng, tasks, weak
from repro_torch.core.types import BoostConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.histogram import kernel as hist_kernel
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.mw_update import kernel as mw_kernel
from repro_torch.kernels.mw_update import ops as mw_ops

# every kernel the engine can launch: name → (kernel module, ops module)
KERNELS = {"mw_update": (mw_kernel, mw_ops),
           "histogram": (hist_kernel, hist_ops)}

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
    cls = make_class(args)
    cfg = make_config(args, cls)
    x, y, ts = tasks.make_batch(cls, args.batch, args.m, args.k, args.noise,
                                seed0=args.seed)
    if dev.type == "cuda":                # build outside the timed run
        _build.build_all([k.SOURCE for k, _ in KERNELS.values()])
        for k, _ in KERNELS.values():
            k.library()
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, device=dev)
    keys = prng.split(prng.key(args.seed, device=dev), args.batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    for _, ops in KERNELS.values():
        ops.launches = 0
    t0 = time.perf_counter()
    res = batched.run_accurately_classify_batched(xt, yt, keys, cfg, cls,
                                                  device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
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
        "kernel_launches": {name: ops.launches
                            for name, (_, ops) in KERNELS.items()},
    }
    return result, res, ts


def make_class(args):
    """The hypothesis class the CLI flags name (the reference's)."""
    return weak.make_class(args.cls, n=args.domain,
                           num_features=args.features,
                           tree_depth=args.tree_depth,
                           tree_bins=args.tree_bins,
                           tree_comm_mode=args.comm_mode,
                           tree_vote_topk=args.vote_topk)


def make_config(args, cls) -> BoostConfig:
    """The protocol configuration of the CLI flags: the randomized
    coreset for the feature-track classes, as in the reference."""
    return BoostConfig(k=args.k, coreset_size=args.coreset,
                       domain_size=args.domain, opt_budget=args.opt_budget,
                       deterministic_coreset=not weak.needs_features(cls))


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
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--tree-depth", type=int, default=2,
                    help="--cls tree: tree depth D (2^D leaves)")
    ap.add_argument("--tree-bins", type=int, default=32,
                    help="--cls tree: histogram bins Q (power of two)")
    ap.add_argument("--comm-mode", default="coreset",
                    choices=["coreset", "histogram", "voting"],
                    help="--cls tree: how split finding crosses the wire")
    ap.add_argument("--vote-topk", type=int, default=2,
                    help="--comm-mode voting: proposals per node per "
                         "player")
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
