"""Where a dry-run pair's per-device FLOPs come from: each product of
one device, by op and local operand shapes, for one (arch, shape) of
``repro_torch.launch.dryrun`` at a cut depth on the production mesh.
Two torch versions can plan a pair differently (an all-reduce where the
other reduce-scatters), and a product that runs whole on every device
of a mesh axis shows here as a local shape that keeps a full dim.

    PYTHONPATH=src python3 scripts/dryrun_flops_by_op.py \\
        [--arch granite-moe-3b-a800m] [--shape prefill_32k] [--layers 2]

Needs no card.  Prints one JSON line: the torch version, the pair's
per-device FLOPs and collective counts, and the products by FLOPs.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun


class ByOpCounter(dryrun.DeviceCounter):
    """A ``DeviceCounter`` that also keeps each product's FLOPs by op
    and local operand shapes."""

    def __init__(self):
        super().__init__()
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.flops != before:
            shapes = [list(t.shape) for t in pytree.tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
            self.by_op[json.dumps([str(func), shapes])] += self.flops - before
        return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    counters = []

    def make():
        counters.append(ByOpCounter())
        return counters[-1]

    dryrun.DeviceCounter = make
    r = dryrun.dry_run_one(args.arch, args.shape, cfg=cfg)
    print(json.dumps({
        "torch": torch.__version__, "arch": args.arch, "shape": args.shape,
        "layers": args.layers, "mesh": r["mesh"],
        "flops_per_dev": r["flops_per_dev"],
        "count_by_op": r["collectives"]["count_by_op"],
        "products": [[*json.loads(k), v]
                     for k, v in counters[-1].by_op.most_common()]}))


if __name__ == "__main__":
    main()
