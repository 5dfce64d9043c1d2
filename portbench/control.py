"""Readings for the limits of a cell's check, on many seeds in one
process: the program's numbers (the timed path, as a benchmark run
gives them) and the control's (the reference in float8 products, put
in the program's place), both against the float32 reference, and
each side's verdict under the cell's limits, as a run reaches it.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 3

One JSON line a seed: {"seed", "program": {...}, "correct",
"control": {...}, "control_correct"}.  The benchmark's runs never
compute the control.
"""

import argparse
import json
import sys

from portbench import check, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    run._paths()
    from portbench import spec

    cell = spec.cell(spec.benchmark(run.ROOT), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.execute(cell, seed, args.seconds, False, control=True)
        control_ok, _ = check.verdict(r["control"],
                                      cell.workload["check"]["limits"], True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": {k: c["value"]
                                      for k, c in r["checks"].items()},
                          "correct": r["correct"], "control": r["control"],
                          "control_correct": control_ok}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
