"""Event and device time per call of the port's protocol kernels
(mw_update, the tree histogram) and of flash attention, at the shapes
``chip_smoke.py`` times them.

    PYTHONPATH=src python3 scripts/kernel_device_times.py [--label NAME]

Needs one CUDA card.  For each kernel and shape it prints the CUDA-event
ms around the whole Python call (``chip_smoke.time_ms``: the wrapper's
checks, allocations and the launch included) and the device ms per
launch from torch.profiler (``chip_smoke.device_ms``), then one JSON
line.  ``PYTHONPATH`` picks the tree whose kernels are timed, so two
trees (say a parent commit unpacked beside this one) can be timed in
turns on one card.  The helpers come from this checkout's
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_device_times: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.mw_update import ops as mw_ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"{args.label}: {card}; repro_torch from "
          f"{pathlib.Path(mw_ops.__file__).parents[3]}", flush=True)
    out = {"label": args.label, "card": card, "mw_update": {},
           "histogram": {}}
    for path, (R, m) in cs.MW_SHAPES.items():
        t = cs.mw_times(mw_ops, R, m)
        out["mw_update"][path] = t
        print(f"{args.label}: mw_update [{R}, {m}] event_ms {t['ms']:.4f} "
              f"device_ms {cs.fmt_ms(t['device_ms'])} "
              f"{t['device_ms_by_kernel']}", flush=True)
    for N in (2, 1):
        t = cs.hist_times(hist_ops, **{**cs.HIST_MAIN, "N": N})
        out["histogram"][f"N={N}"] = t
        print(f"{args.label}: histogram {t['shape']} event_ms "
              f"{t['ms']:.4f} device_ms {cs.fmt_ms(t['device_ms'])} "
              f"{t['device_ms_by_kernel']}", flush=True)
    out["flash_attention"] = {}
    # the LM slice's shape, and hd 256 (the widest tile plan)
    for shape in (cs.FLASH_MAIN, (1, 2048, 16, 16, 256)):
        q, k, v = cs.flash_inputs(*shape, torch.bfloat16, seed=7)

        def flash():
            return flash_ops.flash_attention(q, k, v)

        dev, parts = cs.device_ms(flash, calls=10)
        t = {"shape": list(shape), "ms": cs.time_ms(flash, reps=20),
             "device_ms": dev, "device_ms_by_kernel": parts}
        out["flash_attention"][f"hd={shape[-1]}"] = t
        print(f"{args.label}: flash_attention {list(shape)} bf16 event_ms "
              f"{t['ms']:.4f} device_ms {cs.fmt_ms(dev)}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
