"""Where the chunked histogram's time goes: the device ms per call of the
histogram kernel's ``chunked`` route at ``chip_smoke.py``'s roofline
shape (N = 4, c = 10^6, F = 8, Q = 32, tiles of 16384), and of two
builds of the same source cut short, so the difference between them
prices each part of the partials launch.

    PYTHONPATH=src python3 scripts/histogram_chunked_parts.py

Needs one CUDA card.  The cut builds are written to ``build/`` (the
partials launch returning after the tile's binning, and after its sort
by bin) and timed like the whole route, each by torch.profiler
(``chip_smoke.device_ms``); their outputs are not used.  Prints one
line per build and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SORT = "  sort_by_bin(bin_s, order, slot, first, ct, bins);\n"
WALK = "  const int64_t out = ((g * T + t) * N * F + f) * bins;\n"


def main() -> int:
    if not torch.cuda.is_available():
        print("histogram_chunked_parts: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.histogram import kernel, ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    src = kernel.SOURCE.read_text()
    if src.count(SORT + WALK) != 1:
        raise SystemExit("histogram.cu's chunked partials launch changed: "
                         "update SORT and WALK")
    stop = "  if (N > 0) return;\n"
    builds = {"whole route": src,
              "binning and sort": src.replace(SORT + WALK,
                                              SORT + stop + WALK),
              "binning": src.replace(SORT + WALK, stop + SORT + WALK)}
    N, c, F, Q, tile = (cs.HIST_STREAM[k] for k in ("N", "c", "F", "Q",
                                                   "tile"))
    x, w, wy = cs.stream_hist_inputs(1, N, c, F, Q, seed=11)
    out = {"card": card, "shape": [1, N, c, F, Q], "tile": tile}
    build_dir = ROOT / "build" / "histogram_parts"
    build_dir.mkdir(parents=True, exist_ok=True)
    for name, text in builds.items():
        path = build_dir / f"{name.replace(' ', '_')}.cu"
        path.write_text(text)
        kernel.SOURCE = path
        kernel.library.cache_clear()
        dev, parts = cs.device_ms(lambda: ops.node_histograms(
            x, w, wy, Q, chunk_size=tile))
        out[name] = {"device_ms": dev, "device_ms_by_kernel": parts}
        print(f"{card}: chunked histogram, {name}: device_ms "
              f"{cs.fmt_ms(dev)} {parts}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
