"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from this checkout's sources (one nvcc
per source, all at once), holds each against its plain PyTorch version
on the card (mw_update unshifted and shifted; the stump's sort route
on special values too; flash attention on both routes: ``wgmma`` for
bf16, ``cuda_cores`` for float32), checks with ``cuobjdump -sass``
that the bf16 flash kernels are built from wgmma and TMA (HGMMA,
UTMALDG), and drives the port's paths through
``repro_torch.launch.serve``:

* the integer track — thresholds, B = 16 tasks of m = 2^20 examples,
  then B = 4 tasks of m = 2^22 (132 rounds, past the 126 hits an
  unshifted float32 weight sum could hold), every task ok;
* the feature track — HistogramTrees (F = 8, depth 2, 32 bins, coreset
  wire mode), B = 16 tasks of m = 2^16 examples;
* LM serving — deepseek-7b at full width and depth (30 layers, d_model
  4096), 4 prompts of 2048 tokens prefilled through the flash kernel
  (every launch on its wgmma route) and 32 tokens decoded greedily,
  checked against an einsum prefill of the same params and tokens;
* the scenario path — AxisStumps (F = 8) against the ``boundary``
  adversary, B = 16 tasks of m = 2^16, every finished task held to
  E_S(f) ≤ OPT with OPT of all tasks from one stump-kernel launch; and
  the ``dropout`` infrastructure fault at m = 2^14, held to the
  guarantee over the surviving shards;

each with every kernel's launch count set to 0 just before and read
just after.  Then the card's protocol outputs are checked against the
port's CPU run on the three integer classes, on AxisStumps, on
HistogramTrees in its three wire modes and on a 240-round thresholds
run, the scenario reports of ``boundary``, ``byzantine`` and
``dropout`` against the CPU's, and the card's LM logits against the
CPU's on reduced deepseek-7b and qwen3-32b.  Prints the card, each
phase's seconds, the kernels' numbers as one JSON line, and, last, one
JSON object with ``"ok": true``.  Any failed check exits
non-zero before that line; so does a host with no CUDA device.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12                # H100 SXM bf16 tensor cores, dense
# mw_update shapes [B·k player rows, examples per player] of each path
# (the scenario slice runs at the tree slice's [64, 2^14])
MW_SHAPES = {"thresholds": (64, 1 << 18), "tree": (64, 1 << 14),
             "dropout": (64, 1 << 12)}
SLICE_ARGS = ["--workload", "classify", "--cls", "thresholds", "--batch",
              "16", "--m", str(1 << 20), "--k", "4", "--noise", "8",
              "--domain", "65536", "--coreset", "100", "--opt-budget",
              "16", "--device", "cuda"]
TREE_ARGS = ["--workload", "classify", "--cls", "tree", "--features", "8",
             "--tree-depth", "2", "--tree-bins", "32", "--comm-mode",
             "coreset", "--batch", "16", "--m", str(1 << 16), "--k", "4",
             "--noise", "8", "--coreset", "100", "--opt-budget", "16",
             "--device", "cuda"]
# histogram shapes of the tree slice: G tasks (or task·player pairs),
# c points, N nodes, F features, Q bins
HIST_MAIN = dict(G=16, N=2, c=400, F=8, Q=32)
LM_ARGS = ["--workload", "lm", "--arch", "deepseek-7b", "--no-smoke",
           "--batch", "4", "--prompt-len", "2048", "--gen", "32",
           "--device", "cuda"]
# flash attention cases, (B, S, H, KV, hd): the reference's sweep
# (tests/test_kernels.py), then the LM slice's shape, qwen3-32b's
# attention widths (GQA, G = 8, hd 80) and a ragged S
FLASH_SWEEP = [(1, 64, 4, 2, 32), (2, 128, 8, 8, 64), (1, 200, 4, 1, 16),
               (1, 256, 2, 2, 128)]
FLASH_MAIN = (4, 2048, 32, 32, 128)
FLASH_QWEN = (1, 2048, 64, 8, 80)
# bf16 only (the wgmma route): then S under 64, hd 256 (the widest
# tile plan) and G = 8 at hd 128
FLASH_WIDE = [FLASH_MAIN, FLASH_QWEN, (1, 2000, 8, 2, 128),
              (2, 40, 4, 2, 64), (1, 300, 4, 2, 256), (1, 384, 16, 2, 128)]
SCEN_ARGS = ["--workload", "classify", "--cls", "stumps", "--scenario",
             "boundary", "--noise", "8", "--batch", "16", "--m",
             str(1 << 16), "--k", "4", "--features", "8", "--coreset",
             "100", "--opt-budget", "16", "--device", "cuda"]



def with_flags(argv, **flags) -> list[str]:
    """``argv`` with the values of the named flags replaced."""
    out = list(argv)
    for name, value in flags.items():
        out[out.index("--" + name.replace("_", "-")) + 1] = str(value)
    return out


# the infrastructure run: depth (m) cut to 2^14 to stay in the time
# limit; 3 of 4 shards survive, m_s = 12,288, not a power of two
DROP_ARGS = with_flags(SCEN_ARGS, scenario="dropout", m=1 << 14)
# past the old 126-round cap: B = 4 tasks of m = 2^22 (T = ⌈6·22⌉ = 132
# rounds), the rest as the thresholds slice
LARGE_ARGS = with_flags(SLICE_ARGS, batch=4, m=1 << 22)
# stump cases, (B or None for the unbatched form, c, F, Q, kind): the
# reference's (tests/test_kernels.py: sweep, block edges, all-negative
# weights, duplicated thresholds, batched grid), then a ragged shape;
# special values (±0.0, ±inf, NaN in x and θ, the 3.4e38 pad), columns
# of one repeated value, c across the sort's 4096-key tiles, c past
# 16·8192 (a sampled key every 32nd) and Q past 65535
STUMP_CASES = [(None, 32, 1, 8, "sweep"), (None, 128, 8, 128, "sweep"),
               (None, 257, 9, 130, "sweep"), (None, 512, 16, 256, "sweep"),
               (None, 127, 7, 127, "edge"), (None, 129, 9, 129, "edge"),
               (None, 1, 1, 1, "edge"), (None, 255, 17, 257, "edge"),
               (None, 130, 9, 127, "negative"),
               (None, 64, 4, 6, "duplicates"), (1, 127, 7, 129, "edge"),
               (3, 129, 9, 127, "edge"), (2, 128, 8, 128, "edge"),
               (4, 33, 3, 17, "edge"), (2, 129, 9, 130, "negative"),
               (2, 3001, 5, 1001, "edge"),
               (None, 1, 1, 1, "specials"), (None, 300, 5, 40, "specials"),
               (3, 1000, 8, 257, "specials"), (2, 4097, 3, 65, "constant"),
               (None, 64, 4, 6, "constant"), (1, 8193, 33, 100, "edge"),
               (1, 140001, 2, 500, "specials"), (1, 5000, 2, 70000, "edge")]
STUMP_MAIN = (16, 1 << 16, 8, (1 << 16) + 1)   # B, c, F, Q of the OPT launch
STUMP_DROP = (16, 12288, 8, 12289)             # the dropout run's: 3 of 4 shards
STUMP_SMALL = (1, 1 << 14, 8, (1 << 14) + 1)   # the step matrix fits: 8.6 GB
LM_TOL = 2e-2                      # tests/test_kernels.py model-path tolerance
LM_REL_L2_GATE = 5e-2              # flash vs einsum prefill, last-token logits


T0 = time.perf_counter()


def log(*parts) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s]", *parts, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mw_inputs(R: int, m: int, seed: int, dead_row=False, alive_row=False,
              max_hits=120, past_126=False):
    """hits, correct, alive [R, m] and each row's least alive hit count
    (the shift the engine passes; int32 max on a dead row).
    ``past_126`` puts every row's hits in 120–420."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hits = torch.randint(0, max_hits + 1, (R, m), generator=g,
                         device="cuda", dtype=torch.int32)
    if past_126:
        hits = hits + torch.randint(120, 300, (R, 1), generator=g,
                                    device="cuda", dtype=torch.int32)
    correct = torch.rand((R, m), generator=g, device="cuda") < 0.7
    alive = torch.rand((R, m), generator=g, device="cuda") < 0.95
    if dead_row:
        alive[0] = False
    if alive_row:
        alive[-1] = True
    shift = torch.where(alive, hits, torch.iinfo(torch.int32).max).amin(-1)
    return hits, correct, alive, shift


def phase_kernel(ops) -> dict:
    """mw_update against its plain version at each path's shape and at
    ragged shapes, unshifted and shifted by each row's least alive hit
    count (hits past 126 too, where only the shifted sum stays in
    float32's range), timed shifted at each path's shape as the engine
    calls it; returns its JSON entry (without launches), its top-level
    numbers the tree path's."""
    cases = [dict(R=R, m=m) for R, m in MW_SHAPES.values()] + [
        dict(R=5, m=3001, dead_row=True, alive_row=True),
        dict(R=3, m=2048 * 3 + 1, max_hits=126),
        dict(R=2, m=7, dead_row=True),
        dict(R=64, m=1 << 14, past_126=True),
        dict(R=5, m=3001, dead_row=True, past_126=True)]
    max_abs = 0.0
    for i, case in enumerate(cases):
        R, m = case.pop("R"), case.pop("m")
        hits, correct, alive, hmin = mw_inputs(R, m, seed=i, **case)
        shifts = ((hmin,) if case.get("past_126") else (None, hmin))
        for shift in shifts:
            kh, kw = ops.mw_update(hits, correct, alive, shift)
            torch.cuda.synchronize()
            rh, rw = ops.mw_update(hits, correct, alive, shift,
                                   interpret=True)
            how = "unshifted" if shift is None else "shifted"
            check(torch.equal(kh, rh),
                  f"mw_update new_hits differ at [{R}, {m}] {how}")
            check(torch.equal(kw, rw),
                  f"mw_update wsum not bitwise at [{R}, {m}] {how}")
            err = (kw.double() - rw.double()).abs().max().item()
            max_abs = max(max_abs, err)
            past = " hits past 126" if case.get("past_126") else ""
            log(f"mw_update [{R}, {m}] {how}{past}: new_hits and wsum "
                f"bitwise")
    paths = {}
    for path, (R, m) in MW_SHAPES.items():
        hits, correct, alive, hmin = mw_inputs(R, m, seed=0)
        kernel_ms = time_ms(lambda: ops.mw_update(hits, correct, alive,
                                                  hmin))
        plain_ms = time_ms(lambda: ops.mw_update(hits, correct, alive, hmin,
                                                 interpret=True), reps=20)
        bytes_moved = R * m * (4 + 1 + 1 + 4) + R * (4 + 4)
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        log(f"mw_update {path} shape [{R}, {m}]: kernel_ms {kernel_ms:.4f} "
            f"plain_ms {plain_ms:.4f} bound_us {bound_ms * 1e3:.2f} "
            f"({bytes_moved} bytes) share_of_bound "
            f"{bound_ms / kernel_ms:.3f}")
        paths[path] = {"shape": [R, m], "ms": kernel_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms}
    tree = paths["tree"]
    return {"name": "mw_update", "route": "cuda",
            "source": "src/repro_torch/kernels/mw_update/csrc/mw_update.cu",
            "replaces": "src/repro/kernels/mw_update/kernel.py:36",
            "max_abs_err": max_abs, "ms": tree["ms"],
            "plain_ms": tree["plain_ms"], "bound_ms": tree["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "path": "tree",
            "paths": paths}


def hist_inputs(G, N, c, F, Q, seed, dyadic=False, edges=False):
    """x [G, c, F], w/wy [G, N, c] on the card.  ``edges`` adds
    zero-weight points, a zero-weight node and x outside [0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((G, c, F), generator=g, device="cuda")
    if dyadic:
        w = torch.ldexp(torch.ones((G, N, c), device="cuda"), -torch.randint(
            0, 24, (G, N, c), generator=g, device="cuda"))
    else:
        w = torch.rand((G, N, c), generator=g, device="cuda") / c
    if edges:
        x = x * 1.6 - 0.3
        x[0, 0, 0] = math.nan
        x[-1, -1, -1] = math.inf
        w[:, :, ::3] = 0.0
        w[0, -1] = 0.0
    flip = torch.rand((G, N, c), generator=g, device="cuda") < 0.5
    return x, w, torch.where(flip, -w, w)


def phase_histogram(ops, ref) -> dict:
    """The histogram kernel against its plain version, bitwise on both
    outputs, at the tree slice's shapes and at ragged ones; returns its
    JSON entry (without launches)."""
    m = HIST_MAIN
    cases = [dict(G=m["G"], N=1, c=m["c"], F=m["F"], Q=m["Q"]),
             dict(G=m["G"], N=2, c=m["c"], F=m["F"], Q=m["Q"]),
             dict(G=64, N=1, c=100, F=m["F"], Q=m["Q"]),
             dict(G=64, N=2, c=100, F=m["F"], Q=m["Q"]),
             dict(G=5, N=4, c=77, F=3, Q=8, edges=True),
             dict(G=3, N=2, c=1000, F=3, Q=8, edges=True),
             dict(G=2, N=2, c=300, F=40, Q=64, edges=True),
             dict(G=16, N=2, c=400, F=8, Q=32, dyadic=True)]
    max_abs = 0.0
    for i, case in enumerate(cases):
        x, w, wy = hist_inputs(seed=100 + i, **case)
        Q = case["Q"]
        kw, kwy = ops.node_histograms(x, w, wy, Q)
        torch.cuda.synchronize()
        rw, rwy = ops.node_histograms(x, w, wy, Q, interpret=True)
        check(torch.equal(kw, rw) and torch.equal(kwy, rwy),
              f"histogram differs from its plain version at {case}")
        for k, r in ((kw, rw), (kwy, rwy)):
            max_abs = max(max_abs,
                          (k.double() - r.double()).abs().max().item())
        log(f"histogram {case}: hist_w and hist_wy bitwise (block "
            f"{ref.xla_cpu_block(case['c'], case['N'])})")
    G, N, c, F, Q = m["G"], m["N"], m["c"], m["F"], m["Q"]
    x, w, wy = hist_inputs(G, N, c, F, Q, seed=7)
    kernel_ms = time_ms(lambda: ops.node_histograms(x, w, wy, Q), reps=50,
                        warm=5)
    plain_ms = time_ms(lambda: ops.node_histograms(x, w, wy, Q,
                                                   interpret=True), reps=20)
    bins = torch.arange(Q, device="cuda")

    def torch_calls():
        """The whole function in PyTorch calls, binning and one-hot
        included: no single call computes it."""
        onehot = (ref.bin_index(x, Q)[..., None] == bins).float()
        return torch.matmul(torch.cat([w, wy], dim=1),
                            onehot.reshape(G, c, F * Q))

    torch_ms = time_ms(torch_calls, reps=50, warm=5)
    kw, kwy = ops.node_histograms(x, w, wy, Q)
    tw, twy = torch_calls().reshape(G, 2 * N, F, Q).split(N, dim=1)
    check(torch.allclose(tw, kw, rtol=1e-5, atol=1e-6)
          and torch.allclose(twy, kwy, rtol=1e-5, atol=1e-6),
          "the histogram in PyTorch calls disagrees with the kernel")
    bytes_moved = 4 * (G * c * F + 2 * G * N * c + 2 * G * N * F * Q)
    adds = 2 * G * N * c * F          # each point into one bin per feature
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"histogram main shape G={G} N={N} c={c} F={F} Q={Q}: kernel_ms "
        f"{kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms none (no "
        f"single call); torch_calls_ms {torch_ms:.4f} (binning, one-hot "
        f"and torch.matmul, all timed) bound_us "
        f"{bound_ms * 1e3:.4f} ({bytes_moved} bytes, {adds} adds)")
    return {"name": "histogram", "route": "cuda",
            "source": "src/repro_torch/kernels/histogram/csrc/histogram.cu",
            "replaces": "src/repro/kernels/histogram/kernel.py:106",
            "max_abs_err": max_abs, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "torch_calls_ms": torch_ms, "path": "tree",
            "paths": {"tree": {"shape": [G, N, c, F, Q], "ms": kernel_ms,
                               "plain_ms": plain_ms, "bound_ms": bound_ms}}}


STUMP_SPECIALS = (0.0, -0.0, math.inf, -math.inf, math.nan, 3.4e38, -3.4e38)


def stump_inputs(B, c, F, Q, kind, weights, seed):
    """x [(B,) c, F], wy [(B,) c], thetas [(B,) F, Q] on the card, the
    thresholds holding the 3.4e38 pad and values equal to points'.
    ``specials`` puts ±0.0, ±inf, NaN and ±3.4e38 among the points and
    the thresholds; ``constant`` gives every column one repeated value,
    with thresholds at it and one float step either side."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if B is None else (B,)
    if kind == "duplicates":
        x = torch.randint(0, 8, lead + (c, F), generator=g,
                          device="cuda").float()
        th = torch.randint(0, 8, lead + (F, 1), generator=g,
                           device="cuda").float().expand(
                               lead + (F, Q)).contiguous()
    elif kind == "constant":
        v = torch.randint(-4, 4, lead + (1, F), generator=g,
                          device="cuda").float()
        x = v.expand(lead + (c, F)).contiguous()
        col = v.transpose(-1, -2)                          # [(B,) F, 1]
        steps = torch.stack([col, torch.nextafter(col, col - 1),
                             torch.nextafter(col, col + 1)], dim=-1)
        th = steps.reshape(lead + (F, 3)).repeat_interleave(
            -(-Q // 3), dim=-1)[..., :Q].contiguous()
    else:
        x = torch.randn(lead + (c, F), generator=g, device="cuda") * 10
        th = torch.randn(lead + (F, Q), generator=g, device="cuda") * 10
        if kind == "sweep":
            th = th.sort(dim=-1).values
        n = min(c, Q)
        th[..., :n] = x[..., :n, :].transpose(-1, -2)   # ties with points
        if kind == "specials":
            sp = torch.tensor(STUMP_SPECIALS, device="cuda")
            pick = torch.randint(0, len(sp), x.shape, generator=g,
                                 device="cuda")
            mask = torch.rand(x.shape, generator=g, device="cuda") < 0.3
            x = torch.where(mask, sp[pick], x)
            th = th.clone()
            th[..., :len(sp)] = sp[:min(Q, len(sp))]
        th[..., -1] = 3.4e38                            # the pad
    sign = torch.where(torch.rand(lead + (c,), generator=g, device="cuda")
                       < 0.5, -1.0, 1.0)
    if kind == "negative":
        sign = -torch.ones_like(sign)
    if weights == "pm1":
        wy = sign
    elif weights == "dyadic":
        wy = sign * torch.ldexp(torch.ones_like(sign), -torch.randint(
            0, 7, lead + (c,), generator=g, device="cuda"))
    else:
        wy = sign * (torch.rand(lead + (c,), generator=g, device="cuda")
                     + 0.05)
    return x, wy, th


def opt_inputs(B, c, F, seed):
    """The OPT launch's inputs at B tasks of c points: ±1 labels, the
    points' own values plus the pad as thresholds."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, c, F), generator=g, device="cuda") * 100
    wy = torch.where(torch.rand((B, c), generator=g, device="cuda") < 0.5,
                     -1.0, 1.0)
    pad = torch.full((B, F, 1), 3.4e38, device="cuda")
    th = torch.cat([x.transpose(1, 2), pad], dim=-1).contiguous()
    return x, wy, th


def stump_work(B, c, F, Q) -> tuple[int, int, int]:
    """(operations, dense FLOP, bytes) of S = Σ wy·1[x ≥ θ].  The least
    operations: sort each (task, feature) column, prefix-sum wy along
    it and binary-search each θ, c·lg c + c + Q·lg c per column.  The
    dense form, a compare and an add per (point, threshold) pair, is
    what the kernel did before its redesign, printed beside the bound.
    Bytes: x, wy and thetas read once, S written once, in float32."""
    lg = max(1, math.ceil(math.log2(c)))
    ops = B * F * (c * lg + c + Q * lg)
    return ops, 2 * B * c * F * Q, 4 * (B * c * F + B * c + 2 * B * F * Q)


def stump_bound(B, c, F, Q) -> tuple[float, str, float]:
    """(bound_ms, bound_by, dense_bound_ms) at one shape."""
    ops, dense, nbytes = stump_work(B, c, F, Q)
    ops_ms = ops / FP32_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms > bytes_ms else "bytes",
            max(dense / FP32_FLOPS * 1e3, bytes_ms))


def device_breakdown(fn, calls: int = 3) -> dict:
    """Device ms per call of each kernel ``fn`` launches, from
    torch.profiler over ``calls`` calls ({} if it records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^\(anonymous namespace\)::", "", e.key)
            out[name.split("(")[0]] = e.self_device_time_total / calls / 1e3
    return out


def stump_torch_calls(x, wy, th):
    """The whole stump function in PyTorch calls, the kernel's yardstick
    (``torch_calls_ms``): sort each (task, feature) column, gather wy,
    float64 cumsum, searchsorted for each θ's lower bound.  Without the
    kernel's NaN and −0.0 keys: the OPT inputs hold neither."""
    B, c, F = x.shape
    xs, order = torch.sort(x.transpose(1, 2).contiguous(), dim=-1)
    w = torch.gather(wy[:, None, :].expand(B, F, c), -1, order).double()
    pre = torch.nn.functional.pad(torch.cumsum(w, dim=-1), (1, 0))
    idx = torch.searchsorted(xs, th)                            # first ≥ θ
    return (pre[..., -1:] - torch.gather(pre, -1, idx)).float()


def phase_stump(ops, kernel) -> dict:
    """The stump kernel against its plain version: bitwise on ±1 and
    dyadic weights, within rtol 1e-5 plus atol 1e-6·Σ|wy| on float
    weights, at the reference's cases, special values, constant columns,
    ragged shapes and the OPT shapes of the scenario slice and the
    dropout run, where two runs on float weights must also give the same
    bits; timed at both OPT shapes beside the plain version and the
    function in PyTorch calls (sort, gather, cumsum, searchsorted), and
    at a smaller stated shape beside torch.matmul on a materialised step
    matrix.  The bound is that of the function, the sort-based operation
    count or the bytes, whichever takes longer; the dense design's is
    printed beside it.  Returns its JSON entry (without launches)."""
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the plain version would drop bits")
    max_abs = 0.0
    for i, case in enumerate(STUMP_CASES):
        for weights in ("pm1", "dyadic", "float"):
            x, wy, th = stump_inputs(*case, weights, seed=300 + i)
            got = ops.stump_scores(x, wy, th)
            torch.cuda.synchronize()
            want = ops.stump_scores(x, wy, th, interpret=True)
            err = (got.double() - want.double()).abs().max().item()
            if weights == "float":
                atol = 1e-6 * wy.abs().sum(-1).max().item()
                check(torch.allclose(got, want, rtol=1e-5, atol=atol),
                      f"stump differs from its plain version at {case} "
                      f"{weights}: max_abs_err {err}")
            else:
                check(torch.equal(got, want), f"stump not bitwise at "
                      f"{case} {weights}: max_abs_err {err}")
            max_abs = max(max_abs, err)
        log(f"stump {case}: ±1 and dyadic bitwise, float within "
            f"tolerance")
    paths = {}
    for path, shape, seed in (("scenario", STUMP_MAIN, 9),
                              ("dropout", STUMP_DROP, 11)):
        B, c, F, Q = shape
        x, wy, th = opt_inputs(B, c, F, seed=seed)
        got = ops.stump_scores(x, wy, th)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = ops.stump_scores(x, wy, th, interpret=True)  # one run: seconds
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        check(torch.equal(got, want),
              f"stump not bitwise at the {path} OPT shape {list(shape)}")
        check(torch.equal(stump_torch_calls(x, wy, th), got),
              f"the stump in PyTorch calls disagrees with the kernel at "
              f"{list(shape)}")
        del want
        wf = wy * (torch.rand(wy.shape, device="cuda") + 0.05)
        check(torch.equal(ops.stump_scores(x, wf, th),
                          ops.stump_scores(x, wf, th)),
              f"two stump runs on float weights differ at {list(shape)}")
        del got, wf
        kernel_ms = time_ms(lambda: ops.stump_scores(x, wy, th), reps=20,
                            warm=3)
        torch_ms = time_ms(lambda: stump_torch_calls(x, wy, th), reps=20,
                           warm=3)
        parts = device_breakdown(lambda: ops.stump_scores(x, wy, th))
        log(f"stump {path} OPT shape: device ms per call by kernel "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        bound_ms, bound_by, dense_ms = stump_bound(*shape)
        nops, flops, nbytes = stump_work(*shape)
        plan, scratch = kernel.plan(B, c, F), kernel.scratch_bytes(B, c, F)
        log(f"stump {path} OPT shape {list(shape)}, ±1 weights: bitwise, "
            f"two float runs identical; plan: sort route, a sampled key "
            f"every {1 << plan.sample_log2} ({plan.samples} per column), "
            f"feature tile {1 << plan.feature_tile_log2}, scratch "
            f"{scratch} bytes; kernel_ms {kernel_ms:.4f} "
            f"plain_ms {plain_ms:.4f} (one run) torch_calls_ms "
            f"{torch_ms:.4f} (sort, gather, float64 cumsum, searchsorted) "
            f"bound_ms {bound_ms:.4f} by {bound_by} ({nbytes} bytes, "
            f"{nops} operations sorted) share_of_bound "
            f"{bound_ms / kernel_ms:.6f}; dense_bound_ms {dense_ms:.4f} "
            f"({flops} FLOP at the float32 peak, the design before)")
        paths[path] = {"shape": list(shape), "ms": kernel_ms,
                       "plain_ms": plain_ms, "torch_calls_ms": torch_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "dense_bound_ms": dense_ms, "route": "sort",
                       "device_ms_by_kernel": parts,
                       "sample_stride": 1 << plan.sample_log2,
                       "scratch_bytes": scratch}
        del x, wy, th
    b1, c1, f1, q1 = STUMP_SMALL
    x, wy, th = opt_inputs(b1, c1, f1, seed=10)
    small_ms = time_ms(lambda: ops.stump_scores(x, wy, th), reps=10)
    small_plain_ms = time_ms(lambda: ops.stump_scores(x, wy, th,
                                                      interpret=True),
                             reps=5, warm=1)
    step = (x[..., None] >= th[:, None]).float().reshape(b1, c1, f1 * q1)
    library_ms = time_ms(lambda: torch.matmul(wy[:, None, :], step),
                         reps=10)
    lib = torch.matmul(wy[:, None, :], step).reshape(b1, f1, q1)
    check(torch.equal(lib, ops.stump_scores(x, wy, th)),
          "torch.matmul on the step matrix disagrees with the kernel")
    del step, lib
    torch.cuda.empty_cache()
    small_bound, _, small_dense = stump_bound(*STUMP_SMALL)
    log(f"stump at {list(STUMP_SMALL)}: kernel_ms {small_ms:.4f} plain_ms "
        f"{small_plain_ms:.4f} library_ms {library_ms:.4f} (torch.matmul, "
        f"step matrix built outside) bound_ms {small_bound:.4f} "
        f"dense_bound_ms {small_dense:.4f}")
    # ms, plain_ms and bound_ms at the scenario slice's OPT shape; no
    # single library call fits there (its step matrix would take 2.2 TB),
    # so library_ms is taken at library_shape, beside the kernel's and
    # plain version's
    main = paths["scenario"]
    return {"name": "stump", "route": "cuda",
            "source": "src/repro_torch/kernels/stump/csrc/stump.cu",
            "replaces": "src/repro/kernels/stump/kernel.py:91 "
                        "(and :54, the same kernel at B = 1)",
            "max_abs_err": max_abs, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "dense_bound_ms": main["dense_bound_ms"],
            "torch_calls_ms": main["torch_calls_ms"],
            "library_ms": library_ms, "library_shape": list(STUMP_SMALL),
            "at_library_shape": {"ms": small_ms, "plain_ms": small_plain_ms,
                                 "bound_ms": small_bound,
                                 "dense_bound_ms": small_dense},
            "path": "scenario", "paths": paths}


def drive(serve, argv, name):
    """One classify run through the serve entry point, every kernel's
    count set to 0 just before and read just after; checks the counts
    against the JSON's and one mw_update launch per engine step.
    Returns (args, serve JSON, result, tasks, reports, launches)."""
    args = serve.build_parser().parse_args(argv)
    for _, ops in serve.KERNELS.values():
        ops.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, res, ts, reports = serve.run_classify(args)
    total_s = time.perf_counter() - t0
    launches = {k: ops.launches for k, (_, ops) in serve.KERNELS.items()}
    log(f"{name}:", json.dumps(out))
    check(launches == {**out["kernel_launches"], "flash_attention": 0},
          f"{name}: launch counts {launches} != {out['kernel_launches']}")
    check(launches["mw_update"] == res.steps,
          f"{name}: mw_update launches {launches['mw_update']} != engine "
          f"steps {res.steps}")
    log(f"{name}: ok {out['ok']} of {args.batch}, tasks_per_s "
        f"{out['tasks_per_s']} wall_s {out['wall_s']} steps {res.steps} "
        f"ms/step {out['wall_s'] * 1e3 / max(res.steps, 1):.2f} "
        f"run_classify {total_s:.2f} s in all, launches {launches} "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return args, out, res, ts, reports, launches


def phase_scenario(serve, argv, name) -> tuple[dict, object, dict]:
    """The scenario path through :func:`drive`: one stump launch (the
    OPT of every finished task), and every finished task with E_S(f) ≤
    OPT — over the surviving shards for an infrastructure fault, and
    OPT ≤ the planted noise for a noise adversary.  Returns (serve
    JSON, result, launches)."""
    args, out, res, ts, reports, launches = drive(serve, argv, name)
    check(out["ok"] >= 1, f"{name}: no task finished")
    check(launches["stump"] == 1,
          f"{name}: {launches['stump']} stump launches, not 1")
    done = [b for b in range(args.batch) if res.ok[b]]
    check(len(reports) == len(done) == out["ok"],
          f"{name}: {len(reports)} reports for {out['ok']} finished tasks")
    infra = "survivors" in out
    key = "guarantee_ok_survivors" if infra else "guarantee_ok"
    check(out[key] == out["ok"],
          f"{name}: {key} {out[key]} of {out['ok']} finished tasks")
    for b, r in zip(done, reports):
        check(r["errors"] <= r["opt"], f"{name} task {b}: {r}")
        if not infra:
            check(r["opt"] <= ts[b].noise_count,
                  f"{name} task {b}: OPT {r['opt']} > planted noise "
                  f"{ts[b].noise_count}")
        log(f"{name} task {b}: {json.dumps(r)}")
    log(f"{name}: reports_s {out['reports_s']}")
    return out, res, launches


def phase_scenario_card_vs_cpu(serve) -> None:
    """Scenario reports on the card and on the CPU, equal on every field
    of every task, and the serve JSON equal but for timings and the
    launch counts (one stump launch on the card, none on the CPU)."""
    skip = {"wall_s", "tasks_per_s", "device", "reports_s",
            "kernel_launches"}
    for scenario in ("boundary", "byzantine", "dropout"):
        argv = with_flags(SCEN_ARGS, scenario=scenario, batch=4, m=512,
                          features=4)
        outs = {}
        for dev in ("cuda", "cpu"):
            args = serve.build_parser().parse_args(
                with_flags(argv, device=dev))
            out, _, _, reports = serve.run_classify(args)
            outs[dev] = ({k: v for k, v in out.items() if k not in skip},
                         reports, out["kernel_launches"]["stump"])
        card, cpu = outs["cuda"], outs["cpu"]
        check(card[0] == cpu[0], f"scenario {scenario}: card and CPU JSON "
              f"differ: {card[0]} != {cpu[0]}")
        check(card[1] == cpu[1], f"scenario {scenario}: card and CPU "
              f"reports differ: {card[1]} != {cpu[1]}")
        check((card[2], cpu[2]) == (1, 0),
              f"scenario {scenario}: stump launches {card[2]}, {cpu[2]}")
        log(f"card vs cpu, scenario {scenario}: JSON and {len(card[1])} "
            f"reports equal (ok {card[0]['ok']} of 4)")


def phase_slice(serve, ledger, argv, name) -> tuple[dict, object, dict]:
    """One path at full size through :func:`drive`; checks E_S(f) ≤
    planted noise and the ledger against Theorem 4.1 on every task that
    finished.  Returns (serve JSON, result, launches)."""
    args, out, res, ts, _, launches = drive(serve, argv, name)
    cls = serve.make_class(args)
    cfg = serve.make_config(args, cls)
    for b, task in enumerate(ts):
        if not res.ok[b]:
            log(f"{name} task {b}: exhausted its budget "
                f"({int(res.attempts[b])} attempts)")
            continue
        f = res.classifier(b)
        xs = torch.from_numpy(task.flat_x).cuda()
        errs = int((f(xs).cpu().numpy() != task.flat_y).sum())
        check(errs <= task.noise_count,
              f"{name} task {b}: E_S(f) = {errs} > planted noise "
              f"{task.noise_count}")
        bits = res.ledger(b).total_bits
        bound = ledger.theorem_41_bound(cfg, cls, args.m, task.noise_count)
        check(bits <= bound,
              f"{name} task {b}: ledger {bits} > bound {bound}")
        log(f"{name} task {b}: attempts {int(res.attempts[b])} rounds "
            f"{int(res.rounds[b])} E_S(f) {errs} <= noise "
            f"{task.noise_count}; ledger {bits} <= theorem 4.1 bound "
            f"{bound:.0f}")
    return out, res, launches


def phase_profile(batched, serve, prng, tasks, argv, name,
                  steps: int = 5) -> None:
    """Where a step's time goes: a few engine rounds of a slice under
    torch.profiler — device kernel time against the host's wall time,
    and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    args = serve.build_parser().parse_args(argv)
    cls = serve.make_class(args)
    cfg = serve.make_config(args, cls)
    x, y, _ = tasks.make_batch(cls, args.batch, args.m, args.k, args.noise,
                               seed0=args.seed, scenario=args.scenario)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    keys = prng.split(prng.key(args.seed, device="cuda"), args.batch)
    s = batched.init_state(x, y, keys, cfg, cls=cls, device="cuda")
    s = batched.run_rounds(s, x, y, cfg, cls, n=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()          # unprofiled: the profiler slows the host
    s = batched.run_rounds(s, x, y, cfg, cls, n=steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = batched.run_rounds(s, x, y, cfg, cls, n=steps)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:
        log(f"profile {name}: wall_ms/step {wall_ms:.2f}; device time not "
            "measured (the profiler recorded no kernels)")
        return
    dev_us = sum(e.self_device_time_total for e in rows) / steps
    launches = sum(e.count for e in rows) / steps
    log(f"profile {name}: {steps} steps, wall_ms/step {wall_ms:.2f} "
        f"(unprofiled), device_ms/step {dev_us / 1e3:.3f}, device busy "
        f"share {dev_us / 1e3 / wall_ms:.3f}, kernels/step {launches:.0f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
            f"x{e.count / steps:5.0f}  {e.key[:90]}")


def protocol_outputs(res, b: int) -> dict:
    """Task b's protocol outputs, the fields the parity bar holds
    bitwise, plus the final classifier's labels on S."""
    if not res.ok[b]:
        return {"ok": False, "attempts": int(res.attempts[b]),
                "hist_stuck": res.hist_stuck[b].tobytes()}
    t = res.per_task(b)
    x = torch.from_numpy(res.x[b].reshape((-1,) + res.x.shape[3:]))
    return {"attempts": t.attempts, "rounds": t.rounds,
            "stuck": t.stuck_history,
            "hypotheses": t.hypotheses[:t.rounds].tobytes(),
            "ledger": dataclasses.asdict(t.ledger),
            "dispute": [a.tolist() for a in (t.dispute_x, *t.dispute_y)],
            "f_on_S": res.classifier(b)(x).numpy().tobytes()}


def phase_card_vs_cpu(batched, prng, tasks, weak) -> None:
    from repro_torch.core.types import BoostConfig

    runs = []
    cfg = BoostConfig(k=4, coreset_size=100, domain_size=4096,
                      opt_budget=16)
    for name in ("thresholds", "intervals", "singletons"):
        cls = weak.make_class(name, n=4096)
        runs.append((name, cls, cfg, tasks.make_batch(cls, 4, 4096, 4, 3,
                                                      seed0=7)))
    cls = weak.make_class("stumps", num_features=4)
    runs.append(("stumps", cls, BoostConfig(
        k=2, coreset_size=64, domain_size=4096, opt_budget=8,
        deterministic_coreset=False), tasks.make_batch(cls, 2, 128, 2, 1,
                                                       seed0=3)))
    for mode in ("coreset", "histogram", "voting"):
        cls = weak.make_class("tree", num_features=4, tree_depth=2,
                              tree_bins=8, tree_comm_mode=mode)
        runs.append((f"tree/{mode}", cls, BoostConfig(
            k=4, coreset_size=100, domain_size=4096, opt_budget=16,
            deterministic_coreset=False), tasks.make_batch(
                cls, 2, 256, 4, 2, seed0=3)))
    # 240 rounds (rounds_factor 30 at m = 256, noise 0): every hit count
    # reaches 240, past float32's range for an unshifted weight sum
    cls = weak.make_class("thresholds", n=4096)
    runs.append(("thresholds/240 rounds", cls, BoostConfig(
        k=4, coreset_size=100, domain_size=4096, rounds_factor=30,
        opt_budget=4), tasks.make_batch(cls, 2, 256, 4, 0, seed0=11)))
    for name, cls, cfg, (x, y, _) in runs:
        B = x.shape[0]
        res = {dev: batched.run_accurately_classify_batched(
            x, y, prng.split(prng.key(5, device=dev), B), cfg, cls,
            device=dev) for dev in ("cuda", "cpu")}
        for b in range(B):
            card, cpu = (protocol_outputs(res[d], b) for d in ("cuda", "cpu"))
            check(card == cpu, f"{name} task {b}: card and CPU protocol "
                  f"outputs differ in {[k for k in card if card[k] != cpu[k]]}")
        if name == "thresholds/240 rounds":
            check(res["cuda"].ok.all() and (res["cuda"].rounds == 240).all(),
                  f"{name}: ok {res['cuda'].ok}, rounds {res['cuda'].rounds}")
        log(f"card vs cpu, {name}: protocol outputs equal on {B} tasks "
            f"({res['cuda'].steps} steps, ok {int(res['cuda'].ok.sum())})")


def flash_inputs(B, S, H, KV, hd, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def flash_work(B, S, H, KV, hd) -> tuple[int, int]:
    """(FLOPs, bytes) causal attention needs without a window: 4·hd per
    live (query, key) pair (q·k and p·v), S(S + 1)/2 pairs per head,
    and each of q, k, v and o moved once in bf16."""
    pairs = S * (S + 1) // 2
    return 4 * hd * pairs * B * H, 2 * (2 * B * S * H * hd
                                        + 2 * B * S * KV * hd)


def flash_sass(kernel, build) -> dict:
    """``cuobjdump -sass`` of the built flash library: every kernel of
    the wgmma route (bf16) must hold HGMMA (wgmma) and UTMALDG (TMA
    loads), and the library must name no cuBLAS or cuDNN.  Returns the
    instruction counts per kernel."""
    lib = build.build_all([kernel.SOURCE])[0][0]
    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        counts[name] = {op: len(re.findall(rf"\b{op}\b", block))
                        for op in ("HGMMA", "UTMALDG", "UTMASTG")}
    wgmma = {n: c for n, c in counts.items() if "flash_wgmma" in n}
    check(len(wgmma) == 4, f"flash SASS: {len(wgmma)} wgmma kernels, not "
          f"one per tile plan: {list(counts)}")
    for name, c in wgmma.items():
        check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
              f"flash SASS: {name} lacks HGMMA or UTMALDG: {c}")
        log(f"flash SASS {name}: {c}")
    blob = lib.read_bytes().lower()
    check(b"cublas" not in blob and b"cudnn" not in blob,
          "the flash library names cuBLAS or cuDNN")
    return {n[-60:]: c for n, c in wgmma.items()}


def time_flash(ops, kernel, shape, dtype, seed) -> dict:
    """Kernel, plain version and SDPA (``scaled_dot_product_attention``,
    causal, GQA) on one shape, with the bound of the function."""
    B, S, H, KV, hd = shape
    q, k, v = flash_inputs(*shape, dtype, seed=seed)
    kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v), reps=20)
    plain_ms = time_ms(lambda: ops.flash_attention(q, k, v, interpret=True),
                       reps=5, warm=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                      enable_gqa=KV != H), reps=20)
    lib_err = (sdpa(qt, kt, vt, is_causal=True, enable_gqa=KV != H)
               .transpose(1, 2).float()
               - ops.flash_attention(q, k, v).float()).abs().max().item()
    flops, nbytes = flash_work(*shape)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes * (q.element_size() // 2) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    route = kernel.ROUTES[dtype]
    log(f"flash attention {list(shape)} {str(dtype)[6:]} route {route}: "
        f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (scaled_dot_product_attention; max abs "
        f"difference from the kernel {lib_err:.3g}) bound_ms "
        f"{bound_ms:.4f} ({flops} FLOP at {peak / 1e12:.0f} TFLOP/s "
        f"{ops_ms:.4f} ms, {bytes_ms:.4f} ms of bytes) share_of_bound "
        f"{bound_ms / kernel_ms:.4f}, {library_ms / kernel_ms:.3f} of SDPA's "
        f"speed")
    return {"shape": list(shape), "dtype": str(dtype)[6:],
            "kernel_route": route, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share_of_bound": bound_ms / kernel_ms}


def phase_flash(ops, kernel, build) -> dict:
    """The flash kernel against its plain version (full softmax in
    float32) at the reference's sweep in both types (float32 on the
    CUDA-core route at 2e-5, bf16 on the wgmma route at 2e-2), the LM
    slice's shape, qwen3-32b's widths, a ragged S, S under 64, hd 256
    and G = 8; the SASS of the wgmma route; timed at the slice's shape
    and qwen3-32b's beside the plain version and SDPA, and the float32
    route at the slice's shape.  Returns its JSON entry (without
    launches)."""
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    cases = [(shape, dt, w) for shape in FLASH_SWEEP for dt in tol
             for w in (0, 48)]
    cases += [(shape, torch.bfloat16, w) for shape in FLASH_WIDE
              for w in (0, 48)]
    max_abs = 0.0
    for i, (shape, dt, window) in enumerate(cases):
        q, k, v = flash_inputs(*shape, dt, seed=200 + i)
        got = ops.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        want = ops.flash_attention(q, k, v, window=window, interpret=True)
        err = (got.float() - want.float()).abs().max().item()
        check(torch.allclose(got.float(), want.float(), rtol=tol[dt],
                             atol=tol[dt]),
              f"flash attention differs from its plain version at "
              f"{shape} {dt} window {window}: max_abs_err {err}")
        max_abs = max(max_abs, err)
        log(f"flash attention {list(shape)} {str(dt)[6:]} window {window} "
            f"route {kernel.ROUTES[dt]}: max_abs_err {err:.3g} <= "
            f"{tol[dt]}")
    sass = flash_sass(kernel, build)
    main = time_flash(ops, kernel, FLASH_MAIN, torch.bfloat16, seed=7)
    qwen = time_flash(ops, kernel, FLASH_QWEN, torch.bfloat16, seed=8)
    fp32 = time_flash(ops, kernel, FLASH_MAIN, torch.float32, seed=9)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
            "max_abs_err": max_abs, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "kernel_route": main["kernel_route"],
            "share_of_bound": main["share_of_bound"], "path": "lm",
            "paths": {"lm": main}, "qwen3_32b_widths": qwen,
            "float32_route": fp32, "sass": sass}


@contextlib.contextmanager
def float32_products(layers):
    """Run the model's products in float32 instead of bf16 (the
    ``dtype`` defaults of the layers that cast), for a reference prefill
    that both bf16 paths can be measured against."""
    fns = (layers.linear, layers.mlp, layers.embed, layers.unembed)
    saved = [f.__defaults__ for f in fns]
    for f in fns:
        f.__defaults__ = (torch.float32,)
    try:
        yield
    finally:
        for f, d in zip(fns, saved):
            f.__defaults__ = d


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def phase_lm_slice(serve, models, layers) -> tuple[dict, dict]:
    """deepseek-7b at full width and depth through ``serve --workload
    lm``: every kernel's count set to 0 just before and read just after
    (one flash launch per layer of the one prefill, every one on the
    wgmma route); finite logits and tokens; the flash prefill's
    last-token logits against an einsum prefill of the same params and
    tokens, and both against a prefill with float32 products; a profile
    of one prefill and a few decode steps, with flash's share of the
    prefill's device time.  Returns the launches and flash's launches
    per route."""
    from torch.profiler import ProfilerActivity, profile

    args = serve.build_parser().parse_args(LM_ARGS)
    flash_ops = serve.KERNELS["flash_attention"][1]
    for _, ops in serve.KERNELS.values():
        ops.launches = 0
    flash_ops.route_launches = dict.fromkeys(flash_ops.route_launches, 0)
    torch.cuda.reset_peak_memory_stats()
    out, run = serve.run_lm(args)
    launches = {k: ops.launches for k, (_, ops) in serve.KERNELS.items()}
    routes = dict(flash_ops.route_launches)
    peak = torch.cuda.max_memory_allocated()
    log("lm slice:", json.dumps(out))
    cfg = run.model.cfg
    check(out["kernel_launches"]["flash_attention"]
          == launches["flash_attention"] == cfg.num_layers,
          f"lm slice: flash launches {launches} != {cfg.num_layers} layers")
    check(routes == {"wgmma": cfg.num_layers, "cuda_cores": 0},
          f"lm slice: flash routes {routes}, not all {cfg.num_layers} on "
          f"the wgmma route")
    check(launches["mw_update"] == launches["histogram"] == 0,
          f"lm slice launched a protocol kernel: {launches}")
    check(cfg.d_model == 4096 and cfg.num_layers == 30,
          f"lm slice ran {cfg.name}, not deepseek-7b at full size")
    check(bool(torch.isfinite(run.prefill_logits).all())
          and bool(torch.isfinite(run.logits).all()),
          "lm slice: non-finite logits")
    check(out["tokens_finite"] and run.generated.shape == (
        args.batch, args.gen + 1), "lm slice: bad generated tokens")
    params = run.params
    log(f"lm slice: {cfg.name} {cfg.param_count()} params, prefill_s "
        f"{out['prefill_s']} decode_s_per_token "
        f"{out['decode_s_per_token']} launches {launches} flash routes "
        f"{routes} max_memory_allocated {peak} bytes")
    flash_logits, tokens = run.prefill_logits, run.tokens
    del run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_logits, caches = models.build(cfg).make_prefill_step()(
        params, {"tokens": tokens})
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del caches
    err = rel_l2(flash_logits, plain_logits)
    log(f"lm slice: flash vs einsum prefill, last-token logits relative "
        f"L2 {err:.6g} (gate {LM_REL_L2_GATE}); einsum prefill_s "
        f"{plain_s:.3f}")
    check(err <= LM_REL_L2_GATE,
          f"lm slice: flash vs einsum relative L2 {err} > {LM_REL_L2_GATE}")
    with float32_products(layers):
        f32_logits, caches = models.build(cfg).make_prefill_step()(
            params, {"tokens": tokens})
    del caches
    to_f32 = [rel_l2(x, f32_logits) for x in (flash_logits, plain_logits)]
    log(f"lm slice: against a prefill with float32 products, relative L2 "
        f"of the last-token logits: flash {to_f32[0]:.6g}, einsum "
        f"{to_f32[1]:.6g}")
    # where a prefill's and a decode step's device time goes
    model = models.build(cfg, use_flash=True)
    prefill, decode = model.make_prefill_step(), model.make_decode_step()
    for name, steps in (("prefill", 1), ("decode", 4)):
        if name == "decode":
            logits, caches = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if name == "prefill":
                logits, caches = prefill(params, {"tokens": tokens})
            else:
                for _ in range(steps):
                    logits, caches = decode(params, caches, tokens[:, :1])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        del caches
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if not rows:
            log(f"profile lm {name}: wall_ms {wall_ms:.2f} (profiled); "
                "device time not measured (no kernels recorded)")
            continue
        dev_ms = sum(e.self_device_time_total for e in rows) / steps / 1e3
        flash_ms = sum(e.self_device_time_total for e in rows
                       if "flash_wgmma" in e.key) / steps / 1e3
        log(f"profile lm {name}: wall_ms/step {wall_ms:.2f} (profiled), "
            f"device_ms/step {dev_ms:.3f}, device busy share "
            f"{dev_ms / wall_ms:.3f}, kernels/step "
            f"{sum(e.count for e in rows) / steps:.0f}; flash (wgmma "
            f"route) {flash_ms:.3f} ms/step, {flash_ms / dev_ms:.4f} of "
            f"the device time")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
                f"x{e.count / steps:5.0f}  {e.key[:90]}")
    del params, model, logits
    torch.cuda.empty_cache()
    return launches, routes


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def phase_lm_card_vs_cpu(models, configs, flash_ops) -> None:
    """Reduced deepseek-7b and qwen3-32b, params made once on the CPU:
    prefill logits and 4 teacher-forced decode steps on the card and on
    the CPU at the model-path tolerance; flash launches one per layer
    on the card, none on the CPU."""
    import numpy as np

    for arch in ("deepseek-7b", "qwen3-32b"):
        cfg = configs.reduced(configs.get_config(arch))
        model = models.build(cfg, use_flash=True)
        params = {"cpu": model.init(seed=0, device="cpu")}
        params["cuda"] = to_device(params["cpu"], "cuda")
        B, P, n = 2, 200, 4
        toks = np.random.default_rng(5).integers(
            0, cfg.vocab_size, size=(B, P + n)).astype(np.int32)
        logits, launches = {}, {}
        for dev in ("cuda", "cpu"):
            flash_ops.launches = 0
            t = torch.as_tensor(toks, device=dev)
            out, caches = model.make_prefill_step()(params[dev],
                                                    {"tokens": t[:, :P]})
            launches[dev] = flash_ops.launches
            steps = [out]
            for i in range(P, P + n):
                out, caches = model.make_decode_step()(params[dev], caches,
                                                       t[:, i:i + 1])
                steps.append(out)
            logits[dev] = torch.stack(steps).cpu()
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        check(torch.allclose(logits["cuda"], logits["cpu"], rtol=LM_TOL,
                             atol=LM_TOL),
              f"lm card vs cpu, {arch}: logits differ by {err}")
        check(launches == {"cuda": cfg.num_layers, "cpu": 0},
              f"lm card vs cpu, {arch}: flash launches {launches}")
        log(f"lm card vs cpu, {cfg.name}: prefill + {n} decode logits "
            f"max_abs_err {err:.4g} <= {LM_TOL}; flash launches {launches}")


def main() -> int:
    argparse.ArgumentParser(description=__doc__).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch import configs, models
    from repro_torch.core import batched, ledger, prng, tasks, weak
    from repro_torch.models import layers
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.histogram import ref as hist_ref
    from repro_torch.kernels.mw_update import ops as mw_ops
    from repro_torch.kernels.stump import kernel as stump_kernel
    from repro_torch.kernels.stump import ops as stump_ops
    from repro_torch.launch import serve

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"phase {name}: {time.perf_counter() - t0:.2f} s")
        return out

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    # 2. build every kernel, one nvcc each, all at once
    t0 = time.perf_counter()
    built = _build.build_all([k.SOURCE for k, _ in serve.KERNELS.values()])
    for lib, report, secs in built:
        log(f"build: {lib.name} in {secs:.2f} s")
        for line in report.splitlines():
            print(f"  ptxas: {line}")
    log(f"phase build: {time.perf_counter() - t0:.2f} s")
    # 3. each kernel against its plain version
    entries = {"mw_update": phase("mw_update", phase_kernel, mw_ops),
               "histogram": phase("histogram", phase_histogram, hist_ops,
                                  hist_ref),
               "stump": phase("stump", phase_stump, stump_ops,
                              stump_kernel),
               "flash_attention": phase("flash attention", phase_flash,
                                        flash_ops, flash_kernel, _build)}
    # 4. the integer-track path at full size
    _, _, int_launches = phase("thresholds slice", phase_slice, serve,
                               ledger, SLICE_ARGS, "thresholds slice")
    check(int_launches["histogram"] == 0,
          "the integer track launched the histogram kernel")
    phase("thresholds profile", phase_profile, batched, serve, prng, tasks,
          SLICE_ARGS, "thresholds", 3)
    # past the old 126-round cap: m = 2^22 per task, 132 rounds
    large_out, large_res, large_launches = phase(
        "large-m thresholds run", phase_slice, serve, ledger, LARGE_ARGS,
        "large-m run")
    check(large_out["ok"] == 4 and int(large_res.rounds.max()) > 126,
          f"large-m run: ok {large_out['ok']} of 4, rounds "
          f"{large_res.rounds.tolist()}")
    # 5. the tree path at full size: this slice's main path
    _, res, launches = phase("tree slice", phase_slice, serve, ledger,
                             TREE_ARGS, "tree slice")
    depth = int(TREE_ARGS[TREE_ARGS.index("--tree-depth") + 1])
    check(launches["histogram"] == depth * res.steps,
          f"histogram launches {launches['histogram']} != depth {depth} x "
          f"steps {res.steps}")
    check(res.ok.any(), "no tree task finished")
    phase("tree profile", phase_profile, batched, serve, prng, tasks,
          TREE_ARGS, "tree", 5)
    # 6. LM serving at full width: this slice's main path
    lm_launches, lm_routes = phase("lm slice", phase_lm_slice, serve,
                                   models, layers)
    entries["flash_attention"]["route_launches"] = lm_routes
    # 7. the scenario path at full size: this slice's main path, then
    # the infrastructure fault at a cut depth
    _, _, scen_launches = phase("scenario slice", phase_scenario, serve,
                                SCEN_ARGS, "scenario slice")
    phase("scenario profile", phase_profile, batched, serve, prng, tasks,
          SCEN_ARGS, "scenario (stumps)", 3)
    _, _, drop_launches = phase("dropout run", phase_scenario, serve,
                                DROP_ARGS, "dropout run")
    # 8. card against CPU
    phase("card vs cpu", phase_card_vs_cpu, batched, prng, tasks, weak)
    phase("scenario card vs cpu", phase_scenario_card_vs_cpu, serve)
    phase("lm card vs cpu", phase_lm_card_vs_cpu, models, configs,
          flash_ops)
    # 9. results: each kernel's top-level launches are its own main
    # path's (mw_update and histogram the tree path's, stump the
    # scenario path's, flash attention the LM path's), and every path's
    # launches sit in its own entry of ``paths``
    runs = {"thresholds": int_launches, "large_m": large_launches,
            "tree": launches,
            "scenario": scen_launches, "dropout": drop_launches,
            "lm": lm_launches}
    for name, entry in entries.items():
        entry["launches"] = runs[entry["path"]][name]
        for path, counts in runs.items():
            if counts[name]:
                entry["paths"].setdefault(path, {})["launches"] = \
                    counts[name]
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
