"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from this checkout's sources, holds
each against its plain PyTorch version on the card, drives the port's
main path — ``repro_torch.launch.serve --workload classify`` with the
batched engine — at m = 2^20 examples per task, and checks the card's
protocol outputs against the port's CPU run.  Prints the card, the
kernels' numbers as one JSON line, and, last, one JSON object with
``"ok": true``.  Any failed check exits non-zero before that line; so
does a host with no CUDA device.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
MAIN_ROWS, MAIN_MLOC = 64, 1 << 18  # B·k player rows × examples per player
SLICE_ARGS = ["--workload", "classify", "--cls", "thresholds", "--batch",
              "16", "--m", str(1 << 20), "--k", "4", "--noise", "8",
              "--domain", "65536", "--coreset", "100", "--opt-budget",
              "16", "--device", "cuda"]


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
              max_hits=120):
    g = torch.Generator(device="cuda").manual_seed(seed)
    hits = torch.randint(0, max_hits + 1, (R, m), generator=g,
                         device="cuda", dtype=torch.int32)
    correct = torch.rand((R, m), generator=g, device="cuda") < 0.7
    alive = torch.rand((R, m), generator=g, device="cuda") < 0.95
    if dead_row:
        alive[0] = False
    if alive_row:
        alive[-1] = True
    return hits, correct, alive


def phase_kernel(ops) -> dict:
    """mw_update against its plain version at the main path's shape and
    at ragged shapes; returns its JSON entry (without launches)."""
    cases = [dict(R=MAIN_ROWS, m=MAIN_MLOC),
             dict(R=5, m=3001, dead_row=True, alive_row=True),
             dict(R=3, m=2048 * 3 + 1, max_hits=126),
             dict(R=2, m=7, dead_row=True)]
    max_abs = 0.0
    for i, case in enumerate(cases):
        R, m = case.pop("R"), case.pop("m")
        hits, correct, alive = mw_inputs(R, m, seed=i, **case)
        kh, kw = ops.mw_update(hits, correct, alive)
        torch.cuda.synchronize()
        rh, rw = ops.mw_update(hits, correct, alive, interpret=True)
        check(torch.equal(kh, rh), f"mw_update new_hits differ at [{R}, {m}]")
        check(torch.allclose(kw, rw, rtol=1e-6, atol=0.0),
              f"mw_update wsum outside rtol 1e-6 at [{R}, {m}]")
        err = (kw.double() - rw.double()).abs().max().item()
        if i == 0:
            max_abs = err
        log(f"mw_update [{R}, {m}]: new_hits bitwise, wsum max_abs_err "
              f"{err:.3e} (bitwise {torch.equal(kw, rw)})")
    hits, correct, alive = mw_inputs(MAIN_ROWS, MAIN_MLOC, seed=0)
    kernel_ms = time_ms(lambda: ops.mw_update(hits, correct, alive))
    plain_ms = time_ms(lambda: ops.mw_update(hits, correct, alive,
                                             interpret=True), reps=20)
    n = MAIN_ROWS * MAIN_MLOC
    bytes_moved = n * (4 + 1 + 1 + 4) + MAIN_ROWS * 4
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    log(f"mw_update main shape [{MAIN_ROWS}, {MAIN_MLOC}]: kernel_ms "
          f"{kernel_ms:.4f} plain_ms {plain_ms:.4f} bound_us "
          f"{bound_ms * 1e3:.2f} ({bytes_moved} bytes) share_of_bound "
          f"{bound_ms / kernel_ms:.3f}")
    return {"name": "mw_update", "route": "cuda",
            "source": "src/repro_torch/kernels/mw_update/csrc/mw_update.cu",
            "replaces": "src/repro/kernels/mw_update/kernel.py:36",
            "max_abs_err": max_abs, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def phase_slice(serve, ops, ledger) -> dict:
    """The main path at full size; returns the serve JSON."""
    from repro_torch.core.types import BoostConfig

    args = serve.build_parser().parse_args(SLICE_ARGS)
    ops.launches = 0
    out, res, ts = serve.run_classify(args)
    launches = ops.launches
    log("slice:", json.dumps(out))
    check(out["ok"] == args.batch, "a task exhausted its budget")
    check(launches == res.steps and launches == out["kernel_launches"],
          f"mw_update launches {launches} != engine steps {res.steps}")
    cfg = BoostConfig(k=args.k, coreset_size=args.coreset,
                      domain_size=args.domain, opt_budget=args.opt_budget)
    for b, task in enumerate(ts):
        f = res.classifier(b)
        xs = torch.from_numpy(task.flat_x).cuda()
        errs = int((f(xs).cpu().numpy() != task.flat_y).sum())
        check(errs <= task.noise_count,
              f"task {b}: E_S(f) = {errs} > planted noise {task.noise_count}")
        bits = res.ledger(b).total_bits
        bound = ledger.theorem_41_bound(cfg, res.cls, args.m,
                                        task.noise_count)
        check(bits <= bound, f"task {b}: ledger {bits} > bound {bound}")
        log(f"task {b}: attempts {int(res.attempts[b])} rounds "
              f"{int(res.rounds[b])} E_S(f) {errs} <= noise "
              f"{task.noise_count}; ledger {bits} <= theorem 4.1 bound "
              f"{bound:.0f}")
    log(f"slice: tasks_per_s {out['tasks_per_s']} wall_s {out['wall_s']} "
          f"steps {res.steps} mw_update launches {launches}")
    return out


def phase_profile(batched, serve) -> None:
    """Where a step's time goes: a few engine rounds of the slice under
    torch.profiler — device kernel time against the host's wall time,
    and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import tasks, weak
    from repro_torch.core.types import BoostConfig

    args = serve.build_parser().parse_args(SLICE_ARGS)
    cls = weak.make_class(args.cls, n=args.domain)
    cfg = BoostConfig(k=args.k, coreset_size=args.coreset,
                      domain_size=args.domain, opt_budget=args.opt_budget)
    x, y, _ = tasks.make_batch(cls, args.batch, args.m, args.k, args.noise,
                               seed0=args.seed)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    s = batched.init_state(x, y, cfg, cls=cls, device="cuda")
    s = batched.run_rounds(s, x, y, cfg, cls, n=2)
    torch.cuda.synchronize()
    steps = 5
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
        log(f"profile: wall_ms/step {wall_ms:.2f}; device time not "
            "measured (the profiler recorded no kernels)")
        return
    dev_us = sum(e.self_device_time_total for e in rows) / steps
    launches = sum(e.count for e in rows) / steps
    log(f"profile: {steps} steps, wall_ms/step {wall_ms:.2f} (unprofiled), "
        f"device_ms/step {dev_us / 1e3:.3f}, device busy share "
        f"{dev_us / 1e3 / wall_ms:.3f}, kernels/step {launches:.0f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
            f"x{e.count / steps:5.0f}  {e.key[:90]}")


def protocol_outputs(res, b: int) -> dict:
    """Task b's protocol outputs, the fields the parity bar holds
    bitwise, plus the final classifier's labels on S."""
    t = res.per_task(b)
    x = torch.from_numpy(res.x[b].reshape(-1))
    return {"attempts": t.attempts, "rounds": t.rounds,
            "stuck": t.stuck_history,
            "hypotheses": t.hypotheses[:t.rounds].tobytes(),
            "ledger": dataclasses.asdict(t.ledger),
            "dispute": [a.tolist() for a in (t.dispute_x, *t.dispute_y)],
            "f_on_S": res.classifier(b)(x).numpy().tobytes()}


def phase_card_vs_cpu(batched, tasks, weak) -> None:
    from repro_torch.core.types import BoostConfig

    cfg = BoostConfig(k=4, coreset_size=100, domain_size=4096,
                      opt_budget=16)
    for name in ("thresholds", "intervals", "singletons"):
        cls = weak.make_class(name, n=4096)
        x, y, _ = tasks.make_batch(cls, 4, 4096, 4, 3, seed0=7)
        runs = {dev: batched.run_accurately_classify_batched(
            x, y, cfg, cls, device=dev) for dev in ("cuda", "cpu")}
        for b in range(4):
            card, cpu = (protocol_outputs(runs[d], b) for d in ("cuda", "cpu"))
            check(card == cpu, f"{name} task {b}: card and CPU protocol "
                  f"outputs differ in {[k for k in card if card[k] != cpu[k]]}")
        log(f"card vs cpu, {name}: protocol outputs equal on 4 tasks "
              f"({runs['cuda'].steps} steps)")


def main() -> int:
    argparse.ArgumentParser(description=__doc__).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.core import batched, ledger, tasks, weak
    from repro_torch.kernels.mw_update import kernel, ops
    from repro_torch.launch import serve

    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    # 2. build
    t0 = time.perf_counter()
    lib, report = kernel.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        print(f"  ptxas: {line}")
    # 3. kernel against its plain version
    entry = phase_kernel(ops)
    # 4. the slice at full size
    entry["launches"] = phase_slice(serve, ops, ledger)["kernel_launches"]
    phase_profile(batched, serve)
    # 5. card against CPU
    phase_card_vs_cpu(batched, tasks, weak)
    # 6. results
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
