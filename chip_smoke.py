"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from this checkout's sources (one nvcc
per source, all at once), holds each against its plain PyTorch version
on the card (mw_update unshifted and shifted, one launch a call; the
histogram on its three routes, ``sort``, ``tiled`` and ``chunked``;
the stump's sort route on special values too; flash attention on both
routes: ``wgmma``
for bf16, ``cuda_cores`` for float32; decode attention at every head
dim the registry decodes with, split and unsplit, over a wrapped ring
and a window, with its slot write), times each at its path's
shapes by CUDA events around the call and by the profiler's device
time per launch, checks with ``cuobjdump -sass``
that the bf16 flash kernels are built from wgmma and TMA (HGMMA,
UTMALDG), and drives the port's paths through
``repro_torch.launch.serve``:

* the integer track — thresholds, B = 16 tasks of m = 2^20 examples,
  then B = 4 tasks of m = 2^22 (132 rounds, past the 126 hits an
  unshifted float32 weight sum could hold), every task ok;
* the feature track — HistogramTrees (F = 8, depth 2, 32 bins, coreset
  wire mode), B = 16 tasks of m = 2^16 examples, every histogram launch
  on the kernel's ``sort`` route;
* LM serving — deepseek-7b at full width and depth (30 layers, d_model
  4096), 4 prompts of 2048 tokens prefilled through the flash kernel
  (every launch on its wgmma route) and 32 tokens decoded greedily
  (one decode attention call per layer and step), checked against an
  einsum prefill of the same params and tokens;
* the other LM families — granite-moe-3b-a800m at full width and depth
  (the MoE headline: 32 layers, 40 experts top-8, the same shape, 32
  flash launches, flash against einsum, a profile with the MoE FFN's
  share of the device time), then at full width with depth cut to fit
  the card: jamba-v0.1-52b (one superblock, B = 1), phi3.5-moe and
  pixtral-12b (2 layers; pixtral's 1024 prefix positions put flash at
  hd 160), seamless-m4t-medium (12 + 12 layers, no flash path) and
  xlstm-1.3b (16 layers);
* the scenario path — AxisStumps (F = 8) against the ``boundary``
  adversary, B = 16 tasks of m = 2^16, every finished task held to
  E_S(f) ≤ OPT with OPT of all tasks from one stump-kernel launch; and
  the ``dropout`` infrastructure fault at m = 2^14, held to the
  guarantee over the surviving shards;

* the sharded engine over a 1-rank NCCL group (``serve --engine
  sharded``) — the thresholds slice at full size, a histogram-mode tree
  run at m = 2^14 and the dropout run, each equal on every protocol
  output to the batched engine's run of the same argv, with the ledger
  validated against the wire counters and the collectives equal to the
  census; and the host loop on task 0 of the thresholds slice, equal to
  the batched engine's task 0;
* the streaming tier (``--chunk-size``) — the thresholds slice with
  each shard sorted in tiles of 2^14 on the batched engine and on the
  sharded one, each equal to the monolithic batched run on every
  protocol output and ledger field; a coreset-mode tree run at m = 2^14
  with every histogram in tiles of 128 (each launch on the kernel's
  ``chunked`` route), and the chunked tree equal to the CPU at B = 2,
  m = 256; the chunked histogram at the reference's roofline shape
  (m = 10^6, N = 4, F = 8, Q = 32, tiles of 16384),
  bitwise to its plain version and to the monolithic kernel; and the
  quantile sketch of 10^6 points fed through pinned host memory and a
  copy stream, held to measured error ≤ its bound ≤ 1/100 and to the
  CPU's sketch;
* the scheduler (``serve --workload serve-stream``) — 48 thresholds
  requests of m = 2^17, 2^18 and 2^19 (the last under the ``drift``
  adversary) in buckets of B ∈ {1, 4, 8}, every request ok with no
  program built after the warmup and one request of each shape equal
  to its ``one_shot`` run bit for bit; its first 16 requests with
  dispatch 0 preempted to a checkpoint after 30 rounds and its resume
  after 10 more, every completion equal to the unpreempted stream's
  and no checkpoint left; the sharded engine's stream (one NCCL rank,
  m = 2^16) with its ledger validated on every ok lane and its
  ``--trace-out``/``--metrics-out`` files read back; a tree stream
  (m = 2^12) with one preemption, every histogram launch on the
  ``sort`` route; and ``trace_rounds`` on the thresholds slice, its
  traced bits equal to every task's ledger, timed against the untraced
  run, and a ``device_trace`` of two rounds with the mw_update kernel
  inside the ``run_rounds`` region;

* training and the paper's side results — ``repro_torch.launch.train``
  on deepseek-7b at full width cut to 4 of its 30 layers (20 steps of
  8 × 512 tokens, the resilient quarantine on, no flash launch: the
  reference trains on the einsum path) and the reduced model's first 3
  steps against the CPU's; the semi-agnostic reduction (Thresholds,
  m = 2^16, 96 rounds of a [4, 100, 16384] Gumbel draw), E_S(f) ≤
  E_S(g), and its whole result at m = 2048 equal to the CPU's;
  Theorem 2.3's DISJ reduction at r = 512 on the host loop, both
  answers decided (its mw_update launches counted); the finite class
  at m = 2^20, |H| = 512, equal to the CPU's;

* the launch tooling — ``repro_torch.launch.dryrun`` of deepseek-7b
  ``prefill_32k``/``decode_32k``, granite-moe-3b-a800m ``prefill_32k``
  and the protocol on the 16×16 production mesh, and of the LM slice's
  own prefill on one device, in subprocesses that see no card (started
  first, read last: every term finite and above 0); deepseek-7b and
  granite-moe-3b-a800m at full width and 2 layers on DTensors over
  ``make_host_mesh()`` (granite's prefill and 2 decode steps) against
  the plain model; the roofline line, the dry run's compute term of
  the LM slice's prefill over its measured device time (under 1);

each with every kernel's launch count set to 0 just before and read
just after.  The LM slice's parameters are the reference's for seed 0
(their init timed on its own), and the reduced models' seed-0
parameters made on the card are held bit-equal to the CPU's.  Then the card's protocol outputs are checked against the
port's CPU run on the three integer classes, on AxisStumps, on
HistogramTrees in its three wire modes and on a 240-round thresholds
run, the scenario reports of ``boundary``, ``byzantine`` and
``dropout`` against the CPU's, the sharded engine's (NCCL) against
the CPU's (gloo) on every field and wire counter, and the card's LM
logits against the CPU's on reduced deepseek-7b, qwen3-32b and the six
other families.  Prints the card, each
phase's seconds, the kernels' numbers as one JSON line, and, last, one
JSON object with ``"ok": true``.  Any failed check exits
non-zero before that line; so does a host with no CUDA device.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
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
# the MoE headline's prefill (granite-moe-3b-a800m: GQA 24/8, hd 64)
# and pixtral-12b's (1024 prefix positions + 2048 prompt tokens, GQA
# 32/8, hd 160: the wgmma route pads it to 192)
FLASH_MOE = (4, 2048, 24, 8, 64)
FLASH_PIXTRAL = (4, 3072, 32, 8, 160)
FLASH_WIDE = [FLASH_MAIN, FLASH_QWEN, (1, 2000, 8, 2, 128),
              (2, 40, 4, 2, 64), (1, 300, 4, 2, 256), (1, 384, 16, 2, 128),
              FLASH_MOE, FLASH_PIXTRAL]
# decode attention (B, C slots, live slots, H, KV, hd): deepseek-7b's
# decode cell (portbench decode-b32: 32 sequences, 2048 slots, 1536
# live at a round's start) and granite-moe-3b-a800m's widths at the same
# batch; then checks against the plain version at every head dim the
# registry decodes with, split and unsplit, a wrapped ring (len past
# C) and a window: (B, C, lens, H, KV, hd, window)
DECODE_MAIN = (32, 2048, 1536, 32, 32, 128)
DECODE_GRANITE = (32, 2048, 1536, 24, 8, 64)
DECODE_CHECKS = [(4, 2048, [2048, 2100, 1536, 7], 32, 32, 128, 0),
                 (4, 2048, [2049, 1000, 2047, 0], 24, 8, 64, 0),
                 (2, 1024, [1500, 900], 64, 8, 80, 300),
                 (2, 3072, [3100, 40], 32, 8, 160, 0)]
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
# the sharded engine over its 1-rank NCCL group: the thresholds slice at
# full size; the tree slice in histogram mode with its depth (m) cut to
# 2^14 for time (its step is the Gumbel draw), run on both engines; the
# dropout run as it is
SHARD = ["--engine", "sharded"]
SHARD_TREE_ARGS = with_flags(TREE_ARGS, comm_mode="histogram", m=1 << 14)
# the streaming tier (--chunk-size): the thresholds slice with each
# player's shard (mloc = 2^18) sorted in 16 tiles of 2^14 merged over 4
# levels, on both engines; the tree slice in coreset mode with every
# histogram in tiles of 128 (the pooled coreset, k·c = 400 points, in
# 4 tiles), its depth (m) cut to 2^14 as the histogram-mode run's
CHUNK_ARGS = SLICE_ARGS + ["--chunk-size", str(1 << 14)]
CHUNK_TREE_ARGS = with_flags(TREE_ARGS, m=1 << 14) + ["--chunk-size", "128"]
# the chunked histogram at the reference's roofline shape
# (benchmarks/streaming.py:147-177): m = 10^6 points, N = 4 nodes, F = 8,
# Q = 32, tiles of 16384, dyadic weights k/256
HIST_STREAM = dict(N=4, c=10 ** 6, F=8, Q=32, tile=1 << 14)
# the sketch build (benchmarks/streaming.py:180-226): m = 10^6 int32
# points on the 2^16 domain, hits in [0, 13), tiles of 16384 through the
# pinned feed, capacity 32768, a coreset of 1024
SKETCH = dict(m=10 ** 6, n=1 << 16, hmax=13, tile=1 << 14, cap=1 << 15,
              c=1024)
EPS_APPROX = 1.0 / 100.0           # the paper's ε (core/types.py)
# the scheduler (serve --workload serve-stream): the thresholds slice's
# track at serving scale, 48 requests of m = 2^17, 2^18 and 2^19 (the
# last with the drift adversary) in buckets of mloc 2^15, 2^16 and 2^17
# at B in {1, 4, 8}, a bursty trace, the fill policy
STREAM_ARGS = ["--workload", "serve-stream", "--m", str(1 << 18), "--k",
               "4", "--noise", "8", "--domain", "65536", "--coreset", "100",
               "--opt-budget", "16", "--requests", "48", "--trace",
               "bursty", "--rate", "100", "--burst", "8", "--policy",
               "fill", "--scenario", "drift", "--device", "cuda"]
# its first 16 requests, dispatch 0 cut after 30 rounds and its resume
# cut again after 10 (an incremental chain)
PREEMPT_STREAM_ARGS = with_flags(STREAM_ARGS, requests=16) + [
    "--preempt", "0:30", "--preempt", "1:10"]
# the sharded engine's stream over one NCCL rank, m cut to 2^16
SHARD_STREAM_ARGS = with_flags(STREAM_ARGS, m=1 << 16, requests=16) + SHARD
# a tree stream, m cut to 2^12 for time (the Gumbel draw dominates a
# tree step), 8 requests, dispatch 0 preempted after 5 rounds
TREE_STREAM_ARGS = with_flags(STREAM_ARGS, m=1 << 12, requests=8,
                              noise=2) + [
    "--cls", "tree", "--features", "8", "--tree-depth", "2",
    "--tree-bins", "32", "--preempt", "0:5"]
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
# training: deepseek-7b at full width (d_model 4096, 32 heads of 128,
# d_ff 11008, vocab 102400) cut to 4 of its 30 layers: float32 weights,
# gradients and two AdamW moments are 16 bytes a parameter, 26.4 GB at
# 1.65e9 parameters (30 layers would need 110.6 GB)
TRAIN_LAYERS = 4
TRAIN_ARGS = ["--arch", "deepseek-7b", "--no-smoke", "--vocab", "102400",
              "--seq-len", "512", "--batch", "8", "--num-examples", "2048",
              "--noise", "0.1", "--resilient", "--check-every", "5",
              "--steps", "20", "--log-every", "1"]
TRAIN_SMOKE_ARGS = ["--steps", "3", "--log-every", "1", "--noise", "0.1",
                    "--resilient", "--check-every", "10"]
# the paper's side results at benchmarks/' sizes
SEMI = dict(n=1 << 16, m=1 << 16, k=4, noise=8, coreset=100, budget=16)
DISJ = dict(n=1 << 12, k=2, coreset=400, r=512, weight=256)
FINITE = dict(n=1 << 12, H=512, m=1 << 20, k=4)
LM_REL_L2_GATE = 5e-2              # flash vs einsum prefill, last-token logits
# the MoE headline: granite-moe-3b-a800m at full width and depth (32
# layers, d_model 1536, 40 experts top-8 of d_ff 512)
LM_MOE_ARGS = with_flags(LM_ARGS, arch="granite-moe-3b-a800m")
# the other families at full width: arch → (layers, or None for full
# depth; batch; prompt; generated).  jamba's one superblock (7 Mamba
# layers, 1 attention, 4 MoE FFNs of 16 experts) holds 1.33·10^10
# float32 parameters, 53 GB; phi3.5-moe and pixtral keep 2 layers; the
# encoder-decoder runs all 12 + 12; xLSTM 2 superblocks (16 layers, 2
# of them sLSTM)
FAMILY_RUNS = {"jamba-v0.1-52b": (8, 1, 2048, 16),
               "phi3.5-moe-42b-a6.6b": (2, 4, 2048, 16),
               "pixtral-12b": (2, 4, 2048, 16),
               "seamless-m4t-medium": (None, 4, 2048, 32),
               "xlstm-1.3b": (16, 4, 2048, 32)}
FAMILIES = ("granite-moe-3b-a800m",) + tuple(FAMILY_RUNS)
# card against CPU, reduced archs: the absolute bound of the decode
# steps' logits where LM_TOL does not hold.  xLSTM's 8 layers: prefill
# within LM_TOL, decode max_abs_err 0.0234 in three chip runs (NVIDIA
# H100 80GB HBM3, 700.00 W), one logit of the first step 0.0011 past
# LM_TOL's allclose bound (bf16 products summed in other orders,
# compounded over 8 layers; ROADMAP queue 3, "bf16 noise at depth")
CARD_CPU_DECODE_ATOL = {"xlstm-1.3b": 0.03}
# the fields that fix a config's width (what a depth cut keeps)
WIDTHS = ("d_model", "num_heads", "num_kv_heads", "hd", "d_ff",
          "expert_d_ff", "num_experts", "experts_per_token", "vocab_size",
          "block_pattern", "encoder_layers", "frontend_tokens",
          "ssm_state_dim", "ssm_conv_width", "ssm_expand")


# the launch tooling's dry run (python -m repro_torch.launch.dryrun, in
# subprocesses that see no card, so its fake world never meets the
# NCCL world): these pairs on the 16×16 production mesh, the protocol,
# and the LM slice's own prefill (deepseek-7b, B = 4, S = 2048) on a
# one-device mesh for the roofline line
DRYRUN_PAIRS = [("deepseek-7b", "prefill_32k"), ("deepseek-7b", "decode_32k"),
                ("granite-moe-3b-a800m", "prefill_32k")]
DRYRUN_ROOFLINE = """
import json, sys
from repro_torch.configs.base import MeshConfig, ShapeConfig
from repro_torch.launch import dryrun
r = dryrun.dry_run_one("deepseek-7b", ShapeConfig("lm_slice", 2048, 4,
                       "prefill"), mesh_cfg=MeshConfig(data=1, model=1))
json.dump(r, open(sys.argv[1], "w"))
"""
DRYRUN_TIMEOUT_S = 900
HOST_MESH_TOL = 2e-2               # DTensor prefill vs plain, logits
HOST_MESH_LAYERS = 2              # the host-mesh phase's depth cut
HOST_MESH_DECODE = 2              # its granite decode steps
# the LM slices' prefill time from their profiles: name → (device ms or
# None where the profiler recorded no kernel, profiled wall ms)
PREFILL_MS: dict = {}
# the LM path's spans (category ``model``), ranges in a capture under an
# active recorder
LM_SPANS = ("prefill_step", "decode_step", "attention", "mlp", "moe_ffn")


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
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "",
                          e.key)
            name = name.split("(")[0]
            out[name] = out.get(name, 0.0) + \
                e.self_device_time_total / calls / 1e3
    return out


def device_ms(fn, calls: int = 50) -> tuple[float | None, dict]:
    """Device ms per call of ``fn``, every kernel it launches summed, and
    the same by kernel, from :func:`device_breakdown` (None where the
    profiler records no kernel)."""
    parts = device_breakdown(fn, calls)
    return (sum(parts.values()) if parts else None), parts


def fmt_ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f}"


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


def mw_times(ops, R: int, m: int) -> dict:
    """mw_update at [R, m], shifted as the engine calls it: the CUDA-event
    ms around the whole call (its wrapper's checks, allocations and the
    launch included) and the device ms per launch from the profiler."""
    hits, correct, alive, hmin = mw_inputs(R, m, seed=0)

    def call():
        return ops.mw_update(hits, correct, alive, hmin)

    dev, parts = device_ms(call)
    return {"shape": [R, m], "ms": time_ms(call), "device_ms": dev,
            "device_ms_by_kernel": parts}


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
        dict(R=5, m=3001, dead_row=True, past_126=True),
        dict(R=3, m=1), dict(R=3, m=15), dict(R=4, m=16, dead_row=True),
        dict(R=3, m=17), dict(R=2, m=2049, alive_row=True),
        dict(R=3, m=16 * 2048 + 3, dead_row=True)]
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
        t = mw_times(ops, R, m)
        hits, correct, alive, hmin = mw_inputs(R, m, seed=0)
        plain_ms = time_ms(lambda: ops.mw_update(hits, correct, alive, hmin,
                                                 interpret=True), reps=20)
        bytes_moved = R * m * (4 + 1 + 1 + 4) + R * (4 + 4)
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        dev = t["device_ms"]
        log(f"mw_update {path} shape [{R}, {m}]: kernel_ms {t['ms']:.4f} "
            f"(CUDA events around the call) device_ms {fmt_ms(dev)} "
            f"(profiler, per launch: {t['device_ms_by_kernel']}) plain_ms "
            f"{plain_ms:.4f} bound_us {bound_ms * 1e3:.2f} ({bytes_moved} "
            f"bytes) share_of_bound {bound_ms / t['ms']:.3f} (events), "
            f"{fmt_ms(dev and bound_ms / dev)} (device)")
        paths[path] = {**t, "plain_ms": plain_ms, "bound_ms": bound_ms}
    tree = paths["tree"]
    return {"name": "mw_update", "route": "cuda",
            "source": "src/repro_torch/kernels/mw_update/csrc/mw_update.cu",
            "replaces": "src/repro/kernels/mw_update/kernel.py:36",
            "max_abs_err": max_abs, "ms": tree["ms"],
            "device_ms": tree["device_ms"],
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


def hist_times(ops, G: int, N: int, c: int, F: int, Q: int) -> dict:
    """The histogram at one shape: the CUDA-event ms around the whole call
    and the device ms per launch from the profiler."""
    x, w, wy = hist_inputs(G, N, c, F, Q, seed=7)

    def call():
        return ops.node_histograms(x, w, wy, Q)

    dev, parts = device_ms(call)
    return {"shape": [G, N, c, F, Q], "ms": time_ms(call, reps=50, warm=5),
            "device_ms": dev, "device_ms_by_kernel": parts}


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
             dict(G=16, N=2, c=400, F=8, Q=32, dyadic=True),
             dict(G=4, N=2, c=401, F=8, Q=32, edges=True),
             dict(G=6, N=2, c=500, F=3, Q=2, edges=True),
             dict(G=2, N=1, c=300, F=3, Q=8192, edges=True),
             dict(G=1, N=64, c=500, F=2, Q=8, edges=True)]
    max_abs = 0.0
    for i, case in enumerate(cases):
        x, w, wy = hist_inputs(seed=100 + i, **case)
        Q = case["Q"]
        before = dict(ops.route_launches)
        kw, kwy = ops.node_histograms(x, w, wy, Q)
        torch.cuda.synchronize()
        route = [r for r, n in ops.route_launches.items() if n > before[r]]
        rw, rwy = ops.node_histograms(x, w, wy, Q, interpret=True)
        check(torch.equal(kw, rw) and torch.equal(kwy, rwy),
              f"histogram differs from its plain version at {case}")
        for k, r in ((kw, rw), (kwy, rwy)):
            max_abs = max(max_abs,
                          (k.double() - r.double()).abs().max().item())
        log(f"histogram {case}: hist_w and hist_wy bitwise (block "
            f"{ref.xla_cpu_block(case['c'], case['N'])}, route {route})")
    one = hist_times(ops, **{**m, "N": 1})
    log(f"histogram G={m['G']} N=1 c={m['c']} F={m['F']} Q={m['Q']}: "
        f"kernel_ms {one['ms']:.4f} (CUDA events around the call) "
        f"device_ms {fmt_ms(one['device_ms'])} (profiler, per launch: "
        f"{one['device_ms_by_kernel']})")
    G, N, c, F, Q = m["G"], m["N"], m["c"], m["F"], m["Q"]
    t = hist_times(ops, G, N, c, F, Q)
    kernel_ms = t["ms"]
    x, w, wy = hist_inputs(G, N, c, F, Q, seed=7)
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
        f"{kernel_ms:.4f} (CUDA events around the call) device_ms "
        f"{fmt_ms(t['device_ms'])} (profiler, per launch: "
        f"{t['device_ms_by_kernel']}) plain_ms {plain_ms:.4f} library_ms "
        f"none (no "
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
            "device_ms": t["device_ms"],
            "paths": {"tree": {**t, "plain_ms": plain_ms,
                               "bound_ms": bound_ms},
                      "tree_level0": one}}


def stream_hist_inputs(G, N, c, F, Q, seed):
    """The reference's streaming-benchmark histogram inputs on the card:
    x on bin centres, w = k/256 (dyadic), wy = ±w."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randint(0, Q, (G, c, F), generator=g, device="cuda") + 0.5) / Q
    w = torch.randint(0, 256, (G, N, c), generator=g, device="cuda") / 256.0
    flip = torch.rand((G, N, c), generator=g, device="cuda") < 0.5
    return x, w, torch.where(flip, -w, w)


def phase_chunked_histogram(ops, ref) -> dict:
    """The histogram's "chunked" route (the streaming tier) against its
    plain version on the card, bitwise: ragged tiles, the batched form,
    a tile ≥ c (the monolithic route), the tree run's pooled shape, and
    the reference's roofline shape [N = 4, c = 10^6, F = 8, Q = 32] in
    tiles of 16384, where it must also equal the monolithic kernel.
    Returns the roofline shape's numbers."""
    cases = [dict(G=1, N=3, c=257, F=5, Q=16, tile=64),
             dict(G=1, N=3, c=512, F=5, Q=16, tile=128),
             dict(G=1, N=3, c=130, F=5, Q=16, tile=200),
             dict(G=4, N=3, c=257, F=5, Q=16, tile=64),
             dict(G=16, N=2, c=400, F=8, Q=32, tile=128),
             dict(G=16, N=1, c=400, F=8, Q=32, tile=128)]
    for i, case in enumerate(cases):
        tile = case.pop("tile")
        x, w, wy = hist_inputs(seed=200 + i, edges=True, **case)
        Q = case["Q"]
        before = dict(ops.route_launches)
        kw, kwy = ops.node_histograms(x, w, wy, Q, chunk_size=tile)
        torch.cuda.synchronize()
        route = [r for r, n in ops.route_launches.items() if n > before[r]]
        want = ["chunked"] if tile < case["c"] else ["sort"]
        check(route == want, f"chunked histogram {case}, tile {tile}: "
              f"route {route}, not {want}")
        rw, rwy = ops.node_histograms(x, w, wy, Q, interpret=True,
                                      chunk_size=tile)
        check(torch.equal(kw, rw) and torch.equal(kwy, rwy),
              f"chunked histogram differs from its plain version at "
              f"{case}, tile {tile}")
        log(f"chunked histogram {case} tile {tile}: bitwise to the plain "
            f"version (route {route})")
    N, c, F, Q, tile = (HIST_STREAM[k] for k in ("N", "c", "F", "Q", "tile"))
    x, w, wy = stream_hist_inputs(1, N, c, F, Q, seed=11)

    def call():
        return ops.node_histograms(x, w, wy, Q, chunk_size=tile)

    kw, kwy = call()
    rw, rwy = ops.node_histograms(x, w, wy, Q, interpret=True,
                                  chunk_size=tile)
    mw, mwy = ops.node_histograms(x, w, wy, Q)          # route "tiled"
    torch.cuda.synchronize()
    check(torch.equal(kw, rw) and torch.equal(kwy, rwy),
          "chunked histogram at the roofline shape differs from its plain "
          "version")
    check(torch.equal(kw, mw) and torch.equal(kwy, mwy),
          "chunked histogram at the roofline shape differs from the "
          "monolithic kernel on dyadic weights")
    ms = time_ms(call, reps=50, warm=5)
    dev, parts = device_ms(call)
    plain_ms = time_ms(lambda: ops.node_histograms(
        x, w, wy, Q, interpret=True, chunk_size=tile), reps=5, warm=1)
    mono_ms = time_ms(lambda: ops.node_histograms(x, w, wy, Q), reps=5,
                      warm=1)
    offs = torch.arange(F, device="cuda") * Q

    def torch_calls():
        """The function in PyTorch calls: binning, then one index_add_
        of every (point, feature)'s weights into its flat bin."""
        idx = (ref.bin_index(x[0], Q) + offs).reshape(-1)
        vals = torch.cat([w[0], wy[0]])[:, :, None].expand(
            2 * N, c, F).reshape(2 * N, c * F)
        return torch.zeros((2 * N, F * Q), device="cuda").index_add_(
            1, idx, vals)

    t = torch_calls().reshape(2, N, F, Q)
    check(torch.equal(t[0], kw[0]) and torch.equal(t[1], kwy[0]),
          "the chunked histogram in PyTorch calls disagrees with the kernel "
          "on dyadic weights")
    torch_ms = time_ms(torch_calls, reps=20, warm=3)
    bytes_moved = 4 * (c * F + 2 * N * c + 2 * N * F * Q)
    adds = 2 * N * c * F
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"chunked histogram N={N} c={c} F={F} Q={Q} tile={tile} "
        f"({-(-c // tile)} tiles): bitwise to the plain version and to the "
        f"monolithic kernel; kernel_ms {ms:.4f} (CUDA events around the "
        f"call) device_ms {fmt_ms(dev)} (profiler, per call of two "
        f"launches: {parts}) plain_ms {plain_ms:.4f} monolithic_ms "
        f"{mono_ms:.4f} (route tiled) torch_calls_ms {torch_ms:.4f} "
        f"(binning and index_add_) bound_ms {bound_ms:.4f} ({bytes_moved} "
        f"bytes, {adds} adds)")
    return {"shape": [1, N, c, F, Q], "tile": tile, "ms": ms,
            "device_ms": dev, "device_ms_by_kernel": parts,
            "plain_ms": plain_ms, "monolithic_ms": mono_ms,
            "torch_calls_ms": torch_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f"; device_ms per call (profiler, all kernels) "
            f"{sum(parts.values()):.4f}")
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
                       "device_ms": sum(parts.values()),
                       "sample_stride": 1 << plan.sample_log2,
                       "scratch_bytes": scratch}
        del x, wy, th
    b1, c1, f1, q1 = STUMP_SMALL
    x, wy, th = opt_inputs(b1, c1, f1, seed=10)
    small_ms = time_ms(lambda: ops.stump_scores(x, wy, th), reps=10)
    small_device_ms = sum(device_breakdown(
        lambda: ops.stump_scores(x, wy, th)).values())
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
    log(f"stump at {list(STUMP_SMALL)}: kernel_ms {small_ms:.4f} "
        f"device_ms per call (profiler) {small_device_ms:.4f} plain_ms "
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
            "at_library_shape": {"ms": small_ms,
                                 "device_ms": small_device_ms,
                                 "plain_ms": small_plain_ms,
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
    check(launches == {**out["kernel_launches"], "flash_attention": 0,
                       "decode_attention": 0},
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


def assert_same_protocol(ref, got, name: str) -> None:
    """Every task's protocol outputs equal between two results of one
    argv: the result arrays the parity bar holds, each finished task's
    dispute table with its D-table counts, and every ledger (the final
    classifier is a function of these)."""
    for f in ("hypotheses", "rounds", "ok", "attempts", "alive",
              "disputed", "hist_stuck", "hist_rounds", "hist_alive",
              "hist_p", "hist_players", "hist_players_h",
              "hist_players_last"):
        check(np.array_equal(getattr(ref, f), getattr(got, f)),
              f"{name}: {f} differs between the engines")
    for b in range(ref.batch):
        check(ref.ledger(b) == got.ledger(b), f"{name} task {b}: ledgers "
              f"differ: {ref.ledger(b)} != {got.ledger(b)}")
        if ref.ok[b]:
            rt, gt = ref.per_task(b), got.per_task(b)
            check(all(map(np.array_equal,
                          (rt.dispute_x, *rt.dispute_y),
                          (gt.dispute_x, *gt.dispute_y))),
                  f"{name} task {b}: dispute tables differ")


def check_sharded(out, res, ledger, cls, name) -> None:
    """The sharded run's own gates: the ledger validated on every
    finished task, one NCCL rank, and the collectives it made equal to
    the census for every step."""
    check(out["ledger_vs_payload"] == f"validated_{out['ok']}/"
          f"{res.batch}", f"{name}: ledger_vs_payload "
          f"{out['ledger_vs_payload']}")
    check((out["backend"], out["mesh_devices"]) == ("nccl", 1),
          f"{name}: backend {out['backend']}, {out['mesh_devices']} ranks")
    census = ledger.collective_sites_per_round(cls)
    want = {k: n * res.steps for k, n in census.items()}
    check(out["collective_calls"] == want, f"{name}: collectives "
          f"{out['collective_calls']} != census {census} x {res.steps} "
          f"steps")
    log(f"{name}: ledger {out['ledger_vs_payload']}, backend "
        f"{out['backend']}, mesh_devices {out['mesh_devices']}, "
        f"collective_bytes_max {out['collective_bytes_max']}, "
        f"collectives {out['collective_calls']} = census {census} x "
        f"{res.steps} steps")


def phase_sharded(serve, ledger, argv, name, ref) -> tuple[dict, object,
                                                           dict]:
    """One path through the sharded engine (:func:`drive`), held to the
    batched engine's result ``ref`` of the same argv on every protocol
    output.  Returns (serve JSON, result, launches)."""
    args, out, res, _, _, launches = drive(serve, argv + SHARD, name)
    cls = serve.make_class(args)
    check_sharded(out, res, ledger, cls, name)
    check(res.steps == ref.steps, f"{name}: {res.steps} steps, the "
          f"batched engine {ref.steps}")
    assert_same_protocol(ref, res, name)
    log(f"{name}: every protocol output equals the batched engine's "
        f"({out['ok']} of {args.batch} ok); ms/step sharded "
        f"{out['wall_s'] * 1e3 / max(res.steps, 1):.2f}")
    return out, res, launches


def phase_host_loop(serve, classify, prng, argv, ref) -> dict:
    """``classify.run_accurately_classify`` on the card for task 0 of
    the batched run ``ref`` of ``argv``: its protocol outputs equal
    ``ref.per_task(0)``.  Returns the kernels' launches."""
    args = serve.build_parser().parse_args(argv)
    cls = serve.make_class(args)
    cfg = serve.make_config(args, cls)
    key = prng.split(prng.key(args.seed, device="cuda"), args.batch)[0]
    for _, ops in serve.KERNELS.values():
        ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = classify.run_accurately_classify(ref.x[0], ref.y[0], key, cfg,
                                           cls, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: ops.launches for k, (_, ops) in serve.KERNELS.items()}
    want = ref.per_task(0)
    check((got.attempts, got.rounds, got.stuck_history)
          == (want.attempts, want.rounds, want.stuck_history),
          f"host loop: attempts/rounds/stuck {got.attempts} {got.rounds} "
          f"{got.stuck_history} != {want.attempts} {want.rounds} "
          f"{want.stuck_history}")
    check(np.array_equal(got.hypotheses[:got.rounds],
                         want.hypotheses[:want.rounds]),
          "host loop: hypotheses differ")
    check(got.ledger == want.ledger,
          f"host loop: ledger {got.ledger} != {want.ledger}")
    order = np.argsort(got.dispute_x, kind="stable")
    check(all(np.array_equal(g[order], w) for g, w in zip(
        (got.dispute_x, *got.dispute_y), (want.dispute_x, *want.dispute_y))),
        "host loop: dispute tables differ")
    rounds = got.ledger.rounds
    check(launches["mw_update"] == rounds,
          f"host loop: {launches['mw_update']} mw_update launches for "
          f"{rounds} rounds")
    log(f"host loop: task 0 of m = {args.m} equal to the batched engine's "
        f"({got.attempts} attempts, {rounds} rounds, stuck "
        f"{got.stuck_history}); {secs:.3f} s, {secs / got.attempts:.3f} s "
        f"per attempt, {secs * 1e3 / rounds:.2f} ms per round; launches "
        f"{launches}")
    return launches


def phase_sharded_card_vs_cpu(sharded, prng, tasks, weak) -> None:
    """The sharded engine on the card (one NCCL rank) and on the CPU
    (one gloo rank), equal on every protocol field and wire counter:
    thresholds, thresholds without a center, a voting-mode tree."""
    from repro_torch.core.types import BoostConfig

    thr = weak.make_class("thresholds", n=4096)
    tree = weak.make_class("tree", num_features=4, tree_depth=2,
                           tree_bins=8, tree_comm_mode="voting")
    runs = [("thresholds", thr, False, BoostConfig(
        k=4, coreset_size=100, domain_size=4096, opt_budget=16)),
        ("thresholds/no center", thr, True, BoostConfig(
            k=4, coreset_size=100, domain_size=4096, opt_budget=16)),
        ("tree/voting", tree, False, BoostConfig(
            k=4, coreset_size=100, domain_size=4096, opt_budget=16,
            deterministic_coreset=False))]
    res = {}
    for dev in ("cuda", "cpu"):
        with sharded.make_players_group(4, dev) as g:
            for name, cls, no_center, cfg in runs:
                x, y, _ = tasks.make_batch(cls, 2, 512, 4, 3, seed0=7)
                res[name, dev] = sharded.run_accurately_classify_sharded(
                    x, y, prng.split(prng.key(5, device=dev), 2), cfg, cls,
                    group=g, no_center=no_center)
    for name, *_ in runs:
        card, cpu = res[name, "cuda"], res[name, "cpu"]
        check((card.backend, cpu.backend) == ("nccl", "gloo"),
              f"sharded card vs cpu, {name}: {card.backend}, {cpu.backend}")
        assert_same_protocol(cpu, card, f"sharded card vs cpu, {name}")
        for f in ("hist_wire_core", "hist_wire_ws", "hist_wire_hist",
                  "hist_wire_votes", "wire_bytes", "wire_q_points",
                  "wire_q_counts"):
            check(np.array_equal(getattr(card, f), getattr(cpu, f)),
                  f"sharded card vs cpu, {name}: {f} differs")
        check(card.collective_calls == cpu.collective_calls,
              f"sharded card vs cpu, {name}: collectives differ")
        log(f"sharded card vs cpu, {name}: every field equal on 2 tasks "
            f"({card.steps} steps, ok {int(card.ok.sum())}, collectives "
            f"{card.collective_calls})")


def phase_chunked_tree(serve, ledger, batched, prng, tasks, weak, hist_ops,
                       depth) -> tuple[dict, dict]:
    """The tree run with chunked histograms (``--chunk-size 128``) at
    m = 2^14, every histogram launch on the "chunked" route; then the
    chunked tree on the card against the CPU at B = 2, m = 256, where
    the pooled coreset has the same 400 points in 4 tiles (a CPU run at
    B = 16, m = 2^14 would run far past this script's time limit).  The
    engine's tree weights are not dyadic, so the chunked run is held to
    the CPU and not to the monolithic run, whose sums take another
    order.  Returns (the run's launches, its histogram routes)."""
    hist_ops.route_launches = dict.fromkeys(hist_ops.route_launches, 0)
    _, res, launches = phase_slice(serve, ledger, CHUNK_TREE_ARGS,
                                   "chunked tree run")
    routes = dict(hist_ops.route_launches)
    check(launches["histogram"] == depth * res.steps
          and routes == {"sort": 0, "tiled": 0,
                         "chunked": launches["histogram"]},
          f"chunked tree run: histogram launches {launches['histogram']}, "
          f"routes {routes}, {res.steps} steps")
    check(res.ok.any(), "chunked tree run: no task finished")
    log(f"chunked tree run: histogram routes {routes}")
    args = serve.build_parser().parse_args(CHUNK_TREE_ARGS)
    cls = serve.make_class(args)
    cfg = serve.make_config(args, cls)
    x, y, _ = tasks.make_batch(cls, 2, 256, 4, 2, seed0=3)
    out, small = {}, {}
    for dev in ("cuda", "cpu"):
        hist_ops.route_launches = dict.fromkeys(hist_ops.route_launches, 0)
        out[dev] = batched.run_accurately_classify_batched(
            x, y, prng.split(prng.key(5, device=dev), 2), cfg, cls,
            device=dev)
        small[dev] = dict(hist_ops.route_launches)
    check(small["cpu"] == dict.fromkeys(small["cpu"], 0)
          and small["cuda"]["chunked"] == depth * out["cuda"].steps
          and small["cuda"]["sort"] == small["cuda"]["tiled"] == 0,
          f"chunked tree, card vs cpu: routes {small}")
    for b in range(2):
        card, cpu = (protocol_outputs(out[d], b) for d in ("cuda", "cpu"))
        check(card == cpu, f"chunked tree, card vs cpu, task {b}: protocol "
              f"outputs differ in {[k for k in card if card[k] != cpu[k]]}")
    log(f"chunked tree, card vs cpu (B = 2, m = 256): protocol outputs "
        f"equal ({out['cuda'].steps} steps, ok {int(out['cuda'].ok.sum())},"
        f" card routes {small['cuda']})")
    return launches, routes


def phase_sketch(streaming, chunks, approximation) -> dict:
    """The sketch build at the reference's benchmark scale on the card,
    through the pinned double-buffered feed: measured approximation
    error ≤ the sketch's bound ≤ ε, the sketch equal to the CPU's
    (fields and coreset indices), points/s and peak memory beside the
    monolithic quantile coreset of the same sample."""
    m, n, tile, cap, c = (SKETCH[k] for k in ("m", "n", "tile", "cap", "c"))
    rng = np.random.default_rng(m)
    x = rng.integers(0, n, size=m).astype(np.int32)
    y = rng.choice(np.array([-1, 1], np.int8), size=m)
    hits = rng.integers(0, SKETCH["hmax"], size=m).astype(np.int32)
    alive = np.ones(m, bool)
    w = streaming.sketch_weights(torch.from_numpy(hits),
                                 torch.from_numpy(alive)).numpy()

    def build(dev):
        return streaming.build_sketch(
            chunks.iter_shard_chunks(x, y, w, tile, device=dev), cap, n=n)

    build("cuda")                                         # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sk = build("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    idx = streaming.sketch_coreset(sk, c)
    bound = float(streaming.coreset_bound(sk, c))
    dev_arrays = [torch.from_numpy(v).cuda() for v in (x, y, hits, alive)]
    theta = np.arange(0, n + 1, 256, dtype=np.int32)
    grid = torch.from_numpy(np.stack(
        [np.concatenate([theta, theta]),
         np.concatenate([np.ones_like(theta), -np.ones_like(theta)])],
        axis=1)).cuda()

    def predict(params, pts):
        return (torch.where(pts <= params[:, 0:1], 1, -1)
                * params[:, 1:2]).to(torch.int8)

    measured = float(approximation.approximation_error(
        idx, *dev_arrays, predict, grid))
    check(measured <= bound <= EPS_APPROX,
          f"sketch: measured {measured} <= bound {bound} <= {EPS_APPROX} "
          f"violated")
    cpu = build("cpu")
    for f in streaming.QuantileSketch._fields:
        a, b = getattr(sk, f).cpu(), getattr(cpu, f)
        same = (torch.equal(a.view(torch.int32), b.view(torch.int32))
                if a.dtype == torch.float32 else torch.equal(a, b))
        check(same, f"sketch: field {f} differs between the card and the "
              f"CPU")
    check(torch.equal(idx.cpu(), streaming.sketch_coreset(cpu, c)),
          "sketch: coreset indices differ between the card and the CPU")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mono = approximation.quantile_coreset(
        *[torch.from_numpy(v).cuda() for v in (x, y, hits, alive)], c)
    torch.cuda.synchronize()
    mono_wall = time.perf_counter() - t0
    mono_peak = torch.cuda.max_memory_allocated()
    log(f"sketch m={m} tile={tile} cap={cap} c={c}: measured {measured:.6f}"
        f" <= bound {bound:.6f} <= eps {EPS_APPROX}; card == cpu on every "
        f"field and the {c} indices; build {wall:.4f} s "
        f"({m / wall:,.0f} points/s, feed included), peak "
        f"{peak} bytes; monolithic quantile_coreset {mono_wall:.4f} s "
        f"({m / mono_wall:,.0f} points/s, transfer included), peak "
        f"{mono_peak} bytes (err_p {float(sk.err_p):.6g} gran_p "
        f"{float(sk.gran_p):.6g}, {mono.shape[0]} indices)")
    return {"measured": measured, "bound": bound, "build_s": wall,
            "peak_bytes": peak, "mono_s": mono_wall, "mono_peak": mono_peak}


def lane_outputs(res, b: int) -> dict:
    """Lane b's protocol outputs as the scheduler's parity bar holds
    them: ok, attempts, rounds, the hypotheses buffer, the disputed
    mask, the stuck history and every ledger field."""
    return {"ok": bool(res.ok[b]), "attempts": int(res.attempts[b]),
            "rounds": int(res.rounds[b]),
            "hypotheses": res.hypotheses[b].tobytes(),
            "disputed": res.disputed[b].tobytes(),
            "stuck": res.hist_stuck[b].tobytes(),
            "ledger": dataclasses.asdict(res.ledger(b))}


def drive_stream(serve, argv, name, ckpt_dir=None):
    """One serve-stream run through the serve entry point, every
    kernel's count set to 0 just before the stream (after the warmup,
    which launches nothing) and read just after; checks the counts
    against the JSON's, one mw_update launch per engine step of every
    dispatch, every request served and no program built after the
    warmup.  Returns (serve JSON, completions, scheduler, launches); the
    caller closes the scheduler."""
    argv = list(argv) + ([] if ckpt_dir is None else ["--ckpt-dir",
                                                      ckpt_dir])
    args = serve.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    out, done, sched = serve.run_serve_stream(args)
    total_s = time.perf_counter() - t0
    launches = {k: ops.launches for k, (_, ops) in serve.KERNELS.items()}
    log(f"{name}:", json.dumps(out))
    check(launches == {**out["kernel_launches"], "stump": 0,
                       "flash_attention": 0, "decode_attention": 0},
          f"{name}: launch counts {launches} != {out['kernel_launches']}")
    results = {id(c.result): c.result for c in done}.values()
    steps = sum(r.steps for r in results)
    # ms per engine step of the dispatches that ran whole (a resumed
    # one's service time is its resume's only)
    whole = {id(c.result): (c.service_s, c.result.steps) for c in done
             if not c.resumed}.values()
    step_ms = 1e3 * sum(t for t, _ in whole) / max(sum(n for _, n in whole),
                                                   1)
    check(launches["mw_update"] == steps > 0,
          f"{name}: mw_update launches {launches['mw_update']} != the "
          f"dispatches' {steps} engine steps")
    check(out["served"] == out["requests"] == len(done),
          f"{name}: served {out['served']} of {out['requests']}")
    check(out["steady_compiles"] == 0,
          f"{name}: {out['steady_compiles']} programs built after warmup")
    log(f"{name}: ok {out['ok']} of {out['requests']}, tasks_per_s "
        f"{out['tasks_per_s']}, p50 {out['p50_latency_s']} s, p99 "
        f"{out['p99_latency_s']} s, dispatches {out['dispatches']} "
        f"({len(results)} results, {steps} steps), cache hits "
        f"{out['cache_hits']} builds {out['cache_compiles']} (steady "
        f"{out['steady_compiles']}), filler lanes {out['filler_lanes']}, "
        f"ms/step of the whole dispatches {step_ms:.2f}, "
        f"run_serve_stream {total_s:.2f} s in all, launches {launches}")
    for bk, v in out["buckets"].items():
        log(f"{name} bucket {bk}: {json.dumps(v)}")
    return out, done, sched, launches


def hold_to_one_shot(sched, done, name, per_shape: int = 1) -> None:
    """The first ``per_shape`` completions of each request shape held to
    ``one_shot`` (B = 1, the same bucket) bit for bit."""
    seen: dict = {}
    for c in done:
        if seen.get(c.request.m, 0) >= per_shape:
            continue
        seen[c.request.m] = seen.get(c.request.m, 0) + 1
        one = sched.one_shot(c.request)
        got, want = lane_outputs(c.result, c.lane), lane_outputs(one, 0)
        check(got == want, f"{name}: request {c.request.rid} (m = "
              f"{c.request.m}, B = {c.bucket.B}) differs from one_shot in "
              f"{[k for k in got if got[k] != want[k]]}")
        log(f"{name}: request {c.request.rid} (m = {c.request.m}, lane "
            f"{c.lane} of B = {c.bucket.B}{', resumed' if c.resumed else ''}"
            f") equal to one_shot bit for bit ({want['attempts']} "
            f"attempts, {want['rounds']} rounds)")


def phase_serve_stream(serve) -> tuple[dict, dict]:
    """The scheduler at the thresholds slice's serving scale: every
    request ok, no build after the warmup, one request of each shape
    held to ``one_shot``.  Returns ({rid: lane outputs}, launches)."""
    out, done, sched, launches = drive_stream(serve, STREAM_ARGS,
                                              "serve-stream")
    try:
        check(out["ok"] == out["requests"],
              f"serve-stream: ok {out['ok']} of {out['requests']}")
        hold_to_one_shot(sched, done, "serve-stream")
    finally:
        sched.close()
    return {c.request.rid: lane_outputs(c.result, c.lane)
            for c in done}, launches


def phase_serve_stream_preempted(serve, obs_trace, obs_metrics,
                                 ref) -> dict:
    """The first 16 requests of the stream, dispatch 0 preempted after
    30 rounds and its resume after 10 more: every completion equal to
    the unpreempted stream's of the same request id, two preemptions
    and two resumes, the checkpoint directory empty at the end; reports
    the checkpoint timings and the snapshots' bytes.  Returns the
    launches."""
    reg = obs_metrics.reset_default_registry()
    with tempfile.TemporaryDirectory() as ckpt, \
            obs_trace.recording() as rec:
        out, done, sched, launches = drive_stream(
            serve, PREEMPT_STREAM_ARGS, "preempted stream", ckpt)
        sched.close()
        left = os.listdir(ckpt)
    check((out["preemptions"], out["resumes"]) == (2, 2),
          f"preempted stream: {out['preemptions']} preemptions, "
          f"{out['resumes']} resumes")
    check(left == [], f"preempted stream: checkpoints left: {left}")
    check(sum(c.resumed for c in done) >= 1, "preempted stream: no "
          "completion came through a resume")
    for c in done:
        got = lane_outputs(c.result, c.lane)
        want = ref[c.request.rid]
        check(got == want, f"preempted stream: request {c.request.rid} "
              f"differs from the unpreempted stream's in "
              f"{[k for k in got if got[k] != want[k]]}")
    writes = [e["args"] for e in rec.events if e["name"] == "ckpt_write"]
    full = [a["bytes"] for a in writes if a["full"]]
    incr = [a["bytes"] for a in writes if not a["full"]]
    check(len(full) == len(incr) == 1 and incr[0] < full[0],
          f"preempted stream: snapshot bytes full {full}, incremental "
          f"{incr}")
    m = reg.to_dict()
    log(f"preempted stream: {len(done)} completions equal to the "
        f"unpreempted stream's, {sum(c.resumed for c in done)} through a "
        f"resume; snapshot bytes full {full[0]}, incremental {incr[0]} "
        f"({incr[0] / full[0]:.4f}); ckpt.save_s sum "
        f"{m['ckpt.save_s']['sum']:.4f} s over {m['ckpt.save_s']['count']}"
        f" saves, ckpt.restore_s sum {m['ckpt.restore_s']['sum']:.4f} s "
        f"over {m['ckpt.restore_s']['count']} restores")
    return launches


def phase_serve_stream_sharded(serve) -> dict:
    """The stream over the sharded engine's one NCCL rank, with
    ``--trace-out`` and ``--metrics-out``: the ledger validated on every
    ok lane, no build after the warmup, the trace Chrome JSON with the
    dispatch, compile, run_rounds and finalize spans, the metrics the
    scheduler's and its cache's.  Returns the launches."""
    with tempfile.TemporaryDirectory() as d:
        trace, metrics = os.path.join(d, "t.json"), os.path.join(d, "m.json")
        args = serve.build_parser().parse_args(
            SHARD_STREAM_ARGS + ["--trace-out", trace, "--metrics-out",
                                 metrics])
        for _, ops in serve.KERNELS.values():
            ops.launches = 0
        out = serve.run_workload(args)
        launches = {k: ops.launches for k, (_, ops) in serve.KERNELS.items()}
        with open(trace, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        with open(metrics, encoding="utf-8") as f:
            names = set(json.load(f))
    log("sharded stream:", json.dumps(out))
    check(launches == {**out["kernel_launches"], "stump": 0,
                       "flash_attention": 0, "decode_attention": 0}
          and launches["mw_update"] > 0,
          f"sharded stream: launches {launches}, JSON "
          f"{out['kernel_launches']}")
    check(out["ledger_validated"] == out["ok"] > 0,
          f"sharded stream: ledger_validated {out['ledger_validated']} of "
          f"{out['ok']} ok")
    check(out["steady_compiles"] == 0 and out["served"] == 16,
          f"sharded stream: steady builds {out['steady_compiles']}, served "
          f"{out['served']}")
    spans = {e["name"] for e in events if e.get("ph") == "X"}
    dispatch_ms = sum(e["dur"] for e in events
                      if e["name"] == "dispatch") / 1e3
    check({"dispatch", "compile", "run_rounds", "finalize"} <= spans,
          f"sharded stream: trace spans {sorted(spans)}")
    want = {"scheduler.dispatches", "scheduler.served",
            "scheduler.compile_cache.hits",
            "scheduler.compile_cache.compiles"}
    check(want <= names, f"sharded stream: metrics {sorted(names)}")
    log(f"sharded stream: ok {out['ok']} of 16, ledger_validated "
        f"{out['ledger_validated']}, tasks_per_s {out['tasks_per_s']}, p50 "
        f"{out['p50_latency_s']} s, p99 {out['p99_latency_s']} s, ms/step "
        f"of the dispatches {dispatch_ms / launches['mw_update']:.2f} "
        f"(the trace's dispatch spans over the mw_update launches); trace "
        f"{len(events)} events, spans {sorted(spans)}; {len(names)} "
        f"metrics")
    for bk, v in out["buckets"].items():
        log(f"sharded stream bucket {bk}: {json.dumps(v)}")
    return launches


def phase_serve_stream_tree(serve, hist_ops, depth) -> tuple[dict, dict]:
    """A tree stream with one preemption: every histogram launch of
    every dispatch (the resumed one included) on the kernel's "sort"
    route, two completions held to ``one_shot``.  Returns (launches,
    routes)."""
    hist_ops.route_launches = dict.fromkeys(hist_ops.route_launches, 0)
    with tempfile.TemporaryDirectory() as ckpt:
        out, done, sched, launches = drive_stream(
            serve, TREE_STREAM_ARGS, "tree stream", ckpt)
        routes = dict(hist_ops.route_launches)
        try:
            check((out["preemptions"], out["resumes"]) == (1, 1),
                  f"tree stream: {out['preemptions']} preemptions, "
                  f"{out['resumes']} resumes")
            steps = sum({id(c.result): c.result.steps
                         for c in done}.values())
            check(launches["histogram"] == depth * steps
                  and routes == {"sort": launches["histogram"], "tiled": 0,
                                 "chunked": 0},
                  f"tree stream: histogram launches "
                  f"{launches['histogram']}, routes {routes}, {steps} "
                  f"steps")
            resumed = [c for c in done if c.resumed]
            picks = resumed[:1] + [c for c in done if not c.resumed][:1]
            hold_to_one_shot(sched, picks, "tree stream", per_shape=2)
        finally:
            sched.close()
    log(f"tree stream: histogram routes {routes}")
    return launches, routes


def device_trace_frames_kernel(doc: dict, region: str, kernel: str,
                               count: int) -> None:
    """The profiler's Chrome trace holds ``count`` launches of a kernel
    whose name holds ``kernel``, each inside a ``region`` range: its
    launch call inside the host range (matched by the trace's
    correlation ids), or the kernel inside the region's device range."""
    evs = doc["traceEvents"]
    regions = [e for e in evs if e.get("name") == region
               and e.get("ph") == "X"]
    host = [e for e in regions if e.get("cat") != "gpu_user_annotation"]
    dev = [e for e in regions if e.get("cat") == "gpu_user_annotation"]
    kernels = [e for e in evs if e.get("cat") == "kernel"
               and kernel in e.get("name", "")]
    calls = {e["args"]["correlation"]: e for e in evs
             if e.get("cat") == "cuda_runtime"
             and "correlation" in (e.get("args") or {})}

    def inside(t, spans):
        return any(r["ts"] <= t <= r["ts"] + r["dur"] for r in spans)

    check(host and len(kernels) == count,
          f"device trace: {len(host)} {region} ranges, {len(kernels)} "
          f"{kernel} kernels (want {count})")
    for k in kernels:
        call = calls.get((k.get("args") or {}).get("correlation"))
        check((call is not None and inside(call["ts"], host))
              or inside(k["ts"], dev),
              f"device trace: {kernel} kernel at {k['ts']} is not inside "
              f"a {region} range")


def phase_traced_rounds(serve, batched, prng, tasks, roundtrace,
                        obs_trace) -> dict:
    """``trace_rounds`` on the thresholds slice (B = 16, m = 2^20): the
    traced wire bits equal every task's ledger bit for bit and the run
    equals the untraced one; ms per step with the recorder against
    without, in the same call; then a ``device_trace`` of two rounds
    whose profiler events hold the mw_update kernel inside the
    ``run_rounds`` region.  Returns the traced run's launches."""
    args = serve.build_parser().parse_args(SLICE_ARGS)
    cls = serve.make_class(args)
    cfg = serve.make_config(args, cls)
    x, y, _ = tasks.make_batch(cls, args.batch, args.m, args.k, args.noise,
                               seed0=args.seed)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    keys = prng.split(prng.key(args.seed, device="cuda"), args.batch)
    alive0 = np.ones(tuple(x.shape), bool)

    def fresh():
        return batched.init_state(x, y, keys, cfg, cls=cls, device="cuda")

    s = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = batched.run_rounds(s, x, y, cfg, cls)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_steps = int(s.step.max())
    plain = batched.finalize(s, x, y, alive0, cfg, cls, steps=plain_steps)
    for _, ops in serve.KERNELS.values():
        ops.launches = 0
    rec = obs_trace.TraceRecorder()
    s = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs_trace.recording(rec):
        s = roundtrace.trace_rounds(
            lambda st: batched.run_rounds(st, x, y, cfg, cls, n=1), s, cfg,
            cls, recorder=rec)
    torch.cuda.synchronize()
    traced_s = time.perf_counter() - t0
    launches = {k: ops.launches for k, (_, ops) in serve.KERNELS.items()}
    traced = batched.finalize(s, x, y, alive0, cfg, cls,
                              steps=int(s.step.max()))
    check(launches["mw_update"] == traced.steps == plain_steps,
          f"traced rounds: {launches['mw_update']} mw_update launches, "
          f"{traced.steps} steps, untraced {plain_steps}")
    assert_same_protocol(plain, traced, "traced rounds")
    report = roundtrace.validate_trace(
        rec, {b: traced.ledger(b) for b in range(args.batch)})
    rounds = sum(1 for e in rec.events if e["name"] == "round")
    log(f"traced rounds: validate_trace passed on {len(report)} tasks "
        f"({rounds} round spans, {len(rec.events)} events); ms/step traced "
        f"{traced_s * 1e3 / traced.steps:.2f} vs untraced "
        f"{plain_s * 1e3 / plain_steps:.2f} ({plain_steps} steps)")
    s = fresh()
    with tempfile.TemporaryDirectory() as d:
        with obs_trace.recording(), obs_trace.device_trace(d):
            for _ in range(2):
                s = batched.run_rounds(s, x, y, cfg, cls, n=1)
        with open(os.path.join(d, "trace.json"), encoding="utf-8") as f:
            doc = json.load(f)
    device_trace_frames_kernel(doc, "run_rounds", "mw_update", 2)
    log("traced rounds: the device trace holds 2 mw_update kernels, each "
        "inside a run_rounds region")
    return launches


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
    dev_ms, _ = device_ms(lambda: ops.flash_attention(q, k, v), calls=10)
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
        f"kernel_ms {kernel_ms:.4f} (CUDA events) device_ms "
        f"{fmt_ms(dev_ms)} (profiler) plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (scaled_dot_product_attention; max abs "
        f"difference from the kernel {lib_err:.3g}) bound_ms "
        f"{bound_ms:.4f} ({flops} FLOP at {peak / 1e12:.0f} TFLOP/s "
        f"{ops_ms:.4f} ms, {bytes_ms:.4f} ms of bytes) share_of_bound "
        f"{bound_ms / kernel_ms:.4f}, {library_ms / kernel_ms:.3f} of SDPA's "
        f"speed")
    return {"shape": list(shape), "dtype": str(dtype)[6:],
            "kernel_route": route, "ms": kernel_ms, "device_ms": dev_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "share_of_bound": bound_ms / kernel_ms}


def phase_flash(ops, kernel, build) -> dict:
    """The flash kernel against its plain version (full softmax in
    float32) at the reference's sweep in both types (float32 on the
    CUDA-core route at 2e-5, bf16 on the wgmma route at 2e-2), the LM
    slice's shape, qwen3-32b's widths, a ragged S, S under 64, hd 256,
    G = 8, the MoE headline's prefill and pixtral-12b's (hd 160); the
    SASS of the wgmma route; timed at the slice's shape, qwen3-32b's,
    the headline's and pixtral's beside the plain version and SDPA, and
    the float32 route at the slice's shape.  Returns its JSON entry
    (without launches)."""
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
    moe = time_flash(ops, kernel, FLASH_MOE, torch.bfloat16, seed=10)
    pixtral = time_flash(ops, kernel, FLASH_PIXTRAL, torch.bfloat16, seed=11)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
            "max_abs_err": max_abs, "ms": main["ms"],
            "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "kernel_route": main["kernel_route"],
            "share_of_bound": main["share_of_bound"], "path": "lm",
            "paths": {"lm": main, "lm_moe": moe, "pixtral-12b": pixtral},
            "qwen3_32b_widths": qwen,
            "float32_route": fp32, "sass": sass}


def decode_inputs(B, C, lens, H, KV, hd, seed):
    """q, the token's k and v, the cache (every slot filled, live or
    not) in bf16, and lens int32 [B], on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    ts = [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
          for shape in ((B, 1, H, hd), (B, 1, KV, hd), (B, 1, KV, hd),
                        (B, C, KV, hd), (B, C, KV, hd))]
    return (*ts, torch.tensor(lens, dtype=torch.int32, device="cuda"))


def decode_work(B, live, H, KV, hd) -> tuple[int, int]:
    """(FLOPs, bytes) of one decode attention call: 4·hd per (query
    head, live slot or the token itself); the live K/V read once, q
    read and the output written, the token's k and v read and written
    into the cache, all bf16."""
    return (4 * hd * B * H * (live + 1),
            2 * (2 * B * KV * live * hd + 2 * B * H * hd + 4 * B * KV * hd))


def time_decode(ops, kernel, shape, seed) -> dict:
    """The kernel at one shape beside its plain version and SDPA
    (``scaled_dot_product_attention`` over the live keys, GQA; the port
    never calls it), with the bytes bound of the function."""
    B, C, live, H, KV, hd = shape
    args = decode_inputs(B, C, [live] * B, H, KV, hd, seed)
    want = ops.decode_attention(*args, interpret=True)
    before = ops.launches
    got = ops.decode_attention(*args)
    torch.cuda.synchronize()
    check(ops.launches == before + 1, "decode attention: launches did not "
          "count the call")
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=LM_TOL,
                         atol=LM_TOL),
          f"decode attention {list(shape)}: max_abs_err {err}")
    kernel_ms = time_ms(lambda: ops.decode_attention(*args), reps=50)
    dev_ms, parts = device_ms(lambda: ops.decode_attention(*args), calls=20)
    plain_ms = time_ms(lambda: ops.decode_attention(*args, interpret=True),
                       reps=5, warm=1)
    q = args[0].transpose(1, 2).contiguous()
    k, v = (t[:, :live].transpose(1, 2).contiguous() for t in args[3:5])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q, k, v, enable_gqa=KV != H), reps=50)
    flops, nbytes = decode_work(B, live, H, KV, hd)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    share = bound_ms / (dev_ms if dev_ms else kernel_ms)
    splits = kernel.plan(B, KV, H // KV, hd, C).splits
    log(f"decode attention {list(shape)} splits {splits}: kernel_ms "
        f"{kernel_ms:.4f} (CUDA events) device_ms {fmt_ms(dev_ms)} "
        f"(profiler: {parts}) plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (scaled_dot_product_attention over the live "
        f"keys) bound_ms {bound_ms:.4f} ({nbytes} bytes at 3.35 TB/s; "
        f"{flops} FLOP) share_of_bound {share:.4f}; max abs error to the "
        f"plain version {err:.3g}")
    return {"shape": list(shape), "splits": splits, "ms": kernel_ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "share_of_bound": share,
            "max_abs_err": err}


def phase_decode_attention(ops, kernel) -> dict:
    """The decode attention kernel against its plain version (bf16
    weights in P·V, where the kernel keeps them in float32) at
    ``DECODE_CHECKS`` and timed at deepseek-7b's decode cell and
    granite's widths.  Returns its JSON entry (without launches)."""
    max_abs = 0.0
    for i, (B, C, lens, H, KV, hd, window) in enumerate(DECODE_CHECKS):
        args = decode_inputs(B, C, lens, H, KV, hd, seed=300 + i)
        plain_cache = [t.clone() for t in args[3:5]]
        want = ops.decode_attention(*args[:3], *plain_cache, args[5], window,
                                    interpret=True)
        got = ops.decode_attention(*args, window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.allclose(got.float(), want.float(), rtol=LM_TOL,
                             atol=LM_TOL)
              and torch.equal(args[3], plain_cache[0])
              and torch.equal(args[4], plain_cache[1]),
              f"decode attention {B, C, lens, H, KV, hd, window}: max_abs_err "
              f"{err}, or the slot write differs")
        max_abs = max(max_abs, err)
        log(f"decode attention B {B} C {C} lens {lens} {H}/{KV} heads of "
            f"{hd} window {window} splits "
            f"{kernel.plan(B, KV, H // KV, hd, C).splits}: max_abs_err "
            f"{err:.3g} <= {LM_TOL}, cache write equal")
    main = time_decode(ops, kernel, DECODE_MAIN, seed=12)
    granite = time_decode(ops, kernel, DECODE_GRANITE, seed=13)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/"
                      "decode_attention.cu",
            "replaces": None, "max_abs_err": max(max_abs, main["max_abs_err"],
                                                 granite["max_abs_err"]),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": main["library_ms"],
            "share_of_bound": main["share_of_bound"], "path": "lm",
            "paths": {"lm": main, "granite-moe-3b-a800m": granite}}


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


@contextlib.contextmanager
def plain_decode_attention():
    """Run the models' decode attention through its plain version on the
    card (``interpret=True``: the einsum math that a DTensor cache runs)
    in place of the kernel, so a check of the DTensor route against the
    plain model compares the same attention."""
    from repro_torch.kernels.decode_attention import ops

    run = ops.decode_attention

    def plain(*args, **kw):
        return run(*args, **kw, interpret=True)

    ops.decode_attention = plain
    try:
        yield
    finally:
        ops.decode_attention = run


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def phase_lm_slice(serve, models, layers, transformer, adamw, obs_trace,
                   argv, name, expect) -> tuple[dict, dict]:
    """An LM at full width and depth through ``serve --workload lm``
    (:func:`drive_lm`: one flash launch per attention layer, every one
    on the wgmma route, no other kernel; finite logits and tokens); its
    config fields equal to ``expect``; the flash prefill's last-token
    logits against an einsum prefill of the same params and batch, and
    both against a prefill with float32 products; a profile of one
    prefill and a few decode steps, with flash's share of the device
    time (and the MoE FFN's, for an MoE config).  Returns the
    launches and flash's launches per route."""
    run, launches, routes = drive_lm(serve, transformer, adamw, argv, name)
    cfg = run.model.cfg
    check(all(getattr(cfg, k) == v for k, v in expect.items()),
          f"{name} ran {cfg.name}, not the config {expect}")
    log(f"{name}: first 8 generated tokens for seed 0: "
        f"{run.generated[0][:8].tolist()}")
    params, batch, flash_logits = run.params, run.batch, run.prefill_logits
    del run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_logits, caches = models.build(cfg).make_prefill_step()(params,
                                                                 batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    del caches
    err = rel_l2(flash_logits, plain_logits)
    log(f"{name}: flash vs einsum prefill, last-token logits relative L2 "
        f"{err:.6g} (gate {LM_REL_L2_GATE}); einsum prefill_s {plain_s:.3f}")
    check(err <= LM_REL_L2_GATE,
          f"{name}: flash vs einsum relative L2 {err} > {LM_REL_L2_GATE}")
    with float32_products(layers):
        f32_logits, caches = models.build(cfg).make_prefill_step()(params,
                                                                   batch)
    del caches
    to_f32 = [rel_l2(x, f32_logits) for x in (flash_logits, plain_logits)]
    log(f"{name}: against a prefill with float32 products, relative L2 of "
        f"the last-token logits: flash {to_f32[0]:.6g}, einsum "
        f"{to_f32[1]:.6g}")
    profile_lm(models, obs_trace, cfg, params, batch, name)
    del params, batch
    torch.cuda.empty_cache()
    return launches, routes


def profile_lm(models, obs_trace, cfg, params, batch, name) -> None:
    """Where a prefill's and a decode step's device time goes (the flash
    model; the decode steps after the decode graph's warm-up and
    capture): wall ms a step (profiled), device ms a step, the device's
    busy share, kernels a step, flash's share and the top kernels; for
    an MoE config the MoE FFN's share too — the device time of the
    kernels launched inside the model's ``moe_ffn`` spans, which the
    capture records under an active trace recorder."""
    from torch.profiler import ProfilerActivity, profile

    model = models.build(cfg, use_flash=True)
    prefill, decode = model.make_prefill_step(), model.make_decode_step()
    moe = bool(cfg.num_experts)
    with obs_trace.recording():
        for step, steps in (("prefill", 1), ("decode", 4)):
            if step == "decode":
                logits, caches = prefill(params, batch)
                # the decode graph's warm-up and capture, outside the
                # profile: it then holds the replays
                for _ in range(2):
                    logits, caches = decode(params, caches,
                                            batch["tokens"][:, :1])
                torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if step == "prefill":
                    logits, caches = prefill(params, batch)
                else:
                    for _ in range(steps):
                        logits, caches = decode(params, caches,
                                                batch["tokens"][:, :1])
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / steps
            del caches, logits
            events = prof.key_averages()
            cuda = torch.autograd.DeviceType.CUDA
            # each of the model's spans shows as a CPU range and, on the
            # GPU timeline, as an annotation span: kernels are the other
            # CUDA rows
            region = [e for e in events if e.key == "moe_ffn"]
            rows = [e for e in events
                    if e.device_type == cuda and e.key not in LM_SPANS]
            if not rows:
                log(f"profile {name} {step}: wall_ms {wall_ms:.2f} "
                    "(profiled); device time not measured (no kernels "
                    "recorded)")
                if step == "prefill":
                    PREFILL_MS[name] = (None, wall_ms)
                continue
            dev_ms = sum(e.self_device_time_total for e in rows) / steps / 1e3
            if step == "prefill":
                PREFILL_MS[name] = (dev_ms, wall_ms)
            flash_ms = sum(e.self_device_time_total for e in rows
                           if "flash_wgmma" in e.key) / steps / 1e3
            msg = (f"profile {name} {step}: wall_ms/step {wall_ms:.2f} "
                   f"(profiled), device_ms/step {dev_ms:.3f}, device busy "
                   f"share {dev_ms / wall_ms:.3f}, kernels/step "
                   f"{sum(e.count for e in rows) / steps:.0f}; flash (wgmma "
                   f"route) {flash_ms:.3f} ms/step, "
                   f"{flash_ms / dev_ms:.4f} of the device time")
            if moe:
                # the kernels launched in the region; else its GPU span
                inner = sum(e.device_time_total for e in region
                            if e.device_type != cuda)
                span = sum(e.self_device_time_total for e in region
                           if e.device_type == cuda)
                moe_ms = (inner or span) / steps / 1e3
                msg += (f"; MoE FFN {moe_ms:.3f} ms/step "
                        f"({'its kernels' if inner else 'its GPU span'}), "
                        f"{moe_ms / dev_ms:.4f} of the device time" if moe_ms
                        else "; MoE FFN share not measured (the region "
                             "holds no device time)")
            log(msg)
            for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
                log(f"  {e.self_device_time_total / steps / 1e3:8.3f} "
                    f"ms/step x{e.count / steps:5.0f}  {e.key[:90]}")


def flash_per_prefill(cfg, transformer) -> int:
    """Flash launches a prefill makes: one per attention layer of a
    decoder-only stack, none in the encoder-decoder (the reference's
    enc-dec takes no flash path)."""
    if cfg.encoder_layers:
        return 0
    return sum(m == "attn" for m, _ in transformer.layer_kinds(cfg))


def decode_per_step(cfg, transformer) -> int:
    """Decode attention calls a decode step makes: one per attention
    layer of a decoder-only stack, one per decoder layer (its
    self-attention) of the encoder-decoder."""
    if cfg.encoder_layers:
        return cfg.num_layers
    return sum(m == "attn" for m, _ in transformer.layer_kinds(cfg))


def drive_lm(serve, transformer, adamw, argv, name, cfg=None):
    """``serve.run_lm`` of ``argv`` (``cfg`` cuts depth) with every
    kernel's count set to 0 just before and read just after: one flash
    launch per attention layer, every one on the wgmma route, one
    decode attention call per attention layer and decode step, no other
    kernel; finite logits and tokens; the decode step replayed as one
    CUDA graph for an attention stack (a warm-up step, one capture, a
    replay for every later step), eager for the others.  Logs the
    init's seconds, the parameters (leaves), prefill_s,
    decode_s_per_token and peak memory.  Returns (run, launches, flash
    routes)."""
    from repro_torch.models import decode_graph
    from repro_torch.obs import metrics

    args = serve.build_parser().parse_args(argv)
    flash_ops = serve.KERNELS["flash_attention"][1]
    zero_counts(serve)
    flash_ops.route_launches = dict.fromkeys(flash_ops.route_launches, 0)
    torch.cuda.reset_peak_memory_stats()
    reg = metrics.reset_default_registry()
    out, run = serve.run_lm(args, cfg=cfg)
    launches = kernel_counts(serve)
    graph = {n: reg.counter(f"decode_graph.{n}").value
             for n in ("captures", "replays", "eager_steps")}
    want_graph = ({"captures": 1, "replays": args.gen - 1, "eager_steps": 1}
                  if decode_graph.graphable(run.model.cfg) and args.gen > 1
                  else {"captures": 0, "replays": 0, "eager_steps": args.gen})
    check(graph == want_graph,
          f"{name}: decode graph counts {graph} != {want_graph}")
    routes = dict(flash_ops.route_launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"{name}:", json.dumps(out))
    cfg = run.model.cfg
    want = flash_per_prefill(cfg, transformer)
    check(out["kernel_launches"]["flash_attention"]
          == launches["flash_attention"] == want,
          f"{name}: flash launches {launches} != {want} attention layers")
    check(routes == {"wgmma": want, "cuda_cores": 0},
          f"{name}: flash routes {routes}, not all {want} on wgmma")
    decoded = decode_per_step(cfg, transformer) * args.gen
    check(out["kernel_launches"]["decode_attention"]
          == launches["decode_attention"] == decoded,
          f"{name}: decode attention calls {launches} != {decoded}")
    check(not any(n for k, n in launches.items()
                  if k not in ("flash_attention", "decode_attention")),
          f"{name} launched a protocol kernel: {launches}")
    check(bool(torch.isfinite(run.prefill_logits).all())
          and bool(torch.isfinite(run.logits).all()),
          f"{name}: non-finite logits")
    check(out["tokens_finite"] and run.generated.shape == (
        args.batch, args.gen + 1), f"{name}: bad generated tokens")
    leaves = sum(t.numel() for t in adamw.tree_leaves(run.params))
    log(f"{name}: {cfg.name}, {cfg.num_layers} layers, {leaves} parameters "
        f"(truncated-normal draws: the leaves; param_count() "
        f"{cfg.param_count()}); init {run.init_s:.2f} s, "
        f"max_memory_allocated after it {run.init_peak_bytes} bytes; "
        f"prefill_s {out['prefill_s']} decode_s_per_token "
        f"{out['decode_s_per_token']} max_memory_allocated {peak} bytes; "
        f"flash routes {routes}; decode graph {graph}")
    return run, launches, routes


def phase_lm_families(serve, configs, transformer, adamw) -> dict:
    """The other families at full width, depth cut to fit the card and
    the script's time (``FAMILY_RUNS``), each through ``serve.run_lm``
    with its counts set to 0 just before and read just after; the width
    fields equal to the full config's.  Returns each run's launches."""
    runs = {}
    for arch, (layers, B, P, gen) in FAMILY_RUNS.items():
        full = configs.get_config(arch)
        cfg = (full if layers is None
               else dataclasses.replace(full, num_layers=layers))
        argv = with_flags(LM_ARGS, arch=arch, batch=B, prompt_len=P,
                          gen=gen)
        run, launches, _ = drive_lm(serve, transformer, adamw, argv,
                                    f"lm {arch}", cfg=cfg)
        ran = run.model.cfg
        check(all(getattr(ran, w) == getattr(full, w) for w in WIDTHS)
              and ran.num_layers == cfg.num_layers,
              f"{arch}: ran {ran.num_layers} layers and widths "
              f"{[w for w in WIDTHS if getattr(ran, w) != getattr(full, w)]}"
              f" that differ from the full config")
        runs[arch] = launches
        del run
        torch.cuda.empty_cache()
    return runs


def kernel_counts(serve) -> dict:
    return {k: ops.launches for k, (_, ops) in serve.KERNELS.items()}


def zero_counts(serve) -> None:
    for _, ops in serve.KERNELS.values():
        ops.launches = 0


def phase_train(serve, train, configs) -> dict:
    """``repro_torch.launch.train`` on deepseek-7b at full width, 4
    layers, seq 512, batch 8, 20 steps with the resilient quarantine:
    every loss and grad norm finite, no flash launch (the trainer runs
    the einsum path, as the reference's); seconds a step after the
    first, tokens/s, peak memory, the final loss and quarantine stats."""
    cfg = dataclasses.replace(configs.get_config("deepseek-7b"),
                              num_layers=TRAIN_LAYERS)
    check((cfg.d_model, cfg.num_heads, cfg.hd, cfg.d_ff, cfg.vocab_size)
          == (4096, 32, 128, 11008, 102400),
          f"train slice: {cfg.name} is not deepseek-7b's full width")
    args = train.build_parser().parse_args(TRAIN_ARGS)
    zero_counts(serve)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = train.run(args, cfg=cfg)
    total_s = time.perf_counter() - t0
    launches = kernel_counts(serve)
    peak = torch.cuda.max_memory_allocated()
    hist = res["history"]
    check([r["step"] for r in hist] == list(range(1, args.steps + 1)),
          f"train slice: logged steps {[r['step'] for r in hist]}")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in hist), "train slice: a non-finite loss or grad norm")
    check(launches == dict.fromkeys(launches, 0)
          and res["kernel_launches"] == {"flash_attention": 0},
          f"train slice launched a kernel: {launches}")
    step_s = (hist[-1]["elapsed_s"] - hist[0]["elapsed_s"]) / (len(hist) - 1)
    tokens = args.batch * args.seq_len
    log(f"train slice: {cfg.name} at {cfg.num_layers} layers, "
        f"{res['params']} parameters, batch {args.batch} x seq "
        f"{args.seq_len}; {step_s:.3f} s a step after the first "
        f"({tokens / step_s:.0f} tokens/s), first step "
        f"{hist[0]['elapsed_s']} s, max_memory_allocated {peak} bytes, "
        f"run {total_s:.1f} s in all (init and eval included)")
    log(f"train slice: losses {[round(r['loss'], 4) for r in hist]}")
    log(f"train slice: final train loss {res['final_train_loss']:.4f}, "
        f"clean eval loss {res['clean_eval_loss']:.4f}, quarantined "
        f"{res['quarantined']} alive {res['alive']} noise_recall "
        f"{res['noise_recall']:.3f} noise_precision "
        f"{res['noise_precision']:.3f}; launches {launches}")
    del res
    torch.cuda.empty_cache()
    return launches


def phase_train_card_vs_cpu(train) -> None:
    """The reduced model's first 3 training steps on the card and on the
    CPU: loss and grad norm within the model-path tolerance."""
    hist = {}
    for dev in ("cuda", "cpu"):
        args = train.build_parser().parse_args(TRAIN_SMOKE_ARGS
                                               + ["--device", dev])
        with contextlib.redirect_stdout(sys.stderr):
            hist[dev] = train.run(args)["history"]
    for a, b in zip(hist["cuda"], hist["cpu"]):
        for f in ("loss", "grad_norm"):
            check(abs(a[f] - b[f]) <= LM_TOL * abs(b[f]),
                  f"train card vs cpu: step {a['step']} {f} {a[f]} vs "
                  f"{b[f]}")
    log(f"train card vs cpu: steps 1-3 loss "
        f"{[r['loss'] for r in hist['cuda']]} (card) "
        f"{[r['loss'] for r in hist['cpu']]} (cpu), grad norm "
        f"{[r['grad_norm'] for r in hist['cuda']]} (card) "
        f"{[r['grad_norm'] for r in hist['cpu']]} (cpu), within {LM_TOL}")


def phase_semi_agnostic(serve, semi_agnostic, prng, tasks, weak,
                        types) -> dict:
    """The reduction baseline: Thresholds, m = 2^16 over k = 4 players,
    noise 8, coreset 100 — 96 rounds of a [4, 100, 16384] Gumbel draw
    on the card; E_S(f) ≤ E_S(g); then the whole result at m = 2048 on
    the card equal to the CPU's."""
    cls = weak.Thresholds(n=SEMI["n"])
    cfg = types.BoostConfig(k=SEMI["k"], coreset_size=SEMI["coreset"],
                            domain_size=SEMI["n"], opt_budget=SEMI["budget"])
    task = tasks.make_task(cls, m=SEMI["m"], k=SEMI["k"],
                           noise=SEMI["noise"], seed=0)
    zero_counts(serve)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = semi_agnostic.run_semi_agnostic(task.x, task.y, prng.key(0), cfg,
                                          cls)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernel_counts(serve)
    rounds = cfg.num_rounds(SEMI["m"])
    check(res.final_errors <= res.boost_errors,
          f"semi-agnostic: E_S(f) {res.final_errors} > E_S(g) "
          f"{res.boost_errors}")
    log(f"semi-agnostic: m {SEMI['m']} k {SEMI['k']} noise {SEMI['noise']}:"
        f" {rounds} rounds in {secs:.2f} s ({rounds / secs:.1f} rounds/s),"
        f" boost_errors {res.boost_errors} final_errors "
        f"{res.final_errors} patched {res.patched} bits "
        f"{res.ledger.total_bits}; launches {launches}")
    small = tasks.make_task(cls, m=2048, k=SEMI["k"], noise=SEMI["noise"],
                            seed=1)
    out = {dev: semi_agnostic.run_semi_agnostic(
        small.x, small.y, prng.key(1), cfg, cls, device=dev)
        for dev in ("cuda", "cpu")}
    a, b = out["cuda"], out["cpu"]
    check(dataclasses.asdict(a.ledger) == dataclasses.asdict(b.ledger)
          and (a.boost_errors, a.final_errors, a.patched)
          == (b.boost_errors, b.final_errors, b.patched)
          and np.array_equal(a.classifier.hypotheses,
                             b.classifier.hypotheses)
          and np.array_equal(a.classifier.dispute_x,
                             b.classifier.dispute_x),
          "semi-agnostic card vs cpu: the results differ at m = 2048")
    log(f"semi-agnostic card vs cpu (m = 2048): hypotheses, errors, "
        f"patch and ledger equal ({a.ledger.total_bits} bits)")
    return launches


def phase_lower_bound(serve, lower_bound, types) -> dict:
    """Theorem 2.3's reduction at r = 512, weight 256 (n = 2^12, k = 2,
    coreset 400, budget 3r + 8): both answers decided correctly by the
    host loop on the card; its mw_update launches counted."""
    cfg = types.BoostConfig(k=DISJ["k"], coreset_size=DISJ["coreset"],
                            domain_size=DISJ["n"],
                            opt_budget=3 * DISJ["r"] + 8)
    rng = np.random.default_rng(0)
    zero_counts(serve)
    for disjoint in (True, False):
        x, y = lower_bound.random_disj_instance(
            rng, r=DISJ["r"], weight=DISJ["weight"], disjoint=disjoint)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lower_bound.solve_disjointness(x, y, DISJ["n"], cfg,
                                             seed=DISJ["r"])
        secs = time.perf_counter() - t0
        check(out.disjoint_decided == disjoint,
              f"lower bound: r {DISJ['r']} disjoint={disjoint} decided "
              f"{out.disjoint_decided}")
        log(f"lower bound: r {DISJ['r']} weight {DISJ['weight']} "
            f"disjoint={disjoint}: decided correctly, errors {out.errors} "
            f"opt {out.opt} bits {out.total_bits} attempts {out.attempts} "
            f"in {secs:.2f} s")
    launches = kernel_counts(serve)
    check(launches["mw_update"] > 0,
          f"lower bound: the host loop launched no mw_update: {launches}")
    log(f"lower bound: launches {launches}")
    return launches


def phase_finite(serve, finite, weak) -> dict:
    """Section 6's finite-class learner at n = 2^12, |H| = 512, m = 2^20,
    k = 4: errors equal on the card and on the CPU."""
    n, H, m, k = FINITE["n"], FINITE["H"], FINITE["m"], FINITE["k"]
    grid = np.asarray([[2.0, t, t, s] for t in range(0, n, 2 * n // H)
                       for s in (1.0, -1.0)], np.float32)
    check(grid.shape[0] == H, f"finite: |H| {grid.shape[0]} != {H}")
    rng = np.random.default_rng(7)
    x = rng.integers(0, n, m).astype(np.int32)
    y = np.where(x >= n // 3, 1, -1).astype(np.int8)
    flip = rng.choice(m, size=256, replace=False)
    y[flip] = -y[flip]
    cls = weak.Thresholds(n=n)
    zero_counts(serve)
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[dev] = finite.learn_finite(x.reshape(k, -1), y.reshape(k, -1),
                                       grid, cls, device=dev)
        secs[dev] = time.perf_counter() - t0
    launches = kernel_counts(serve)
    a, b = out["cuda"], out["cpu"]
    check((a.errors, a.total_bits) == (b.errors, b.total_bits)
          and torch.equal(a.best_params.cpu(), b.best_params),
          f"finite: card {a.errors} errors, cpu {b.errors}")
    log(f"finite class: m {m} |H| {H} k {k}: errors {a.errors} (= OPT) "
        f"bits {a.total_bits}, equal on the card and the CPU; "
        f"{secs['cuda']:.3f} s on the card, {secs['cpu']:.2f} s on the "
        f"CPU; launches {launches}")
    return launches


def phase_lm_card_vs_cpu(models, configs, flash_ops, transformer, frontend,
                         prng, layers) -> None:
    """Reduced dense archs (deepseek-7b, qwen3-32b) and every reduced
    family (MoE, hybrid, xLSTM, vision prefix, encoder-decoder): the
    seed-0 parameters and the stub frontend's key-1 input made on the
    card bit-equal to those made on the CPU; prefill logits and 4
    teacher-forced decode steps on the card and on the CPU at the
    model-path tolerance; flash launches one per attention layer on the
    card, none on the CPU.  xLSTM's decode steps are held at
    ``CARD_CPU_DECODE_ATOL`` (its prefill at the tolerance), and at the
    tolerance with float32 products on both devices."""
    import numpy as np

    from repro_torch.optim import adamw

    for arch in ("deepseek-7b", "qwen3-32b") + FAMILIES:
        cfg = configs.reduced(configs.get_config(arch))
        model = models.build(cfg, use_flash=True)
        params = {"cpu": model.init(seed=0, device="cpu"),
                  "cuda": model.init(seed=0, device="cuda")}
        pairs = list(zip(adamw.tree_leaves(params["cuda"]),
                         adamw.tree_leaves(params["cpu"])))
        unequal = sum(int((a.cpu().view(torch.int32)
                           != b.view(torch.int32)).sum()) for a, b in pairs)
        check(unequal == 0, f"lm card vs cpu, {arch}: {unequal} weights "
              f"of the seed-0 init differ between the card and the CPU")
        log(f"lm card vs cpu, {cfg.name}: the seed-0 init is bit-equal on "
            f"the card and the CPU ({len(pairs)} leaves, "
            f"{sum(a.numel() for a, _ in pairs)} weights)")
        B, P, n = 2, 200, 4
        toks = np.random.default_rng(5).integers(
            0, cfg.vocab_size, size=(B, P + n)).astype(np.int32)
        extra = {}
        for dev in ("cuda", "cpu"):
            key = prng.key(1, dev)
            if cfg.frontend == "vit_stub":
                extra[dev] = {"prefix_embeds": frontend.synth_embeds(
                    key, cfg, B, cfg.frontend_tokens)}
            elif cfg.encoder_layers:
                extra[dev] = {"frames": frontend.synth_embeds(key, cfg, B, P)}
            else:
                extra[dev] = {}
        for name, t in extra["cuda"].items():
            check(torch.equal(t.cpu(), extra["cpu"][name]),
                  f"lm card vs cpu, {arch}: {name} differ")

        def run_on(dev):
            """Prefill and n teacher-forced decode steps on ``dev``:
            (logits [n + 1, B, Vp] on the CPU, flash launches)."""
            flash_ops.launches = 0
            t = torch.as_tensor(toks, device=dev)
            out, caches = model.make_prefill_step()(
                params[dev], {"tokens": t[:, :P], **extra[dev]})
            launches = flash_ops.launches
            steps = [out]
            for i in range(P, P + n):
                out, caches = model.make_decode_step()(params[dev], caches,
                                                       t[:, i:i + 1])
                steps.append(out)
            return torch.stack(steps).cpu(), launches

        (got, on_card), (want, on_cpu) = run_on("cuda"), run_on("cpu")
        want_launches = flash_per_prefill(cfg, transformer)
        check((on_card, on_cpu) == (want_launches, 0),
              f"lm card vs cpu, {arch}: flash launches {on_card} on the "
              f"card, {on_cpu} on the CPU")
        atol = CARD_CPU_DECODE_ATOL.get(arch, LM_TOL)
        pre, dec = [(got[s] - want[s]).abs().max().item()
                    for s in (slice(0, 1), slice(1, None))]
        check(torch.allclose(got[0], want[0], rtol=LM_TOL, atol=LM_TOL)
              and torch.allclose(got[1:], want[1:], rtol=LM_TOL, atol=atol),
              f"lm card vs cpu, {arch}: prefill logits differ by {pre}, "
              f"decode logits by {dec} (rtol {LM_TOL}, atol {LM_TOL} and "
              f"{atol})")
        log(f"lm card vs cpu, {cfg.name}: prefill max_abs_err {pre:.4g}, "
            f"{n} decode steps max_abs_err {dec:.4g} (rtol {LM_TOL}, atol "
            f"{LM_TOL} and {atol}); flash launches {on_card}")
        if arch in CARD_CPU_DECODE_ATOL:
            with float32_products(layers):
                got32, want32 = run_on("cuda")[0], run_on("cpu")[0]
            err32 = (got32 - want32).abs().max().item()
            check(torch.allclose(got32, want32, rtol=LM_TOL, atol=LM_TOL),
                  f"lm card vs cpu, {arch}: float32 products differ by "
                  f"{err32}")
            log(f"lm card vs cpu, {cfg.name}: float32 products, prefill + "
                f"{n} decode max_abs_err {err32:.4g} <= {LM_TOL}")


def start_dry_run(out: str) -> list:
    """The dry run's subprocesses, started at once (they take the host's
    CPU while the card runs the other phases): one per pair of
    ``DRYRUN_PAIRS``, the protocol, and the roofline prefill.  They see
    no card (``CUDA_VISIBLE_DEVICES`` empty)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", out]
    cmds = [cli + ["--arch", a, "--shape", s] for a, s in DRYRUN_PAIRS]
    cmds.append(cli + ["--protocol"])
    cmds.append([sys.executable, "-c", DRYRUN_ROOFLINE,
                 os.path.join(out, "roofline.json")])
    procs = [(cmd, subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    atexit.register(stop_dry_run, procs, out)
    return procs


def stop_dry_run(procs, out: str) -> None:
    """At exit, whatever failed before: no dry-run process left running,
    its output directory gone."""
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    shutil.rmtree(out, ignore_errors=True)


def phase_dry_run(procs, out: str) -> dict:
    """Every dry-run subprocess exits 0; every pair's roofline terms
    (compute, memory, collective) are finite and above 0, and so are
    the protocol's (memory and collective per round and per attempt,
    its round's calls equal to the ledger's sites).  Prints the terms
    as one JSON line and returns the roofline prefill's record."""
    for cmd, proc in procs:
        try:
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"dry run {cmd[3:]} passed "
                                 f"{DRYRUN_TIMEOUT_S} s")
        for line in text.splitlines()[-4:]:
            log(f"  dry run: {line}")
        check(proc.returncode == 0, f"dry run {cmd[3:]} exited "
              f"{proc.returncode}")
    terms = ("compute_s", "memory_s", "collective_s")
    pairs = {}
    for arch, shape in DRYRUN_PAIRS:
        with open(os.path.join(out, f"{arch}_{shape}_16x16.json")) as f:
            r = json.load(f)
        for t in terms:
            check(math.isfinite(r[t]) and r[t] > 0,
                  f"dry run {arch} {shape}: {t} = {r[t]}")
        pairs[f"{arch}/{shape}"] = {k: r[k] for k in (
            *terms, "dominant", "flops_per_dev", "bytes_per_dev",
            "largest_collective_bytes", "run_s")}
        pairs[f"{arch}/{shape}"]["count_by_op"] = r["collectives"][
            "count_by_op"]
    with open(os.path.join(out, "boosting-protocol_16x16.json")) as f:
        prot = json.load(f)
    for t in ("memory_s", "collective_s", "per_attempt_collective_s"):
        check(math.isfinite(prot[t]) and prot[t] > 0,
              f"protocol dry run: {t} = {prot[t]}")
    check(prot["calls_per_round"] == prot["ledger_sites_per_round"],
          f"protocol dry run: calls {prot['calls_per_round']} != ledger "
          f"{prot['ledger_sites_per_round']}")
    with open(os.path.join(out, "roofline.json")) as f:
        roof = json.load(f)
    check(math.isfinite(roof["compute_s"]) and roof["compute_s"] > 0,
          f"roofline dry run: compute_s {roof['compute_s']}")
    print(json.dumps({"dry_run": {
        "mesh": [16, 16], "constants": "H100 SXM data sheet (700 W)",
        "pairs": pairs, "protocol": {k: prot[k] for k in (
            "players", "rounds", "calls_per_round", "memory_s",
            "collective_s", "per_attempt_collective_s")}}}), flush=True)
    return roof


def phase_host_mesh(models, configs, prng, mesh_lib, sharding) -> dict:
    """``make_host_mesh()``: a (1, 1) mesh on the card over a 1-rank
    NCCL world, gone after the block.  deepseek-7b and
    granite-moe-3b-a800m at full width, depth cut to HOST_MESH_LAYERS
    (einsum attention, no kernel: the plain model's decode runs the
    decode attention's plain version, as a DTensor cache does), on
    DTensors placed by
    ``param_specs``, ``batch_partition`` and ``cache_partition``,
    against the plain model on the same parameters and tokens: the
    prefill's last-token logits and, for granite, HOST_MESH_DECODE
    decode steps (the MoE's one-hot dispatch and the cache's slot-mask
    write run on real values) within HOST_MESH_TOL.  On one device
    every other DTensor op is its local op.  Prints one JSON line."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    mcfg = configs.MeshConfig(data=1, model=1)
    B, S = 4, 256
    shape = configs.ShapeConfig("host", S, B, "prefill")
    dshape = configs.ShapeConfig("host", S, B, "decode")
    out = {"mesh": [1, 1], "device": "cuda", "layers": HOST_MESH_LAYERS,
           "batch": B, "prompt": S, "tol": HOST_MESH_TOL, "archs": {}}
    for arch, steps in (("deepseek-7b", 0),
                        ("granite-moe-3b-a800m", HOST_MESH_DECODE)):
        cfg = dataclasses.replace(configs.get_config(arch),
                                  num_layers=HOST_MESH_LAYERS)
        model = models.build(cfg)
        params = model.init(0, "cuda")
        tokens = prng.randint(prng.key(1, "cuda"), (B, S), 0,
                              cfg.vocab_size)
        prefill, decode = model.make_prefill_step(), model.make_decode_step()
        with torch.no_grad():
            plain, pcache = prefill(params, {"tokens": tokens})
        errs = {}
        with mesh_lib.make_host_mesh() as mesh, torch.no_grad(), \
                implicit_replication():
            check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
                  f"host mesh {mesh}")
            placed = sharding.distribute(
                params, sharding.param_specs(params, cfg, mcfg), mesh)
            parts = sharding.batch_partition(cfg, shape, mcfg)
            logits, cache = prefill(placed, sharding.distribute(
                {"tokens": tokens}, {"tokens": parts["tokens"]}, mesh))
            errs["prefill"] = (logits.full_tensor().float()
                               - plain.float()).abs().max().item()
            check(bool(torch.isfinite(logits.full_tensor()).all()),
                  f"host mesh {arch}: prefill logits not finite")
            cache = sharding.distribute(cache, sharding.cache_partition(
                cache, cfg, dshape, mcfg), mesh)
            tok = plain.argmax(-1).to(torch.int32)[:, None]
            for _ in range(steps):
                with plain_decode_attention():
                    plain, pcache = decode(params, pcache, tok)
                logits, cache = decode(placed, cache, sharding.distribute(
                    tok, sharding.P(mcfg.batch_axes, None), mesh))
                errs["decode"] = max(errs.get("decode", 0.0), (
                    logits.full_tensor().float()
                    - plain.float()).abs().max().item())
                tok = plain.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
        check(not dist.is_initialized(), "the host mesh left its world")
        for k, err in errs.items():
            check(err <= HOST_MESH_TOL, f"host mesh {arch} {k}: "
                  f"max_abs_err {err} > {HOST_MESH_TOL}")
        out["archs"][arch] = {"decode_steps": steps,
                              **{f"{k}_max_abs_err": v
                                 for k, v in errs.items()}}
        del params, placed, pcache, cache
        torch.cuda.empty_cache()
    print(json.dumps({"host_mesh": out}), flush=True)
    return out


def phase_roofline(roof: dict, card: str) -> dict:
    """The dry run's compute term for the LM slice's own prefill on one
    device against the slice's measured time of that prefill (the
    profiler's device time, else its profiled wall time): no card beats
    its roofline, so the ratio stays under 1.  Prints one JSON line."""
    dev_ms, wall_ms = PREFILL_MS["lm slice"]
    ms, source = ((dev_ms, "device") if dev_ms is not None
                  else (wall_ms, "wall (profiled)"))
    ratio = roof["compute_s"] * 1e3 / ms
    check(ratio < 1.0, f"roofline: the dry run's compute_s "
          f"{roof['compute_s']} is not under the measured {ms} ms")
    out = {"roofline": {"arch": "deepseek-7b", "batch": 4, "prompt": 2048,
                        "dry_run_compute_s": roof["compute_s"],
                        "flops": roof["flops_per_dev"],
                        "measured_prefill_ms": ms, "measured": source,
                        "ratio": ratio, "card": card}}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    argparse.ArgumentParser(description=__doc__).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch import configs, models
    from repro_torch.core import (approximation, batched, classify, finite,
                                  ledger, lower_bound, prng, semi_agnostic,
                                  sharded_batched, streaming, tasks, types,
                                  weak)
    from repro_torch.data import chunks
    from repro_torch.models import frontend, layers, transformer
    from repro_torch.optim import adamw
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.histogram import ref as hist_ref
    from repro_torch.kernels.mw_update import ops as mw_ops
    from repro_torch.kernels.stump import kernel as stump_kernel
    from repro_torch.kernels.stump import ops as stump_ops
    from repro_torch.launch import mesh as mesh_lib, serve, sharding, train
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import roundtrace
    from repro_torch.obs import trace as obs_trace

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"phase {name}: {time.perf_counter() - t0:.2f} s")
        return out

    # 0. the dry run's subprocesses, on the host's CPU beside the rest
    dry_dir = tempfile.mkdtemp(prefix="dryrun_")
    dry_procs = start_dry_run(dry_dir)
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
                                        flash_ops, flash_kernel, _build),
               "decode_attention": phase("decode attention",
                                         phase_decode_attention, decode_ops,
                                         decode_kernel)}
    entries["histogram"]["paths"]["chunked_roofline"] = phase(
        "chunked histogram", phase_chunked_histogram, hist_ops, hist_ref)
    # 4. the integer-track path at full size
    int_out, int_res, int_launches = phase("thresholds slice", phase_slice,
                                           serve, ledger, SLICE_ARGS,
                                           "thresholds slice")
    int_peak = torch.cuda.max_memory_allocated()
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
    # 5. the tree path at full size: this slice's main path, every
    # histogram launch on the kernel's "sort" route
    hist_ops.route_launches = dict.fromkeys(hist_ops.route_launches, 0)
    _, res, launches = phase("tree slice", phase_slice, serve, ledger,
                             TREE_ARGS, "tree slice")
    hist_routes = dict(hist_ops.route_launches)
    depth = int(TREE_ARGS[TREE_ARGS.index("--tree-depth") + 1])
    check(launches["histogram"] == depth * res.steps,
          f"histogram launches {launches['histogram']} != depth {depth} x "
          f"steps {res.steps}")
    check(hist_routes == {"sort": launches["histogram"], "tiled": 0,
                          "chunked": 0},
          f"tree slice: histogram routes {hist_routes}, not all "
          f"{launches['histogram']} on the sort route")
    log(f"tree slice: histogram routes {hist_routes}")
    entries["histogram"]["route_launches"] = hist_routes
    check(res.ok.any(), "no tree task finished")
    phase("tree profile", phase_profile, batched, serve, prng, tasks,
          TREE_ARGS, "tree", 5)
    # 6. LM serving at full width: this slice's main path
    lm_launches, lm_routes = phase(
        "lm slice", phase_lm_slice, serve, models, layers, transformer,
        adamw, obs_trace, LM_ARGS, "lm slice",
        {"num_layers": 30, "d_model": 4096})
    entries["flash_attention"]["route_launches"] = lm_routes
    # 6b. the MoE headline at full width and depth; the other families
    # at full width, depth cut
    moe_launches, moe_routes = phase(
        "lm moe slice", phase_lm_slice, serve, models, layers, transformer,
        adamw, obs_trace, LM_MOE_ARGS, "lm moe slice",
        {"num_layers": 32, "d_model": 1536, "num_experts": 40,
         "experts_per_token": 8, "expert_d_ff": 512})
    entries["flash_attention"]["paths"]["lm_moe"]["route_launches"] = \
        moe_routes
    family_launches = phase("lm families", phase_lm_families, serve,
                            configs, transformer, adamw)
    # 7. the scenario path at full size: this slice's main path, then
    # the infrastructure fault at a cut depth
    _, _, scen_launches = phase("scenario slice", phase_scenario, serve,
                                SCEN_ARGS, "scenario slice")
    phase("scenario profile", phase_profile, batched, serve, prng, tasks,
          SCEN_ARGS, "scenario (stumps)", 3)
    drop_out, drop_res, drop_launches = phase(
        "dropout run", phase_scenario, serve, DROP_ARGS, "dropout run")
    # 8. the sharded engine over its 1-rank NCCL group, each path held
    # to the batched engine's run of the same argv; the host loop
    shard_out, _, shard_launches = phase(
        "sharded thresholds slice", phase_sharded, serve, ledger,
        SLICE_ARGS, "sharded thresholds slice", int_res)
    check(shard_out["ok"] == 16, f"sharded thresholds slice: ok "
          f"{shard_out['ok']} of 16")
    _, tree14_res, tree14_launches = phase(
        "tree run, histogram mode", phase_slice, serve, ledger,
        SHARD_TREE_ARGS, "tree run (histogram mode, batched)")
    hist_ops.route_launches = dict.fromkeys(hist_ops.route_launches, 0)
    _, stree_res, stree_launches = phase(
        "sharded tree run, histogram mode", phase_sharded, serve, ledger,
        SHARD_TREE_ARGS, "sharded tree run", tree14_res)
    stree_routes = dict(hist_ops.route_launches)
    check(stree_launches["histogram"] == depth * stree_res.steps
          and stree_launches == tree14_launches,
          f"sharded tree run: launches {stree_launches}, batched "
          f"{tree14_launches}, steps {stree_res.steps}")
    log(f"sharded tree run: histogram routes {stree_routes}")
    entries["histogram"]["paths"]["sharded_tree"] = {
        "route_launches": stree_routes}
    sdrop_out, sdrop_res, sdrop_launches = phase(
        "sharded dropout run", phase_scenario, serve, DROP_ARGS + SHARD,
        "sharded dropout run")
    check_sharded(sdrop_out, sdrop_res, ledger,
                  serve.make_class(serve.build_parser().parse_args(
                      DROP_ARGS)), "sharded dropout run")
    assert_same_protocol(drop_res, sdrop_res, "sharded dropout run")
    for key in ("survivors", "guarantee_ok_survivors", "bits_max"):
        check(sdrop_out[key] == drop_out[key], f"sharded dropout run: "
              f"{key} {sdrop_out[key]} != batched {drop_out[key]}")
    log(f"sharded dropout run: equal to the batched run, "
        f"guarantee_ok_survivors {sdrop_out['guarantee_ok_survivors']} of "
        f"{sdrop_out['ok']}")
    host_launches = phase("host loop", phase_host_loop, serve, classify,
                          prng, SLICE_ARGS, int_res)
    # 9. the streaming tier: the thresholds slice sorted in tiles on both
    # engines, each equal to the monolithic batched run; the tree run
    # with chunked histograms; the sketch build through the pinned feed
    chunk_out, chunk_res, chunk_launches = phase(
        "chunked thresholds slice", phase_slice, serve, ledger, CHUNK_ARGS,
        "chunked thresholds slice")
    chunk_peak = torch.cuda.max_memory_allocated()
    check(chunk_res.steps == int_res.steps, f"chunked thresholds slice: "
          f"{chunk_res.steps} steps, monolithic {int_res.steps}")
    assert_same_protocol(int_res, chunk_res, "chunked thresholds slice")
    log(f"chunked thresholds slice: every protocol output and ledger equal "
        f"to the monolithic run; ms/step "
        f"{chunk_out['wall_s'] * 1e3 / chunk_res.steps:.2f} (monolithic "
        f"{int_out['wall_s'] * 1e3 / int_res.steps:.2f}), peak "
        f"{chunk_peak} bytes (monolithic {int_peak})")
    _, _, schunk_launches = phase(
        "sharded chunked thresholds slice", phase_sharded, serve, ledger,
        CHUNK_ARGS, "sharded chunked thresholds slice", int_res)
    ctree_launches, ctree_routes = phase(
        "chunked tree run", phase_chunked_tree, serve, ledger, batched, prng,
        tasks, weak, hist_ops, depth)
    entries["histogram"]["paths"]["chunked_tree"] = {
        "route_launches": ctree_routes}
    phase("sketch", phase_sketch, streaming, chunks, approximation)
    # 10. the scheduler: the stream, the same stream preempted to a
    # checkpoint and resumed, the sharded engine's stream with its
    # trace and metrics, a tree stream; the traced rounds
    stream_ref, stream_launches = phase("serve-stream", phase_serve_stream,
                                        serve)
    pre_launches = phase("preempted stream", phase_serve_stream_preempted,
                         serve, obs_trace, obs_metrics, stream_ref)
    sstream_launches = phase("sharded stream", phase_serve_stream_sharded,
                             serve)
    tstream_launches, tstream_routes = phase(
        "tree stream", phase_serve_stream_tree, serve, hist_ops, depth)
    entries["histogram"]["paths"]["serve_stream_tree"] = {
        "route_launches": tstream_routes}
    traced_launches = phase("traced rounds", phase_traced_rounds, serve,
                            batched, prng, tasks, roundtrace, obs_trace)
    # 11. card against CPU
    phase("card vs cpu", phase_card_vs_cpu, batched, prng, tasks, weak)
    phase("sharded card vs cpu", phase_sharded_card_vs_cpu,
          sharded_batched, prng, tasks, weak)
    phase("scenario card vs cpu", phase_scenario_card_vs_cpu, serve)
    phase("lm card vs cpu", phase_lm_card_vs_cpu, models, configs,
          flash_ops, transformer, frontend, prng, layers)
    # 12. training and the paper's side results
    train_launches = phase("train slice", phase_train, serve, train,
                           configs)
    phase("train card vs cpu", phase_train_card_vs_cpu, train)
    semi_launches = phase("semi-agnostic", phase_semi_agnostic, serve,
                          semi_agnostic, prng, tasks, weak, types)
    disj_launches = phase("lower bound", phase_lower_bound, serve,
                          lower_bound, types)
    finite_launches = phase("finite class", phase_finite, serve, finite,
                            weak)
    # 13. the launch tooling: the dry run's terms, DTensors on the host
    # mesh against the plain prefill, the roofline line
    roof = phase("dry run", phase_dry_run, dry_procs, dry_dir)
    phase("host mesh", phase_host_mesh, models, configs, prng, mesh_lib,
          sharding)
    phase("roofline", phase_roofline, roof, card)
    # 14. results: each kernel's top-level launches are its own main
    # path's (mw_update and histogram the tree path's, stump the
    # scenario path's, flash attention the LM path's), and every path's
    # launches sit in its own entry of ``paths``
    runs = {"thresholds": int_launches, "large_m": large_launches,
            "tree": launches,
            "scenario": scen_launches, "dropout": drop_launches,
            "lm": lm_launches, "sharded_thresholds": shard_launches,
            "tree_histogram_m14": tree14_launches,
            "sharded_tree": stree_launches,
            "sharded_dropout": sdrop_launches, "host_loop": host_launches,
            "chunked_thresholds": chunk_launches,
            "sharded_chunked_thresholds": schunk_launches,
            "chunked_tree": ctree_launches,
            "serve_stream": stream_launches,
            "serve_stream_preempted": pre_launches,
            "serve_stream_sharded": sstream_launches,
            "serve_stream_tree": tstream_launches,
            "traced_rounds": traced_launches, "train": train_launches,
            "semi_agnostic": semi_launches, "lower_bound": disj_launches,
            "finite": finite_launches, "lm_moe": moe_launches,
            **family_launches}
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
