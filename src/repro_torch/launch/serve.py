"""Serving entry points of the port (counterpart of ``repro.launch.serve``).

* ``--workload lm`` (default) — prefill a batch of random prompts
  through the LM of ``--arch`` (any of the ten: dense, MoE, Mamba
  hybrid, xLSTM, the vision prefix, the encoder-decoder) and decode
  greedily.  It differs from the reference's ``run`` in one deliberate
  way: the model is ``build(cfg, use_flash=True)``, so a decoder's
  causal self-attention in the prefill goes through the flash kernel
  (the reference's ``run`` builds with ``use_flash=False`` and never
  reaches its Pallas kernel; the encoder-decoder takes no flash path
  in either).  ``--smoke`` (on by default, as in the reference) runs
  ``reduced(cfg)``; ``--no-smoke`` runs the configuration at full
  width and depth.
* ``--workload classify`` — a batch of AccuratelyClassify tasks through
  the port's batched engine or, with ``--engine sharded``, over a
  ``torch.distributed`` players group (core/sharded_batched.py: the
  world of a launcher that formed one, else one rank — NCCL on the
  card, gloo on the CPU), whose ledger is then held to the payloads
  its collectives moved.  ``--scenario`` picks an adversary
  (core/scenarios.py): a noise model (uniform, targeted_heavy,
  byzantine, boundary, drift), a planted tree concept (xor,
  checkerboard, bands; ``--cls tree``), or an infrastructure fault
  (dropout, flaky, rejoin) that silences ``--infra-player`` through the
  engine's player schedule.  Each finished task is then held to
  E_S(f) ≤ OPT — over the surviving shards under a fault — with OPT for
  all tasks from one call (one stump-kernel launch for ``--cls
  stumps``), after the timed run.  ``--chunk-size`` (a flag of the
  port, not of the reference's CLI) switches on the streaming tier:
  each shard is sorted in tiles merged by ranks
  (``BoostConfig.chunk_size``) and a tree class accumulates its
  histograms over tiles (the kernel's ``chunked`` route); the protocol
  outputs are those of the run without it.

Usage:
    python -m repro_torch.launch.serve --workload lm --arch deepseek-7b \\
        --no-smoke --batch 4 --prompt-len 2048 --gen 32
    python -m repro_torch.launch.serve --workload lm --device cpu
    python -m repro_torch.launch.serve --workload classify \\
        --batch 16 --m 1048576 --k 4 --noise 8 --domain 65536
    python -m repro_torch.launch.serve --workload classify --cls tree \\
        --features 8 --tree-depth 2 --tree-bins 32 --comm-mode coreset \\
        --batch 16 --m 65536 --k 4 --noise 8
    python -m repro_torch.launch.serve --workload classify --device cpu \\
        --cls stumps --batch 4 --m 512
    python -m repro_torch.launch.serve --workload classify --cls stumps \\
        --scenario boundary --noise 8 --batch 16 --m 65536 --features 8
    python -m repro_torch.launch.serve --workload classify --device cpu \\
        --cls stumps --scenario dropout --batch 4 --m 512
    python -m repro_torch.launch.serve --workload classify --engine sharded \\
        --batch 16 --m 1048576 --k 4 --noise 8 --domain 65536
    python -m repro_torch.launch.serve --workload classify \\
        --batch 16 --m 1048576 --k 4 --noise 8 --domain 65536 \\
        --chunk-size 16384
    python -m repro_torch.launch.serve --workload serve-stream \\
        --m 262144 --k 4 --noise 8 --domain 65536 --requests 48 \\
        --trace bursty --burst 8 --policy fill --scenario drift
    python -m repro_torch.launch.serve --workload serve-stream \\
        --device cpu --m 128 --k 2 --requests 16 --preempt 0:3 \\
        --ckpt-dir /tmp/ckpt --trace-out trace.json --metrics-out m.json

Each prints one JSON line with the reference's keys plus ``device`` and
``kernel_launches`` (the launches of each kernel the workload's path
can reach, in the timed run and the reports after it; 0 on the CPU,
where the plain versions run); ``lm`` adds ``flash``, ``classify``
adds ``steps`` and, with ``--scenario``, ``reports_s`` (the seconds the
reports took); ``serve-stream`` prints the reference's keys
(``dispatches``, ``steady_compiles`` — program builds after the warmup
—, per-bucket p50/p99, …); ``--engine sharded`` adds the reference's
``mesh_devices``, ``ledger_vs_payload`` and ``collective_bytes_max``,
and the port's ``backend`` (``nccl`` or ``gloo``) and
``collective_calls`` (the run's collectives by kind).  Prompt
tokens come from ``np.random.default_rng(seed)`` and classify keys
from ``split(key(seed), B)``, as in the reference.
Runs are timed once, after the kernel libraries are built, each timed
part ending in a device synchronise.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, models
from repro_torch.core import (batched, prng, scenarios, sharded_batched,
                              tasks, weak)
from repro_torch.core.pinned import pinned_argmax
from repro_torch.core.types import BoostConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.histogram import kernel as hist_kernel
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.mw_update import kernel as mw_kernel
from repro_torch.kernels.mw_update import ops as mw_ops
from repro_torch.kernels.stump import kernel as stump_kernel
from repro_torch.kernels.stump import ops as stump_ops
from repro_torch.models import frontend
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

# every kernel the engine can launch: name → (kernel module, ops module)
KERNELS = {"mw_update": (mw_kernel, mw_ops),
           "histogram": (hist_kernel, hist_ops),
           "stump": (stump_kernel, stump_ops),
           "flash_attention": (flash_kernel, flash_ops),
           "decode_attention": (decode_kernel, decode_ops)}
# the kernels each workload's path can launch, which its JSON reports
PATH_KERNELS = {"classify": ("mw_update", "histogram", "stump"),
                "serve-stream": ("mw_update", "histogram"),
                "lm": ("flash_attention", "decode_attention")}


def _build_kernels(dev: torch.device) -> None:
    """Build and load every kernel library outside the timed run."""
    if dev.type == "cuda":
        _build.build_all([k.SOURCE for k, _ in KERNELS.values()])
        for k, _ in KERNELS.values():
            k.library()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches(workload: str) -> dict:
    return {name: KERNELS[name][1].launches
            for name in PATH_KERNELS[workload]}


def run_lm(args, cfg=None):
    """Prefill B random prompts and decode ``--gen`` tokens greedily;
    returns (JSON dict, run) where ``run`` holds the model, params (the
    reference's for ``--seed``), the init's seconds and the device's
    peak memory after it (None on the CPU), the prefill batch (prompt
    tokens, and the stub frontend's ``prefix_embeds`` or ``frames``
    from ``key(1)``, as the reference's ``run`` draws them), the
    prefill's last-position logits, the generated tokens [B, gen + 1]
    (on the CPU) and the last decode logits.  ``cfg`` replaces the
    configuration ``--arch``/``--smoke`` name (a library caller's cut
    of depth)."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = configs.get_config(args.arch)
        if args.smoke:
            cfg = configs.reduced(cfg)
    model = models.build(cfg, use_flash=True)
    _build_kernels(dev)
    _sync(dev)
    t0 = time.perf_counter()
    params = model.init(args.seed, dev)
    _sync(dev)
    t_init = time.perf_counter() - t0
    init_peak = (torch.cuda.max_memory_allocated(dev)
                 if dev.type == "cuda" else None)
    rng = np.random.default_rng(args.seed)
    B, P = args.batch, args.prompt_len
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(B, P)),
                             dtype=torch.int32, device=dev)
    batch = {"tokens": tokens}
    if cfg.frontend == "vit_stub":
        batch["prefix_embeds"] = frontend.synth_embeds(
            prng.key(1, dev), cfg, B, cfg.frontend_tokens)
    if cfg.encoder_layers:
        batch["frames"] = frontend.synth_embeds(prng.key(1, dev), cfg, B, P)
    prefill = model.make_prefill_step()
    decode = model.make_decode_step()
    for _, ops in KERNELS.values():
        ops.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    prefill_logits, caches = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = pinned_argmax(prefill_logits, -1)[:, None].to(torch.int32)
    out_tokens = [tok]
    logits = prefill_logits
    t0 = time.perf_counter()
    for _ in range(args.gen):
        logits, caches = decode(params, caches, tok)
        tok = (pinned_argmax(logits, -1)[:, None]
               % cfg.vocab_size).to(torch.int32)
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen = torch.cat(out_tokens, dim=1).cpu()
    result = {
        "arch": cfg.name, "batch": B, "prompt_len": P,
        "generated": args.gen,
        "prefill_s": round(t_prefill, 3),
        "decode_s_per_token": round(t_decode / max(args.gen, 1), 4),
        "tokens_finite": bool((gen >= 0).all()),
        "sample": gen[0][:12].tolist(),
        "device": dev.type, "flash": model.use_flash,
        "kernel_launches": _launches("lm"),
    }
    run = SimpleNamespace(model=model, params=params, init_s=t_init,
                          init_peak_bytes=init_peak, tokens=tokens,
                          batch=batch,
                          prefill_logits=prefill_logits, generated=gen,
                          logits=logits)
    return result, run


def run_classify(args):
    """Run B tasks to completion; returns (JSON dict, result, tasks,
    reports), ``reports`` the per-task guarantee reports of the finished
    tasks under ``--scenario`` (None without one).

    The reports follow the timed run, as in the reference: every
    finished task's E_S(f) against OPT, over the surviving shards for an
    infrastructure adversary (``dropout``/``flaky``/``rejoin``: the
    tasks carry the usual ``--noise`` uniform flips and a player-alive
    schedule silences ``--infra-player``)."""
    # a launcher's NCCL world puts each rank on its own card
    dev = (sharded_batched.rank_device(args.device)
           if args.engine == "sharded" else resolve_device(args.device))
    cls = make_class(args)
    cfg = make_config(args, cls)
    B = args.batch
    infra = args.scenario if args.scenario in scenarios.INFRA else None
    noise_scenario = None if infra else args.scenario
    if noise_scenario in scenarios.FEATURE_SCENARIOS:
        _check_feature_scenario(noise_scenario, args)
    x, y, ts = tasks.make_batch(cls, B, args.m, args.k, args.noise,
                                seed0=args.seed, scenario=noise_scenario)
    player_sched = spec = None
    if infra:
        spec = scenarios.InfraSpec(
            name=infra, player=args.infra_player,
            drop_round=args.infra_round,
            rejoin_round=args.infra_round + args.infra_gap,
            miss_rate=args.infra_miss_rate)
        player_sched = spec.schedule(args.k, seed=args.seed)
    _build_kernels(dev)
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, device=dev)
    keys = prng.split(prng.key(args.seed, device=dev), B)
    with contextlib.ExitStack() as stack:
        if args.engine == "sharded":
            group = stack.enter_context(
                sharded_batched.make_players_group(args.k, dev))
            run = functools.partial(
                sharded_batched.run_accurately_classify_sharded,
                group=group)
        else:
            run = functools.partial(batched.run_accurately_classify_batched,
                                    device=dev)
        _sync(dev)
        for _, ops in KERNELS.values():
            ops.launches = 0
        t0 = time.perf_counter()
        res = run(xt, yt, keys, cfg, cls, player_sched=player_sched)
        _sync(dev)
        wall = time.perf_counter() - t0
    result = {
        "workload": "classify", "engine": args.engine, "batch": B,
        "m": args.m, "k": args.k, "class": args.cls,
        "noise": args.noise, "scenario": args.scenario or "uniform",
        "ok": int(res.ok.sum()), "attempts_max": int(res.attempts.max()),
        "wall_s": round(wall, 4),
        "tasks_per_s": round(B / max(wall, 1e-9), 2),
        "device": dev.type, "steps": res.steps,
    }
    reports = None
    t0 = time.perf_counter()
    if infra:
        reports = scenarios.infra_reports(ts, res, spec, seed=args.seed,
                                          device=dev)
        result["survivors"] = int(spec.survivors(
            args.k, seed=args.seed).sum())
        result["guarantee_ok_survivors"] = int(
            sum(r["guarantee_ok"] for r in reports))
        result["bits_max"] = max((r["bits"] for r in reports), default=0)
    elif args.scenario is not None:
        # the adversary decides how much it corrupts (byzantine flips a
        # whole shard regardless of --noise): report what was planted
        result["noise"] = max(int(t.noise_count) for t in ts)
        reports = scenarios.scenario_reports(ts, res, device=dev)
        result["guarantee_ok"] = int(sum(r["guarantee_ok"]
                                         for r in reports))
        result["recall_contradicted_min"] = round(
            min((r["recall_contradicted"] for r in reports),
                default=1.0), 3)
        result["bits_max"] = max((r["bits"] for r in reports), default=0)
    if reports is not None:
        _sync(dev)
        result["reports_s"] = round(time.perf_counter() - t0, 4)
    if args.engine == "sharded":
        ok = [b for b in range(B) if res.ok[b]]
        for b in ok:
            res.validate_ledger(b)
        result["mesh_devices"] = int(res.mesh_devices)
        result["ledger_vs_payload"] = (f"validated_{len(ok)}/{B}"
                                       if ok else "no_ok_lanes")
        result["collective_bytes_max"] = int(res.wire_bytes.max())
        result["backend"] = res.backend
        result["collective_calls"] = res.collective_calls
    result["kernel_launches"] = _launches("classify")
    return result, res, ts, reports


def _check_feature_scenario(name: str, args) -> None:
    """Up-front validation of a planted-concept scenario: needs the
    tree class at sufficient depth — fail at argument time, not deep
    inside task construction."""
    if args.cls != "tree":
        raise SystemExit(
            f"--scenario {name} plants a tree concept: run it "
            "with --cls tree (--tree-depth/--tree-bins)")
    need = scenarios.ScenarioSpec(name=name).min_tree_depth()
    if args.tree_depth < need:
        raise SystemExit(
            f"--scenario {name} needs --tree-depth ≥ {need} "
            f"(got {args.tree_depth})")
    if name in ("xor", "checkerboard") and args.features < 2:
        raise SystemExit(
            f"--scenario {name} crosses two features: needs "
            f"--features ≥ 2 (got {args.features})")


def _next_pow2(v: int) -> int:
    return 1 << max(v - 1, 1).bit_length()


def run_serve_stream(args):
    """Replay a mixed-shape request stream through the scheduler (the
    reference's ``run_serve_stream``: the same checks, shape mix,
    lattice and JSON keys, plus ``device`` and ``kernel_launches``, the
    launches of the stream's run after the warmup).

    ``--preempt D:R`` (repeatable) cuts the D-th dispatch after R wire
    rounds, checkpoints its engine state to ``--ckpt-dir`` and requeues
    the batch; its completions are still those of ``one_shot``.
    Returns (JSON dict, completions, scheduler); the caller closes the
    scheduler (it holds the sharded engine's players groups)."""
    from repro_torch.launch import scheduler as S

    if args.m % (2 * args.k):
        raise SystemExit(
            f"--m {args.m} must be a multiple of 2*k={2 * args.k}: the "
            "serve-stream shape mix includes m/2, and every shape's k "
            "shards must be equal-sized")
    if args.scenario in scenarios.INFRA:
        raise SystemExit(
            f"--scenario {args.scenario} is an infrastructure adversary "
            "— use --workload classify for player schedules, or "
            "--preempt for serve-stream fault injection")
    if getattr(args, "chunk_size", None) is not None:
        raise SystemExit("--chunk-size is a flag of --workload classify")
    n = args.requests
    shapes = [
        {"m": args.m // 2, "noise": 0},
        {"m": args.m, "noise": args.noise},
        {"m": args.m * 2, "noise": args.noise,
         "scenario": args.scenario},
    ]
    preempt = {}
    for spec in args.preempt or []:
        d, r = spec.split(":")
        preempt[int(d)] = int(r)
    if args.trace == "bursty":
        arrivals = S.bursty_trace(n, rate_per_s=args.rate,
                                  burst=args.burst, seed=args.seed)
    else:
        arrivals = S.poisson_trace(n, rate_per_s=args.rate,
                                   seed=args.seed)
    if args.scenario in scenarios.FEATURE_SCENARIOS:
        _check_feature_scenario(args.scenario, args)
    reqs = S.make_request_stream(
        n, arrivals, shapes, seed0=args.seed, k=args.k,
        clsname=args.cls, domain=args.domain,
        num_features=args.features,
        tree_depth=args.tree_depth, tree_bins=args.tree_bins,
        tree_comm_mode=args.comm_mode, tree_vote_topk=args.vote_topk,
        coreset_size=args.coreset, opt_budget=args.opt_budget,
        engine=args.engine)
    # one lattice point per distinct shape: the next power of two over
    # each shape's per-player mloc (deduped, so nearby shapes share)
    lattice = S.BucketLattice(
        b_sizes=(1, 4, 8),
        mloc_sizes=tuple(sorted({_next_pow2(s["m"] // args.k)
                                 for s in shapes})))
    dev = (sharded_batched.rank_device(args.device)
           if args.engine == "sharded" else resolve_device(args.device))
    _build_kernels(dev)
    sched = S.BoostScheduler(lattice=lattice, policy=args.policy,
                             fill_wait_s=args.fill_wait,
                             ckpt_dir=args.ckpt_dir if preempt else None,
                             preempt=preempt, device=dev)
    try:
        if args.warmup:
            sched.warm(reqs)            # build every reachable bucket
        warm = dataclasses.replace(sched.cache.stats)
        for _, ops in KERNELS.values():
            ops.launches = 0
        done = sched.run_stream(reqs)
        launches = _launches("serve-stream")
        reg = obs_metrics.default_registry()
        obs_metrics.publish_cache_stats(sched.cache.stats, reg)
        obs_metrics.publish_scheduler_stats(sched.stats, reg)
        result = {
            "workload": "serve-stream", "engine": args.engine,
            "trace": args.trace, "policy": args.policy,
            "requests": n, "dispatches": sched.stats.dispatches,
            "padded_requests": sched.stats.padded_requests,
            "filler_lanes": sched.stats.filler_lanes,
            "preemptions": sched.stats.preemptions,
            "resumes": sched.stats.resumes,
            "cache_hits": sched.cache.stats.hits,
            "cache_compiles": sched.cache.stats.compiles,
            "steady_compiles": sched.cache.stats.compiles - warm.compiles,
            "ok": sum(c.ok for c in done),
            **S.latency_summary(done),
        }
        if args.engine == "sharded":
            result["ledger_validated"] = sum(
                bool(c.validate_ledger()) for c in done if c.ok)
        result["device"] = dev.type
        result["kernel_launches"] = launches
    except BaseException:
        sched.close()
        raise
    return result, done, sched


def make_class(args):
    """The hypothesis class the CLI flags name (the reference's); a
    tree class takes ``--chunk-size`` for its histograms."""
    cls = weak.make_class(args.cls, n=args.domain,
                          num_features=args.features,
                          tree_depth=args.tree_depth,
                          tree_bins=args.tree_bins,
                          tree_comm_mode=args.comm_mode,
                          tree_vote_topk=args.vote_topk)
    chunk = getattr(args, "chunk_size", None)
    if chunk is not None and args.cls == "tree":
        cls = dataclasses.replace(cls, chunk_size=chunk)
    return cls


def make_config(args, cls) -> BoostConfig:
    """The protocol configuration of the CLI flags: the randomized
    coreset for the feature-track classes, as in the reference."""
    return BoostConfig(k=args.k, coreset_size=args.coreset,
                       domain_size=args.domain, opt_budget=args.opt_budget,
                       deterministic_coreset=not weak.needs_features(cls),
                       chunk_size=getattr(args, "chunk_size", None))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="lm",
                    choices=["lm", "classify", "serve-stream"])
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="--workload lm: run reduced(arch); --no-smoke "
                         "runs it at full width and depth")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
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
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="the streaming tier: sort each shard in tiles "
                         "of this many points (BoostConfig.chunk_size) "
                         "and, for --cls tree, accumulate every histogram "
                         "over tiles of this many points; the same "
                         "protocol outputs")
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "sharded"])
    ap.add_argument("--scenario", default=None,
                    choices=[None, "clean", "uniform", "targeted_heavy",
                             "byzantine", "boundary", "drift",
                             "xor", "checkerboard", "bands",
                             "dropout", "flaky", "rejoin"])
    # infrastructure adversaries (--scenario dropout/flaky/rejoin)
    ap.add_argument("--infra-player", type=int, default=1,
                    help="player the infra adversary silences")
    ap.add_argument("--infra-round", type=int, default=5,
                    help="wire round the player first goes absent")
    ap.add_argument("--infra-gap", type=int, default=8,
                    help="rejoin: rounds absent before returning")
    ap.add_argument("--infra-miss-rate", type=float, default=0.3,
                    help="flaky: per-round absence probability")
    # serve-stream workload
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--trace", default="poisson",
                    choices=["poisson", "bursty"])
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--burst", type=int, default=8)
    ap.add_argument("--policy", default="pack",
                    choices=["pack", "fill"])
    ap.add_argument("--fill-wait", type=float, default=0.05)
    ap.add_argument("--warmup", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--preempt", action="append", metavar="D:R",
                    help="preempt dispatch D after R wire rounds "
                         "(repeatable); state checkpoints to --ckpt-dir")
    ap.add_argument("--ckpt-dir", default="experiments/preempt_ckpt")
    # observability (repro_torch/obs): host-span tracing + metrics
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record host protocol spans and write a "
                         "Chrome/Perfetto trace JSON here (load it at "
                         "https://ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry (scheduler/cache "
                         "counters, ckpt timing histograms) as JSON")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def run_workload(args) -> dict:
    """Run ``args.workload`` under ``--trace-out``/``--metrics-out`` and
    return its JSON dict; the trace and the metrics are written even
    when the run raises."""
    rec = obs_trace.enable() if args.trace_out else None
    try:
        if args.workload == "serve-stream":
            out, _, sched = run_serve_stream(args)
            sched.close()
            return out
        run = run_lm if args.workload == "lm" else run_classify
        return run(args)[0]
    finally:
        if rec is not None:
            obs_trace.disable()
            rec.save(args.trace_out)
        if args.metrics_out:
            obs_metrics.default_registry().save(args.metrics_out)


def main():
    args = build_parser().parse_args()
    out = run_workload(args)
    # in a world its launcher formed (torchrun), rank 0 reports
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
