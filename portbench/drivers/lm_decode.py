"""Decode serving: a full batch of sequences decoded greedily, one token
each a step, every step's tokens copied to the host.

Traffic parameters: ``sequences`` prompts of ``prompt_len`` tokens,
prefilled during set-up ``prefill_chunk`` at a time through the model's
``make_prefill_step()`` into one cache of ``cache_capacity`` slots a
sequence (``Model.init_serve_cache``); the window then drives
``make_decode_step()``.  After ``round_tokens`` steps every sequence
starts a new request on the same prompt: the cache's length is set
back to ``prompt_len`` (its slots past the prompt are no longer live)
and the request's first input is a fresh token drawn from the seed.
So no slot wraps, and each step does the same work whatever the
window's length.  A closed loop: the batch is always full.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, traffic, weights
from portbench.devtrace import Capture
from repro_torch.configs.base import ShapeConfig

WARMUP_STEPS = 3
TRACED_STEPS = 8


def run(ctx):
    T = ctx.cell.traffic
    B, P, C, R = (T["sequences"], T["prompt_len"], T["cache_capacity"],
                  T["round_tokens"])
    if P + R > C:
        raise ValueError(f"prompt_len + round_tokens = {P + R} exceeds the "
                         f"cache's {C} slots")
    V, dev = ctx.config["vocab_size"], ctx.device
    model, params = ctx.model, ctx.params
    prefill, decode = model.make_prefill_step(), model.make_decode_step()
    prompts = traffic.Prompts(ctx.seed, traffic.PROMPTS, B, P, V, dev)[0]
    fresh = weights.generator(ctx.seed, traffic.FRESH, dev)
    picked = traffic.sample(ctx.seed, B, ctx.cell.workload["check"]["sequences"])
    rows = torch.tensor(picked, device=dev)

    caches = model.init_serve_cache(ShapeConfig("portbench", C, B, "decode"),
                                    filled=False, device=dev)
    first = torch.empty(B, dtype=torch.int32, device=dev)
    first_logits = torch.empty(len(picked), ctx.cfg.padded_vocab, device=dev)
    step = T["prefill_chunk"]
    for a in range(0, B, step):
        logits, chunk = prefill(params, {"tokens": prompts[a:a + step]})
        for cache, c in zip(caches, chunk):
            cache["k"][a:a + step, :P] = c["k"]
            cache["v"][a:a + step, :P] = c["v"]
        del chunk
        first[a:a + step] = logits[:, :V].argmax(-1).to(torch.int32)
        for j, r in enumerate(picked):
            if a <= r < a + step:
                first_logits[j] = logits[r - a]

    def restart():
        for cache in caches:
            cache["len"] = torch.full((B,), P, dtype=torch.int32, device=dev)

    def one_step(tok):
        nonlocal caches
        logits, caches = decode(params, caches, tok[:, None])
        nxt = logits[:, :V].argmax(-1).to(torch.int32)
        return logits, nxt, nxt.cpu()

    restart()
    tok = first
    for _ in range(WARMUP_STEPS):
        tok = one_step(tok)[1]
    restart()
    ctx.sync()

    # rounds[r] = (input tokens [B] at position P, per-step host tokens,
    # per-step logits of the checked rows)
    rounds = [(first, [], [])]
    tok, gaps = first, []
    start = time.perf_counter()
    end, last = start + ctx.seconds, start
    while last < end:
        if len(rounds[-1][1]) == R:
            restart()
            tok = torch.randint(0, V, (B,), generator=fresh, device=dev,
                                dtype=torch.int32)
            rounds.append((tok, [], []))
        logits, tok, host = one_step(tok)
        now = time.perf_counter()
        gaps.append(now - last)
        last = now
        rounds[-1][1].append(host)
        rounds[-1][2].append(logits[rows])
    window_s = last - start
    steps = len(gaps)
    lives = [P + i for _, out, _ in rounds for i in range(len(out))]

    trace = None
    if ctx.trace:
        restart()
        tok = first
        with Capture() as cap:
            tok = one_step(tok)[1]
            with cap.window():
                for _ in range(TRACED_STEPS):
                    with cap.step():
                        tok = one_step(tok)[1]
        trace = cap.trace
    del caches

    # an MoE routes a prompt's tokens with capacity over the chunk that
    # was prefilled with it, so its reference runs over that chunk
    together = step if ctx.config.get("num_experts") else 1
    requests = []
    for r, (inp, out, logs) in enumerate(rounds):
        served = torch.stack(out, 1)                       # [B, n] host
        n = served.shape[1]
        feed = torch.cat([inp.cpu()[:, None], served[:, :-1]], 1)
        inputs = torch.cat([prompts.cpu(), feed], 1)
        for j, s in enumerate(picked):
            a = s - s % together
            prog = torch.stack([x[j] for x in logs])
            pos = list(range(P, P + n))
            got = served[s]
            if r == 0:                                     # the prefill's token
                pos = [P - 1] + pos
                got = torch.cat([first[s:s + 1].cpu(), got])
                prog = torch.cat([first_logits[j:j + 1], prog])
            requests.append(check.Request(
                tokens=inputs[a:a + together].to(dev), out_pos=pos,
                served=got[None], logits=prog[None], prompt_len=P,
                rows=[s - a]))
    return ctx.outcome(
        window_start=start, window_s=window_s,
        e2e={"tokens_per_s": B * steps / window_s,
             "itl_p95_ms": float(np.percentile(gaps, 95) * 1e3)},
        stats={"batch": B, "steps": steps, "step_s": gaps,
               "live_mean": float(np.mean(lives))},
        attempted=B * steps, failed=0, requests=requests, trace=trace)
