"""Prefill serving: batches of prompts, each request done at its first
token.

Traffic parameters: ``batch`` prompts of ``prompt_len`` tokens a batch;
``interval_ms`` > 0 sends batch i at start + i · interval (an open
loop), 0 sends each batch when the one before has returned (a closed
loop).  A batch runs the model's ``make_prefill_step()`` (the step that
``serve --workload lm`` runs) and its greedy first tokens are copied to
the host; each request's time to first token runs from its batch's due
time to that copy.

``held_batches`` H: the K/V caches that the last H batches' prefills
returned stay on the device, as a prefill worker's K/V pool holds each
finished prompt until the decode side takes it over; a new batch's
caches push out the oldest.  Set-up fills the pool to its depth with
copies of a warm-up batch's caches and then runs one more warm-up
batch, so the window starts at its steady memory and allocates nothing
new; from the window's H-th batch on, the pool holds the window's own.
"""

from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from portbench import check, traffic
from portbench.devtrace import Capture

WARMUP_BATCHES = 2
TRACED_BATCHES = 3


def run(ctx):
    T = ctx.cell.traffic
    B, S, V = T["batch"], T["prompt_len"], ctx.config["vocab_size"]
    prefill = ctx.model.make_prefill_step()
    prompts = traffic.Prompts(ctx.seed, traffic.PROMPTS, B, S, V, ctx.device)
    warm = traffic.Prompts(ctx.seed, traffic.WARMUP, B, S, V, ctx.device)

    held = collections.deque(maxlen=T.get("held_batches", 0))

    def serve(tokens):
        logits, caches = prefill(ctx.params, {"tokens": tokens})
        held.append(caches)
        return logits, logits[:, :V].argmax(-1).cpu()

    serve(warm[0])
    while held and len(held) < held.maxlen:
        held.append([{k: v.clone() for k, v in c.items()} for c in held[0]])
    t = time.perf_counter()
    for i in range(1, WARMUP_BATCHES):
        serve(warm[i])
    warm_s = (time.perf_counter() - t) / (WARMUP_BATCHES - 1)
    interval = T.get("interval_ms", 0) / 1e3
    ahead = math.ceil(ctx.seconds / (interval or warm_s / 2)) + 1
    for i in range(ahead):
        prompts[i]                                   # drawn before the window
    # the logits every batch returns stay for the check, each copied into
    # a buffer made here: kept as they come, they would grow the
    # allocator's pool by a new segment every batch or two, a cudaMalloc
    # inside the window that stalls the host
    kept = torch.empty((ahead, B, ctx.cfg.padded_vocab), device=ctx.device)
    ctx.sync()

    outputs, ttft, service = [], [], []
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        i = len(outputs)
        due = start + i * interval if interval else time.perf_counter()
        if due >= end:
            break
        traffic.wait_until(due)
        issued = time.perf_counter()
        logits, first = serve(prompts[i])
        done = time.perf_counter()
        ttft.append(done - due)
        service.append(done - issued)
        if i < ahead:
            logits = kept[i].copy_(logits)
        outputs.append((logits, first))
    window_s = done - start
    n = len(outputs)

    trace = None
    if ctx.trace:
        with Capture() as cap:
            serve(prompts[0])                # the profiler's own first step
            with cap.window():
                for i in range(TRACED_BATCHES):
                    with cap.step():
                        serve(prompts[i])
        trace = cap.trace

    picked = traffic.sample(ctx.seed, n, ctx.cell.workload["check"]["batches"])
    requests = [check.Request(tokens=prompts[i], out_pos=[S - 1],
                              served=outputs[i][1][:, None],
                              logits=outputs[i][0][:, None],
                              prompt_len=S) for i in picked]
    per_request = np.repeat(np.asarray(ttft), B)
    return ctx.outcome(
        window_start=start, window_s=window_s,
        e2e={"ttft_p90_ms": float(np.percentile(per_request, 90) * 1e3),
             "tokens_per_s": B * S * n / window_s},
        stats={"batch": B, "length": S, "batches": n,
               "service_s": service, "ttft_s": ttft},
        attempted=B * n, failed=0, requests=requests, trace=trace)
