"""Continuous-batching task server for heterogeneous boosting requests
(counterpart of ``repro.launch.scheduler``).

The one-shot entry point (``launch/serve.py --workload classify``) runs one
homogeneous batch per process.  This module serves a *stream* of mixed
requests through the port's engines:

* **Shape bucketing.**  Requests are padded up to a small lattice of
  canonical (B, mloc) buckets — per-player shards pad to the next
  lattice ``mloc`` with dead rows (``tasks.pad_shards``), short batches
  fill lanes with copies of a live lane (``batched.stack_for_dispatch``).
  Engine statics (k, BoostConfig, hypothesis class, engine kind)
  partition requests into compat groups; noise level and scenario are
  data, so one batch mixes adversaries.

* **Program cache.**  Each bucket's program is built once
  (``batched.lower_classify`` / ``sharded_batched.lower_classify_sharded``:
  the engine bound to the bucket's signature, its per-shape work done)
  and held in an LRU cache keyed on (compat, B, mloc).  Steady-state
  traffic hits the cache — no builds, counted in ``CacheStats`` (a
  "compile" is a program build).  Eviction drops the program; a
  re-admission builds it again.

* **Continuous admission.**  A virtual clock replays an arrival trace
  (``poisson_trace``/``bursty_trace``); while a batch is in flight new
  arrivals queue, and when the dispatch returns the freed slots are
  refilled — batching at dispatch granularity.  ``pack`` dispatches as
  soon as anything is queued (the smallest bucket B that covers the
  queue); ``fill`` holds admission until a full max-B batch is ready or
  ``fill_wait_s`` has passed for the oldest request.

* **Preemption, checkpoint and resume.**  The engines step round by
  round (``init_state / run_rounds / finalize``), so a dispatch can be
  cut after N wire rounds, its protocol state checkpointed
  (``ckpt/msgpack_ckpt``: one writer thread takes the host copies the
  loop hands it; a re-preempted batch re-checkpoints incrementally,
  chained to its previous snapshot) and the batch requeued; the resume
  restores template-free from the manifest onto the scheduler's device
  and runs the remaining rounds.  ``preempt={dispatch: rounds}`` injects
  the cuts (a resume consumes a dispatch seq too, so an entry can cut a
  resume again); the chain is deleted once the batch completes.

Every completion equals the one-shot engine run of the same padded
request (``BoostScheduler.one_shot``: B = 1, the same bucket mloc, the
same key) bit for bit — a lane's result depends on its own shape only —
and sharded completions carry ``validate_ledger``-checkable wire
counters.  The sharded engine's players group (one NCCL rank on the
card, gloo on the CPU) is made once per k and held for the scheduler's
lifetime: :meth:`BoostScheduler.close`, or the ``with`` form, releases
it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.ckpt import msgpack_ckpt
from repro_torch.core import (batched, prng, scenarios, sharded_batched,
                              tasks, weak)
from repro_torch.core.types import BoostConfig
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace


# ---------------------------------------------------------------------------
# Requests and their generated payloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    """One boosting task as a serving request (hashable, self-seeded)."""

    rid: int
    m: int = 256                 # total sample size (k must divide it)
    k: int = 4
    noise: int = 0
    clsname: str = "thresholds"
    domain: int = 1 << 12
    num_features: int = 8
    tree_depth: int = 2          # clsname == "tree": depth / bin grid
    tree_bins: int = 32
    tree_comm_mode: str = "coreset"  # coreset | histogram | voting
    tree_vote_topk: int = 2
    coreset_size: int = 100
    opt_budget: int = 16
    scenario: str | None = None  # core/scenarios.py adversary, or uniform
    engine: str = "batched"      # "batched" | "sharded"
    seed: int = 0
    arrival_s: float = 0.0

    def make_cls(self):
        return weak.make_class(self.clsname, n=self.domain,
                               num_features=self.num_features,
                               tree_depth=self.tree_depth,
                               tree_bins=self.tree_bins,
                               tree_comm_mode=self.tree_comm_mode,
                               tree_vote_topk=self.tree_vote_topk)

    def make_cfg(self) -> BoostConfig:
        # feature-row classes (stumps, trees) use the randomized
        # coreset — a capability of the class, not a name special-case
        return BoostConfig(
            k=self.k, coreset_size=self.coreset_size,
            domain_size=self.domain, opt_budget=self.opt_budget,
            deterministic_coreset=not weak.needs_features(
                self.make_cls()))

    def make_task(self) -> tasks.Task:
        if self.scenario is not None:
            return scenarios.make_scenario_task(
                self.make_cls(), m=self.m, k=self.k,
                spec=scenarios.ScenarioSpec(name=self.scenario,
                                            noise=self.noise),
                seed=self.seed)
        return tasks.make_task(self.make_cls(), m=self.m, k=self.k,
                               noise=self.noise, seed=self.seed)

    def make_key(self) -> torch.Tensor:
        """The task key, ``jax.random.key(seed)``'s words [2] (CPU)."""
        return prng.key(self.seed)


@dataclasses.dataclass(frozen=True)
class CompatKey:
    """Engine statics — requests in one dispatch must share these."""

    engine: str
    cfg: BoostConfig
    cls: object

    @classmethod
    def of(cls_, req: Request) -> "CompatKey":
        return cls_(engine=req.engine, cfg=req.make_cfg(),
                    cls=req.make_cls())


@dataclasses.dataclass(frozen=True)
class BucketKey:
    compat: CompatKey
    B: int
    mloc: int


# ---------------------------------------------------------------------------
# The bucket lattice
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketLattice:
    """Canonical (B, mloc) grid requests are padded up to.

    Small on purpose: each lattice point is one compiled program, and
    steady-state traffic should touch a handful.  ``mloc`` rounds up to
    the next lattice value (never down — padding is dead rows, not
    truncation); ``B`` is chosen per dispatch by the admission policy.
    """

    b_sizes: tuple = (1, 4, 8)
    mloc_sizes: tuple = (64, 128, 256)

    def bucket_mloc(self, mloc: int) -> int:
        for s in self.mloc_sizes:
            if mloc <= s:
                return s
        raise ValueError(
            f"mloc={mloc} exceeds lattice {self.mloc_sizes!r}")

    def bucket_b(self, queued: int) -> int:
        for s in self.b_sizes:
            if queued <= s:
                return s
        return self.b_sizes[-1]

    @property
    def max_b(self) -> int:
        return self.b_sizes[-1]


# ---------------------------------------------------------------------------
# The compile cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    compiles: int = 0            # == misses; kept separate so tests can
    compile_s: float = 0.0       # assert "recompiled exactly once"


class CompileCache:
    """LRU of bucket programs.

    Keyed on :class:`BucketKey`; the values are the programs
    ``build()`` returns, owned by this cache — evicting one drops it,
    and the next admission of that bucket builds it again (tests assert
    exactly once).  ``capacity=None`` means unbounded (the lattice
    already bounds the population).
    """

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity
        self.stats = CacheStats()
        self._entries: "collections.OrderedDict" = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: BucketKey, build: Callable[[], object]):
        if key in self._entries:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return self._entries[key]
        t0 = time.perf_counter()
        with obs_trace.span("compile", "compile", scope="scheduler",
                            B=key.B, mloc=key.mloc,
                            engine=getattr(key.compat, "engine",
                                           str(key.compat))):
            compiled = build()
        self.stats.compile_s += time.perf_counter() - t0
        self.stats.misses += 1
        self.stats.compiles += 1
        self._entries[key] = compiled
        if self.capacity is not None and len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return compiled


# ---------------------------------------------------------------------------
# Completions + stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Completion:
    """One served request: its lane of a bucket dispatch."""

    request: Request
    task: tasks.Task
    result: batched.BatchedClassifyResult   # the whole dispatch
    lane: int
    bucket: BucketKey
    queue_wait_s: float          # arrival → dispatch start (virtual)
    service_s: float             # dispatch wall time (shared by lanes)
    latency_s: float             # arrival → completion (virtual)
    resumed: bool = False        # completed via checkpoint-resume

    @property
    def ok(self) -> bool:
        return bool(self.result.ok[self.lane])

    def per_task(self):
        return self.result.per_task(self.lane)

    def classifier(self):
        return self.result.classifier(self.lane)

    def validate_ledger(self) -> dict:
        """Theorem 4.1 accounting ≡ this completion's measured
        collective payloads (docs/ledger.md walks the checked fields);
        sharded dispatches only."""
        if not isinstance(self.result,
                          sharded_batched.ShardedClassifyResult):
            raise TypeError("wire validation needs the sharded engine")
        return self.result.validate_ledger(self.lane)


@dataclasses.dataclass
class SchedulerStats:
    dispatches: int = 0
    served: int = 0
    filler_lanes: int = 0
    padded_requests: int = 0
    preemptions: int = 0
    resumes: int = 0
    # (B, mloc, engine) -> (served real lanes, dispatched lane capacity)
    # — capacity accumulates B per dispatch, so served/capacity is the
    # bucket's lane occupancy (obs.metrics.publish_scheduler_stats
    # exports all three as gauges)
    per_bucket: dict = dataclasses.field(default_factory=dict)

    def note(self, bucket: BucketKey, n_real: int, B: int):
        self.dispatches += 1
        self.served += n_real
        self.filler_lanes += B - n_real
        key = (bucket.B, bucket.mloc, bucket.compat.engine)
        served, capacity = self.per_bucket.get(key, (0, 0))
        self.per_bucket[key] = (served + n_real, capacity + B)


@dataclasses.dataclass
class _Suspended:
    """A preempted in-flight batch, requeued for resume.

    The protocol state lives in the msgpack checkpoint chain (the tip
    is ``ckpt_path``; ``paths`` holds every file of the chain for
    cleanup); the static inputs (the stacked sample arrays and keys —
    regenerable from the requests, kept here to avoid rebuilding) ride
    along."""

    bucket: BucketKey
    admitted: list               # the (req, task, data) tuples
    payload: tuple               # stacked (x, y, alive, keys), host
    m_true: np.ndarray
    ckpt_path: str               # chain tip — what a resume restores
    rounds_done: int
    chain: str = ""              # writer chain id (incremental diffing)
    paths: tuple = ()            # every file of the chain, for cleanup


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def latency_summary(completions) -> dict:
    """tasks/sec + p50/p99 latency, overall and per bucket."""
    if not completions:
        return {"served": 0}
    lats = [c.latency_s for c in completions]
    span = max(c.latency_s + c.request.arrival_s for c in completions)
    out = {
        "served": len(completions),
        "tasks_per_s": round(len(completions) / max(span, 1e-9), 2),
        "p50_latency_s": round(_percentile(lats, 50), 4),
        "p99_latency_s": round(_percentile(lats, 99), 4),
        "buckets": {},
    }
    by_bucket = collections.defaultdict(list)
    for c in completions:
        by_bucket[(c.bucket.B, c.bucket.mloc,
                   c.bucket.compat.engine)].append(c.latency_s)
    for bk, ls in sorted(by_bucket.items()):
        out["buckets"][f"B{bk[0]}_mloc{bk[1]}_{bk[2]}"] = {
            "served": len(ls),
            "p50_latency_s": round(_percentile(ls, 50), 4),
            "p99_latency_s": round(_percentile(ls, 99), 4),
        }
    return out


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------

class BoostScheduler:
    """Continuous-batching server over the batched/sharded engines.

    ``run_stream`` replays an arrival-stamped request list against a
    virtual clock: compute time is measured wall time (each dispatch
    ends with its result on the host), arrival time is the trace's.
    ``submit``/``step`` expose the same machinery for open-loop
    driving.  Engines run on ``device`` (default ``cuda``).
    """

    def __init__(self, lattice: BucketLattice | None = None,
                 policy: str = "pack", fill_wait_s: float = 0.05,
                 cache_capacity: int | None = None,
                 cache: CompileCache | None = None,
                 ckpt_dir: str | None = None,
                 preempt: dict | None = None, device=None):
        if policy not in ("pack", "fill"):
            raise ValueError(f"unknown policy {policy!r}")
        self.lattice = lattice or BucketLattice()
        self.policy = policy
        self.fill_wait_s = fill_wait_s
        # ``cache`` lets several schedulers (e.g. a policy comparison)
        # share one pool of programs
        if cache is not None and cache_capacity is not None:
            raise ValueError(
                "pass either cache= (shared, already sized) or "
                "cache_capacity=, not both")
        self.cache = cache or CompileCache(capacity=cache_capacity)
        # fault injection: {dispatch_seq: wire_rounds} — the seq-th
        # engine dispatch is preempted after that many rounds, its
        # state checkpointed to ckpt_dir and the batch requeued.  A
        # RESUME consumes a dispatch seq too, so injecting on it
        # preempts the same batch again — the re-checkpoint is then an
        # incremental snapshot chained to the previous one.
        self.preempt = dict(preempt or {})
        self.ckpt_dir = ckpt_dir
        if self.preempt and not self.ckpt_dir:
            raise ValueError("preempt= injection needs ckpt_dir= (the "
                             "checkpointed state has to land somewhere)")
        self.device = resolve_device(device)
        self.stats = SchedulerStats()
        self._queues: dict = collections.defaultdict(collections.deque)
        self._suspended: collections.deque = collections.deque()
        self._dispatch_seq = 0
        self._groups: dict = {}
        self._owned = contextlib.ExitStack()
        self._writer: msgpack_ckpt.AsyncCheckpointer | None = None

    # -- lifetime ----------------------------------------------------------

    def close(self) -> None:
        """Flush and stop the checkpoint writer and release the players
        groups (the last one made is released first)."""
        try:
            if self._writer is not None:
                writer, self._writer = self._writer, None
                writer.close()
        finally:
            self._groups.clear()
            self._owned.close()

    def __enter__(self) -> "BoostScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request):
        """Generate the request's task data, pad it to its bucket mloc
        and enqueue it.  Queues are per (compat, bucket-mloc): a padded
        request's PRNG stream depends on its padded shape (the
        randomized coreset draws per row), so re-padding at admission
        would break bit-parity with the one-shot baseline — each
        request is padded exactly once, here."""
        if req.m % req.k:
            raise ValueError(f"k={req.k} must divide m={req.m}")
        task = req.make_task()
        mloc_b = self.lattice.bucket_mloc(req.m // req.k)
        x, y, alive = tasks.pad_shards(task.x, task.y, mloc_b)
        if alive.shape[1] != req.m // req.k:
            self.stats.padded_requests += 1
        self._queues[(CompatKey.of(req), mloc_b)].append(
            (req, task, (x, y, alive, req.make_key())))

    def queued(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + sum(len(s.admitted) for s in self._suspended))

    # -- one dispatch ------------------------------------------------------

    def _group(self, k: int) -> sharded_batched.PlayersGroup:
        """The players group of k players, made once and held until
        :meth:`close`."""
        if k not in self._groups:
            self._groups[k] = self._owned.enter_context(
                sharded_batched.make_players_group(k, self.device))
        return self._groups[k]

    def _compiled(self, bucket: BucketKey, x, y, alive, keys):
        compat = bucket.compat
        if compat.engine == "sharded":
            build = lambda: sharded_batched.lower_classify_sharded(  # noqa: E731
                x, y, alive, keys, compat.cfg, compat.cls,
                group=self._group(compat.cfg.k))
        else:
            build = lambda: batched.lower_classify(  # noqa: E731
                x, y, alive, keys, compat.cfg, compat.cls,
                device=self.device)
        return self.cache.get(bucket, build)

    def _dispatch(self, bucket: BucketKey, x, y, alive, keys, m_true):
        """Program-cache lookup + engine run → (result, service_s).

        ``service_s`` excludes a cache-miss build — ``run_stream``
        charges build time separately from the cache's ``compile_s``
        counter — and ends with the result on the host.
        """
        compiled = self._compiled(bucket, x, y, alive, keys)
        compat = bucket.compat
        t0 = time.perf_counter()
        with obs_trace.span("dispatch", "scheduler",
                            engine=compat.engine, B=bucket.B,
                            mloc=bucket.mloc):
            if compat.engine == "sharded":
                res = sharded_batched.run_accurately_classify_sharded(
                    x, y, keys, compat.cfg, compat.cls, alive=alive,
                    compiled=compiled, m_true=m_true)
            else:
                res = batched.run_accurately_classify_batched(
                    x, y, keys, compat.cfg, compat.cls, alive=alive,
                    compiled=compiled, m_true=m_true)
        return res, time.perf_counter() - t0

    # -- round-granular engine access (preemption path) --------------------

    def _engine_init(self, bucket: BucketKey, x, y, alive, keys):
        compat = bucket.compat
        if compat.engine == "sharded":
            return sharded_batched.init_state_sharded(
                x, y, keys, compat.cfg, alive=alive, cls=compat.cls,
                device=self._group(compat.cfg.k).device)
        return batched.init_state(x, y, keys, compat.cfg, alive=alive,
                                  cls=compat.cls, device=self.device)

    def _engine_run(self, bucket: BucketKey, state, x, y, n):
        compat = bucket.compat
        if compat.engine == "sharded":
            return sharded_batched.run_rounds_sharded(
                state, x, y, compat.cfg, compat.cls,
                group=self._group(compat.cfg.k), n=n)
        return batched.run_rounds(state, x, y, compat.cfg, compat.cls,
                                  n=n)

    def _engine_finalize(self, bucket: BucketKey, state, x, y, alive,
                         m_true):
        compat = bucket.compat
        step = state["step"] if isinstance(state, dict) else state.step
        steps = int(step.max())       # every round the dispatch ran
        if compat.engine == "sharded":
            return sharded_batched.finalize_sharded(
                state, x, y, alive, compat.cfg, compat.cls,
                m_true=m_true, group=self._group(compat.cfg.k),
                steps=steps)
        return batched.finalize(state, x, y, alive, compat.cfg,
                                compat.cls, m_true=m_true, steps=steps)

    def _ckpt_writer(self) -> msgpack_ckpt.AsyncCheckpointer:
        if self._writer is None:
            self._writer = msgpack_ckpt.AsyncCheckpointer()
        return self._writer

    def _state_treedef(self, bucket: BucketKey) -> str:
        return (sharded_batched.STATE_TREEDEF
                if bucket.compat.engine == "sharded"
                else batched.STATE_TREEDEF)

    def _state_device(self, bucket: BucketKey) -> torch.device:
        if bucket.compat.engine == "sharded":
            return self._group(bucket.compat.cfg.k).device
        return self.device

    def _checkpoint(self, seq: int, bucket: BucketKey, state, admitted,
                    rounds_done: int, chain: str) -> str:
        """Hand the state to the writer thread (the loop pays only the
        device→host copy); the first save of a chain is a full
        snapshot, later ones write only changed leaves."""
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = os.path.join(self.ckpt_dir, f"preempt_{seq:04d}.msgpack")
        # the span covers what the loop pays (device→host copy +
        # enqueue); the writer's own pack+fsync time lands in the
        # ckpt.save_s histogram (ckpt/msgpack_ckpt.py)
        with obs_trace.span("ckpt_save", "checkpoint", path=path,
                            rounds_done=rounds_done, chain=chain):
            self._ckpt_writer().save(
                path, state,
                meta={"rounds_done": rounds_done,
                      "engine": bucket.compat.engine,
                      "rids": [a[0].rid for a in admitted]},
                treedef=self._state_treedef(bucket), chain=chain)
        return path

    def _preempt_dispatch(self, seq: int, bucket: BucketKey, admitted,
                          payload, m_true, n_rounds: int):
        """Run ``n_rounds`` wire rounds, checkpoint the protocol state
        (off-thread), drop it, and requeue the batch for resume."""
        x, y, alive, keys = payload
        t0 = time.perf_counter()
        with obs_trace.span("preempt", "scheduler", seq=seq,
                            rounds=n_rounds,
                            engine=bucket.compat.engine):
            state = self._engine_init(bucket, x, y, alive, keys)
            state = self._engine_run(bucket, state, x, y, n=n_rounds)
            chain = f"d{seq:04d}"
            path = self._checkpoint(seq, bucket, state, admitted,
                                    n_rounds, chain)
            del state                          # the preemption: state dies
        self._suspended.append(_Suspended(
            bucket=bucket, admitted=admitted, payload=payload,
            m_true=m_true, ckpt_path=path, rounds_done=n_rounds,
            chain=chain, paths=(path,)))
        self.stats.preemptions += 1
        return [], time.perf_counter() - t0

    def _resume(self, sus: _Suspended, seq: int, now: float):
        """Restore a preempted batch from its checkpoint and continue.

        The restore is template-free: the manifest carries the state's
        treedef name and per-leaf dtypes, so no engine init runs.  A
        resume consumes a dispatch seq, so an injected ``preempt`` entry
        for it cuts the same batch off again — the re-checkpoint chains
        incrementally to the previous snapshot.  The whole chain is
        deleted once the batch completes.
        """
        x, y, alive, keys = sus.payload
        t0 = time.perf_counter()
        # early returns inside the span still close it — a resume that
        # is itself preempted leaves no dangling event in the trace
        with obs_trace.span("resume", "scheduler", seq=seq,
                            rounds_done=sus.rounds_done,
                            engine=sus.bucket.compat.engine) as r_sp:
            self._ckpt_writer().wait()         # tip durable before read
            state, _meta = msgpack_ckpt.restore_pytree(
                sus.ckpt_path, device=self._state_device(sus.bucket))
            self.stats.resumes += 1
            n_pre = self.preempt.get(seq)
            if n_pre is not None:              # preempted AGAIN mid-resume
                r_sp.update(repreempted=True, rounds=n_pre)
                state = self._engine_run(sus.bucket, state, x, y, n=n_pre)
                path = self._checkpoint(seq, sus.bucket, state,
                                        sus.admitted,
                                        sus.rounds_done + n_pre,
                                        sus.chain)
                del state
                self._suspended.append(dataclasses.replace(
                    sus, ckpt_path=path,
                    rounds_done=sus.rounds_done + n_pre,
                    paths=sus.paths + (path,)))
                self.stats.preemptions += 1
                return [], time.perf_counter() - t0
            state = self._engine_run(sus.bucket, state, x, y, n=None)
            res = self._engine_finalize(sus.bucket, state, x, y, alive,
                                        sus.m_true)
        service_s = time.perf_counter() - t0
        self._ckpt_writer().forget(sus.chain)
        for p in sus.paths:                    # consumed — don't litter
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
        self.stats.note(sus.bucket, len(sus.admitted), sus.bucket.B)
        completions = []
        for lane, (req, task, _data) in enumerate(sus.admitted):
            completions.append(Completion(
                request=req, task=task, result=res, lane=lane,
                bucket=sus.bucket,
                queue_wait_s=max(now - req.arrival_s, 0.0),
                service_s=service_s,
                latency_s=max(now - req.arrival_s, 0.0) + service_s,
                resumed=True))
        return completions, service_s

    def step(self, now: float = 0.0):
        """Admit one batch from the fullest-eligible queue and dispatch.

        Returns (completions, service_s) — empty if nothing is queued.
        Admission pops up to bucket-B requests per compat group; the
        rest stay queued for the next step (the "slots free up" cycle).
        Preempted (suspended) batches resume before fresh admissions;
        a resume is an engine dispatch and consumes a dispatch seq (so
        ``preempt`` injections can hit it too).
        """
        if self._suspended:
            seq = self._dispatch_seq
            self._dispatch_seq += 1
            return self._resume(self._suspended.popleft(), seq, now)
        qkey = self._pick_queue()
        if qkey is None:
            return [], 0.0
        compat, mloc_b = qkey
        q = self._queues[qkey]
        B = self.lattice.bucket_b(len(q))
        take = min(len(q), B)
        admitted = [q.popleft() for _ in range(take)]
        if not q:
            del self._queues[qkey]
        items = [a[2] for a in admitted]
        x, y, alive, keys, n_real = batched.stack_for_dispatch(items, B)
        bucket = BucketKey(compat=compat, B=B, mloc=mloc_b)
        m_true = np.array([a[0].m for a in admitted]
                          + [admitted[0][0].m] * (B - n_real))
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        n_pre = self.preempt.get(seq)
        if n_pre is not None:
            return self._preempt_dispatch(
                seq, bucket, admitted, (x, y, alive, keys), m_true,
                n_pre)
        res, service_s = self._dispatch(bucket, x, y, alive, keys,
                                        m_true)
        self.stats.note(bucket, n_real, B)
        completions = []
        for lane, (req, task, _data) in enumerate(admitted):
            completions.append(Completion(
                request=req, task=task, result=res, lane=lane,
                bucket=bucket,
                queue_wait_s=max(now - req.arrival_s, 0.0),
                service_s=service_s,
                latency_s=max(now - req.arrival_s, 0.0) + service_s))
        return completions, service_s

    def _pick_queue(self):
        """Oldest head request wins — FIFO across bucket queues."""
        best, best_t = None, None
        for qkey, q in self._queues.items():
            t = q[0][0].arrival_s
            if best_t is None or t < best_t:
                best, best_t = qkey, t
        return best

    # -- closed-loop stream ------------------------------------------------

    def run_stream(self, requests) -> list:
        """Serve an arrival-stamped request stream to completion.

        Virtual clock: arrivals advance it when the server is idle,
        dispatches advance it by their measured wall time (compile time
        on a cache miss is charged to the dispatch that missed — warm
        the cache first to measure steady state).
        """
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        clock = 0.0
        i = 0
        completions = []
        while i < len(pending) or self.queued():
            # admit everything that has arrived by now
            while i < len(pending) and pending[i].arrival_s <= clock:
                self.submit(pending[i])
                i += 1
            if not self.queued():
                clock = max(clock, pending[i].arrival_s)
                continue
            if self.policy == "fill" and i < len(pending) \
                    and self._queues and not self._suspended:
                deadline = self._fill_deadline()
                if deadline is not None and clock < deadline:
                    # hold admission for a fuller batch, but never past
                    # the head request's deadline
                    clock = max(clock,
                                min(pending[i].arrival_s, deadline))
                    continue
            compile_s0 = self.cache.stats.compile_s
            done, service_s = self.step(now=clock)
            dcompile = self.cache.stats.compile_s - compile_s0
            clock += service_s + dcompile
            for c in done:
                c.latency_s += dcompile
                completions.append(c)
        return completions

    def _fill_deadline(self) -> float | None:
        """Virtual time at which SOME queue must dispatch even if not
        full; None when a queue is already full enough to go now.

        Dispatch order is "oldest head across bucket queues"
        (:meth:`_pick_queue`), so the deadline must consider every
        queue, not just one: a full max-B batch anywhere dispatches
        immediately (returning None) even when the globally oldest head
        sits in a sparser queue, and the hold never extends past the
        oldest pending head + ``fill_wait_s`` — previously this read a
        single queue and a two-bucket burst could hold a ready batch
        (or a stale head) for the whole fill window.
        """
        heads = []
        for q in self._queues.values():
            if len(q) >= self.lattice.max_b:
                return None
            heads.append(q[0][0].arrival_s)
        return min(heads) + self.fill_wait_s

    # -- warmup ------------------------------------------------------------

    def warm(self, requests, b_sizes: tuple | None = None,
             stepping: bool | None = None) -> int:
        """Compile every bucket a request set can reach.

        The admission policy picks the bucket B from the instantaneous
        queue depth, so replaying a trace once does NOT deterministically
        visit every bucket the next replay will.  This enumerates the
        reachable set — each distinct (compat, bucket-mloc) × each
        lattice B — and compiles the missing ones with representative
        payloads, so a warmed scheduler serves any arrival order of
        these requests with zero recompiles.  Returns the number of
        programs compiled.

        ``stepping`` additionally compiles the round-granular programs
        the preempt/resume path runs (``init_state``/``run_rounds``; the
        slice length ``n`` is a traced argument, so one program per
        bucket covers every slice size including run-to-completion).
        Defaults to on when the scheduler has a checkpoint dir — a
        preemption-injected stream then pays no stepping compile inside
        measured service time.
        """
        if stepping is None:
            stepping = self.ckpt_dir is not None
        groups = {}
        for req in requests:
            mloc_b = self.lattice.bucket_mloc(req.m // req.k)
            groups.setdefault((CompatKey.of(req), mloc_b), req)
        before = self.cache.stats.compiles
        for (compat, mloc_b), req in groups.items():
            task = req.make_task()
            x, y, alive = tasks.pad_shards(task.x, task.y, mloc_b)
            item = (x, y, alive, req.make_key())
            for B in (b_sizes or self.lattice.b_sizes):
                xb, yb, ab, keys, _ = batched.stack_for_dispatch(
                    [item], B)
                bucket = BucketKey(compat=compat, B=B, mloc=mloc_b)
                self._compiled(bucket, xb, yb, ab, keys)
                if stepping:
                    st = self._engine_init(bucket, xb, yb, ab, keys)
                    self._engine_run(bucket, st, xb, yb, n=0)
        return self.cache.stats.compiles - before

    # -- parity baseline ---------------------------------------------------

    def one_shot(self, req: Request):
        """The one-shot engine run the scheduler must reproduce bit for
        bit: B=1, the request's own bucket mloc, same key.  Uses the
        same compile cache (B=1 buckets), so repeated parity checks
        don't recompile."""
        task = req.make_task()
        mloc_b = self.lattice.bucket_mloc(req.m // req.k)
        x, y, alive = tasks.pad_shards(task.x, task.y, mloc_b)
        x, y, alive, keys, _ = batched.stack_for_dispatch(
            [(x, y, alive, req.make_key())], 1)
        bucket = BucketKey(compat=CompatKey.of(req), B=1, mloc=mloc_b)
        res, _ = self._dispatch(bucket, x, y, alive, keys,
                                np.array([req.m]))
        return res


# ---------------------------------------------------------------------------
# Arrival traces
# ---------------------------------------------------------------------------

def poisson_trace(n: int, rate_per_s: float, seed: int = 0):
    """n exponential inter-arrival gaps (a Poisson process), as stamps."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return np.cumsum(gaps)


def bursty_trace(n: int, rate_per_s: float, burst: int = 8,
                 seed: int = 0):
    """Same mean rate, but arrivals land in bursts of ``burst`` at the
    burst's start — the worst case for a fill policy's head latency."""
    rng = np.random.default_rng(seed)
    n_bursts = int(np.ceil(n / burst))
    gaps = rng.exponential(burst / rate_per_s, size=n_bursts)
    starts = np.cumsum(gaps)
    return np.repeat(starts, burst)[:n]


def make_request_stream(n: int, arrivals, shapes, seed0: int = 0,
                        **common) -> list:
    """n requests cycling through ``shapes`` (dicts of Request field
    overrides), stamped with ``arrivals``."""
    reqs = []
    for i in range(n):
        fields = dict(shapes[i % len(shapes)])
        fields.update(common)
        reqs.append(Request(rid=i, seed=seed0 + i,
                            arrival_s=float(arrivals[i]), **fields))
    return reqs
