"""Round-granular tracing of an engine and trace↔ledger cross-validation
(counterpart of ``repro.obs.roundtrace``).

:func:`trace_rounds` advances a stepping engine one wire round at a
time (``run_rounds(..., n=1)``) and emits a ``round`` span per step
whose ``task_bits`` args carry, per task, the wire bits that round
moved, by ledger category (``coreset`` / ``ws`` / ``hypotheses`` /
``control`` / ``histograms`` / ``votes`` / ``quarantine``).  The bits
come from deltas of the state's per-attempt counters (``hist_players``,
``hist_players_h``, ``hist_alive``, ``hist_stuck``, ``hist_p``, …),
which advance by exactly one round's worth per step — nothing runs
inside the round body — and which round-trip exactly through
``ckpt/msgpack_ckpt``, so a run preempted and resumed from a
checkpoint traces the same per-round bits with no double count.

:func:`validate_trace` then holds the traced sums bit for bit to
``result.ledger(b)`` — per task, per category, dropout masks included
— a second, independent witness of the Theorem 4.1 accounting (the
sharded engine's ``validate_ledger`` is the third: measured
collective payloads).

Both stepping engines: the batched ``StepState`` NamedTuple and the
sharded engine's dict expose the same counter names.  The functions,
span names and args are the reference's, so one validator reads both
packages' traces.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import ledger as L
from repro_torch.obs import trace as T
from repro_torch.obs.trace import CATEGORY_FIELDS, ledger_bits  # noqa: F401

# the small per-task counters trace_rounds snapshots each round — O(B·A)
# ints, never the O(B·k·mloc) protocol arrays
_COUNTER_FIELDS = ("attempt", "done", "step", "hist_stuck",
                   "hist_rounds", "hist_alive", "hist_p",
                   "hist_players", "hist_players_h", "hist_players_last")


def _field(state, name: str):
    """One accessor for both engines' states (NamedTuple vs dict)."""
    if isinstance(state, dict):
        return state[name]
    return getattr(state, name)


def snapshot_counters(state) -> dict:
    """Host copies of the per-task accounting counters."""
    out = {}
    for f in _COUNTER_FIELDS:
        v = _field(state, f)
        out[f] = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def round_bits(cfg, cls, s0: dict, s1: dict, m_default: int,
               m_true=None) -> tuple[dict, dict, dict]:
    """Wire bits of ONE step, per task, from counter deltas.

    ``s0``/``s1``: :func:`snapshot_counters` before/after a single
    ``run_rounds(n=1)`` call.  Returns ``(task_bits, rounds, players)``
    — ``task_bits[b]`` a per-category dict, ``rounds[b]`` the wire
    rounds task b advanced (0 or 1; a task absent from the maps was
    frozen), ``players[b]`` the round's alive-player count.  The
    formulas are ``ledger.boost_attempt_ledger_masked``'s, re-expressed
    per round: summed over an attempt's rounds they reproduce every
    field exactly.
    """
    n = L.domain_size(cls)
    mode = L.tree_comm_mode(cls)
    c = cfg.coreset_size
    hyp_bits = cls.hypothesis_bits()
    task_bits: dict[int, dict] = {}
    rounds: dict[int, int] = {}
    players: dict[int, int] = {}
    for b in range(int(s0["attempt"].shape[0])):
        if int(s1["step"][b]) == int(s0["step"][b]):
            continue                       # frozen lane (done / budget)
        a0 = int(s0["attempt"][b])
        k_alive = int(s1["hist_players"][b, a0]
                      - s0["hist_players"][b, a0])
        dh = int(s1["hist_players_h"][b, a0]
                 - s0["hist_players_h"][b, a0])
        ended = int(s1["attempt"][b]) > a0
        stuck = bool(s1["hist_stuck"][b, a0]) if ended else False
        # the attempt's m_alive/T are fixed at its first round and
        # recorded in hist_alive before any round's charges
        m_a = max(int(s1["hist_alive"][b, a0]), 2)
        T_a = cfg.num_rounds(m_a)
        bits = dict.fromkeys(CATEGORY_FIELDS, 0)
        if mode == "coreset":
            bits["coreset"] = k_alive * c * L.example_bits(n)
        else:
            # distributed growth: histograms/votes every round;
            # examples cross the wire only on the stuck (final) round
            bits["histograms"] = (k_alive * L.hist_scalars_per_player(cls)
                                  * L.histogram_cell_bits(m_a, T_a))
            bits["votes"] = (k_alive * L.vote_entries_per_player(cls)
                             * L.vote_entry_bits(cls, m_a, T_a))
            if stuck:
                bits["coreset"] = k_alive * c * L.example_bits(n)
        bits["ws"] = k_alive * L.weight_sum_bits(m_a, T_a)
        bits["hypotheses"] = dh * hyp_bits
        if ended:
            # stuck flag (if any) + halt bit, to the final round's
            # alive players (== players_last by construction)
            bits["control"] = k_alive * (2 if stuck else 1)
            if stuck:
                p = int(s1["hist_p"][b, a0])
                m_eff = m_default if m_true is None else int(m_true[b])
                m_bits = max(int(math.ceil(math.log2(max(m_eff, 2)))), 1)
                bits["control"] += k_alive * p * L.point_bits(n)
                bits["quarantine"] = k_alive * p * 2 * m_bits
        task_bits[b] = bits
        rounds[b] = 1
        players[b] = k_alive
    return task_bits, rounds, players


def trace_rounds(step_fn, state, cfg, cls, *, m_true=None,
                 recorder: T.TraceRecorder | None = None,
                 max_rounds: int | None = None, engine: str = "batched"):
    """Drive ``step_fn`` one wire round at a time, emitting ``round``
    spans with per-task per-category wire bits until every task halts.

    ``step_fn(state) -> state`` must advance by at most ONE wire round
    (wrap ``run_rounds`` / ``run_rounds_sharded`` with ``n=1``);
    ``m_true``: optional [B] true sample sizes (the serving layer's
    padded-bucket case — dispute-report widths charge the request's own
    ⌈log2 m⌉).  Rounds where players are masked out emit a
    ``dead_players`` instant event per affected task with ``bits=0`` —
    absent players move nothing, and the trace says so explicitly.
    Returns the final state; validate with :func:`validate_trace`.
    Tracing only the small counter snapshots, the loop costs
    O(B·attempts) host ints per round — use it for traced runs; the
    disabled-tracing hot path stays one dispatch.
    """
    rec = recorder if recorder is not None else T.active()
    if rec is None:
        raise ValueError("trace_rounds needs a recorder: pass one or "
                         "enable tracing (repro_torch.obs.trace.enable)")
    k = int(_field(state, "alive").shape[1])
    m_default = k * int(_field(state, "alive").shape[2])
    a_max = cfg.opt_budget + 1
    s0 = snapshot_counters(state)
    r = 0
    while bool(np.any(~s0["done"] & (s0["attempt"] < a_max))):
        if max_rounds is not None and r >= max_rounds:
            break
        with rec.span("round", "protocol", engine=engine) as sp:
            state = step_fn(state)
            s1 = snapshot_counters(state)
            task_bits, rounds, players = round_bits(
                cfg, cls, s0, s1, m_default, m_true=m_true)
            sp.update(
                task_bits={str(b): tb for b, tb in task_bits.items()},
                task_rounds={str(b): n for b, n in rounds.items()},
                task_attempts={str(b): 1 for b in rounds
                               if int(s1["attempt"][b])
                               > int(s0["attempt"][b])},
                players={str(b): p for b, p in players.items()})
        for b, alive_players in players.items():
            if alive_players < k:
                rec.instant("dead_players", "protocol", task=b,
                            players_dead=k - alive_players,
                            players_alive=alive_players, bits=0)
        if not rounds:
            break                          # no lane advanced: all halted
        s0 = s1
        r += 1
    return state


# ---------------------------------------------------------------------------
# validation: traced sums ≡ ledger, bit for bit
# ---------------------------------------------------------------------------

def _events(events_or_recorder) -> list:
    if isinstance(events_or_recorder, T.TraceRecorder):
        return events_or_recorder.events
    return list(events_or_recorder)


def traced_totals(events_or_recorder) -> dict:
    """Sum every span's ``task_bits`` / ``task_rounds`` /
    ``task_attempts`` payloads: task id → {category: bits, plus
    ``rounds`` and ``attempts`` counts}."""
    totals: dict[int, dict] = {}
    for ev in _events(events_or_recorder):
        args = ev.get("args") or {}
        for key, slot in (("task_bits", None), ("task_rounds", "rounds"),
                          ("task_attempts", "attempts")):
            for bs, val in (args.get(key) or {}).items():
                acc = totals.setdefault(
                    int(bs), dict.fromkeys(CATEGORY_FIELDS, 0)
                    | {"rounds": 0, "attempts": 0})
                if slot is None:
                    for cat, v in val.items():
                        acc[cat] += int(v)
                else:
                    acc[slot] += int(val)
    return totals


def validate_trace(events_or_recorder, ledgers: dict) -> dict:
    """Prove traced wire bits ≡ ledger, per task and per category.

    ``ledgers``: task id → ``repro_torch.core.types.Ledger`` (e.g.
    ``{b: result.ledger(b) for b in range(result.batch)}``, or
    ``{0: classify_result.ledger}`` for the host engine).  Checks
    every category of :data:`repro_torch.obs.trace.CATEGORY_FIELDS` plus the
    ``rounds``/``attempts`` counts for **bit-exact** equality; raises
    ``AssertionError`` naming every divergence, returns the per-task
    comparison when clean.  Merged event lists from a
    checkpoint/resume pair validate the same way — bits are counter
    deltas, so a resumed segment continues where the preempted one
    stopped with no overlap.
    """
    got = traced_totals(events_or_recorder)
    report: dict[int, dict] = {}
    errors: list[str] = []
    for b, led in ledgers.items():
        want = ledger_bits(led)
        want["rounds"] = int(led.rounds)
        want["attempts"] = int(led.attempts)
        have = got.get(int(b))
        if have is None:
            errors.append(f"task {b}: no traced bits at all")
            continue
        for key, w in want.items():
            if have.get(key, 0) != w:
                errors.append(
                    f"task {b} {key}: traced {have.get(key, 0)} != "
                    f"ledger {w}")
        report[int(b)] = {"traced": have, "ledger": want}
    extra = sorted(set(got) - {int(b) for b in ledgers})
    if extra:
        errors.append(f"traced bits for unknown tasks {extra}")
    if errors:
        raise AssertionError(
            "trace↔ledger mismatch:\n" + "\n".join(errors))
    return report
