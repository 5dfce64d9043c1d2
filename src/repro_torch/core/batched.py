"""Batched AccuratelyClassify engine, round-steppable (counterpart of
repro.core.batched).

B independent tasks advance together, one wire round per step:

* :func:`init_state` — the whole protocol state as tensors;
* :func:`run_rounds` — advance every unfinished task by up to ``n``
  rounds (attempt transitions — stuck → quarantine → retry, success,
  budget exhaustion — happen inside a step);
* :func:`finalize` — a host :class:`BatchedClassifyResult`.

Any slicing of ``run_rounds`` gives the same final state as one run to
completion, and the protocol outputs equal the JAX engine's bit for
bit (tests/test_torch_batched.py).  Where the reference runs a
``while_loop`` on the device, the port runs a Python loop over steps
and checks ``any(active)`` on the host, one small sync per round.

Tasks are int32 points [B, k, mloc] (the integer track, quantile
coreset) or float32 feature rows [B, k, mloc, F] (AxisStumps and
HistogramTrees, randomized coreset).  Keys are threefry words
(:mod:`repro_torch.core.prng`) carried on the state's device: the task
key splits at every attempt start, the attempt key at every round, as
in the reference.

Differences from the reference's state, all deliberate:

* ``key_data``/``akey_data`` hold the uint32 key words in int64
  tensors (torch has no full uint32 arithmetic); ``repro_torch.convert``
  restores uint32 at the boundary;
* ``wsum`` [B, k] float32 and ``wsum_shift`` [B, k] int32 — each
  player's Σ_alive 2^(wsum_shift − hits), the weight sum of the next
  round's step 2(b), as the mw_update kernel returns it (the reference
  recomputes it from ``hits`` every round); the shift is the least
  alive hit count the kernel's input had.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.ckpt import msgpack_ckpt
from repro_torch.core import boost_attempt, classify, fp32, prng, weak
from repro_torch.core import ledger as L
from repro_torch.core import weights as W
from repro_torch.core.types import BoostConfig, ClassifyResult, Ledger
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace

class StepState(NamedTuple):
    """Whole-protocol state of B tasks; every field has a leading
    ``[B]`` task axis."""

    # -- protocol-level ---------------------------------------------------
    attempt: torch.Tensor           # int32 attempts executed so far
    done: torch.Tensor              # bool  some attempt succeeded
    alive: torch.Tensor             # [k, mloc] current alive-example mask
    disputed: torch.Tensor          # [k, mloc] quarantined-example mask
    key_data: torch.Tensor          # [2] task key words (int64)
    h_params: torch.Tensor          # [t_buf, P] winning ensemble
    rounds: torch.Tensor            # int32 rounds of the winning attempt
    min_loss: torch.Tensor          # last center ERM loss (diagnostic)
    hist_stuck: torch.Tensor        # [A] bool  per-attempt stuck flag
    hist_rounds: torch.Tensor       # [A] int32 per-attempt rounds
    hist_alive: torch.Tensor        # [A] int32 alive examples entering
    hist_p: torch.Tensor            # [A] int32 distinct disputed points
    hist_players: torch.Tensor      # [A] Σ_wire-rounds alive players
    hist_players_h: torch.Tensor    # [A] same over successful rounds
    hist_players_last: torch.Tensor  # [A] alive players at last round
    # -- in-attempt -------------------------------------------------------
    in_attempt: torch.Tensor        # bool  an attempt is in flight
    akey_data: torch.Tensor         # [2] this attempt's round key words
    t: torch.Tensor                 # int32 hypotheses this attempt
    bound: torch.Tensor             # int32 this attempt's round bound
    hits: torch.Tensor              # [k, mloc] MW state
    wsum: torch.Tensor              # [k] Σ_alive 2^(wsum_shift − hits)
    wsum_shift: torch.Tensor        # [k] int32 its exponent shift
    cur_h: torch.Tensor             # [t_buf, P] growing ensemble
    core_x: torch.Tensor            # [k, c(, F)] last round's coreset
    core_y: torch.Tensor            # [k, c]
    step: torch.Tensor              # int32 global wire-round counter


# the reference's layout (key words uint32 at the boundary; int64 in
# the port's tensors), plus the port's own fields (PORT_FIELDS)
STATE_DTYPES = {
    "attempt": "int32", "done": "bool", "alive": "bool",
    "disputed": "bool", "key_data": "uint32", "h_params": "float32",
    "rounds": "int32", "min_loss": "float32", "hist_stuck": "bool",
    "hist_rounds": "int32", "hist_alive": "int32", "hist_p": "int32",
    "hist_players": "int32", "hist_players_h": "int32",
    "hist_players_last": "int32", "in_attempt": "bool",
    "akey_data": "uint32", "t": "int32", "bound": "int32",
    "hits": "int32", "wsum": "float32", "wsum_shift": "int32",
    "cur_h": "float32", "step": "int32",
}
KEY_FIELDS = ("key_data", "akey_data")
PORT_FIELDS = ("wsum", "wsum_shift")

# -- checkpoint identity of the stepping state ------------------------------
# Leaf names are the StepState field names and the dtypes those of
# STATE_DTYPES, the key words uint32 on disk as in the reference's
# files.  core_x/core_y follow the task data's dtype and restore as
# saved.  The reference's own checkpoints (treedef
# "repro.core.batched.StepState") carry no wsum/wsum_shift: read them
# with ``msgpack_ckpt.load_pytree(path)`` and ``convert.from_jax``.

STATE_TREEDEF = "repro_torch.core.batched.StepState"


def check_state_dtypes(leaves: dict, dtypes: dict, what: str) -> None:
    """Refuse a restored leaf whose dtype drifted from the engine's
    declared layout (both engines' reconstructors)."""
    for name, want in dtypes.items():
        got = np.asarray(leaves[name]).dtype
        if got != np.dtype(want):
            raise ValueError(
                f"checkpoint leaf {name!r} of {what} has dtype {got} "
                f"but the engine expects {want} — refusing a silent "
                f"cast (bit-parity would break invisibly)")


def state_leaf_tensor(name: str, arr: np.ndarray, device) -> torch.Tensor:
    """One checked host leaf as the engine's tensor on ``device`` (key
    words widened from uint32 to the int64 the port computes in)."""
    if name in KEY_FIELDS:
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr).to(device)


def _unflatten_state(leaves: dict, device) -> "StepState":
    missing = set(StepState._fields) - set(leaves)
    if missing:
        raise KeyError(f"checkpoint missing StepState leaves: "
                       f"{sorted(missing)}")
    check_state_dtypes(leaves, STATE_DTYPES, "batched.StepState")
    return StepState(**{f: state_leaf_tensor(f, leaves[f], device)
                        for f in StepState._fields})


msgpack_ckpt.register_treedef(STATE_TREEDEF, _unflatten_state,
                              dict.fromkeys(KEY_FIELDS, "uint32"))


def num_rounds_dynamic(cfg: BoostConfig, m_alive: torch.Tensor) -> torch.Tensor:
    """Per-task T = ⌈6·log2 m_alive⌉ as the reference's jitted engine
    computes it (int32)."""
    m = torch.clamp(m_alive, min=2).float()
    return fp32.num_rounds(cfg.rounds_factor, m, traced=True)


def canon_player_sched(player_sched, B: int, k: int,
                       device=None) -> torch.Tensor:
    """Normalise a player schedule to ``[B, R, k]`` bool.

    None (all alive, R = 1), ``[R, k]`` (shared by every task) or
    ``[B, R, k]``; row ``min(step, R−1)`` is a round's mask.  Every
    round must keep ≥ 1 player alive.
    """
    if player_sched is None:
        return torch.ones((B, 1, k), dtype=torch.bool, device=device)
    sched = as_tensor(np.asarray(player_sched, bool), device)
    if sched.ndim == 2:
        sched = sched[None].expand((B,) + tuple(sched.shape))
    if sched.shape[0] != B or sched.shape[2] != k:
        raise ValueError(
            f"player_sched {tuple(sched.shape)} incompatible with B={B}, k={k}")
    if not bool(sched.any(dim=-1).all()):
        raise ValueError("player_sched has a round with zero alive "
                         "players — the protocol cannot proceed")
    return sched


def as_tensor(v, device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or an array (arrays are
    copied, so read-only numpy views are fine)."""
    if not torch.is_tensor(v):
        v = torch.from_numpy(np.array(v))
    return v.to(device)


def task_keys(keys, B: int, device) -> torch.Tensor:
    """[B, 2] task key words from one key [2] (split into B, as the
    reference splits a single key) or B keys [B, 2] (tensor or uint32
    words)."""
    keys = prng.wrap_key_data(keys).to(device)
    if keys.ndim == 1:
        keys = prng.split(keys, B)
    if tuple(keys.shape) != (B, 2):
        raise ValueError(f"need {B} task keys [B, 2], got "
                         f"{tuple(keys.shape)}")
    return keys


def init_state(x, y, keys, cfg: BoostConfig, alive=None,
               t_buf: int | None = None, cls=None,
               device=None) -> StepState:
    """Fresh protocol state for a batch of B tasks.

    ``x`` [B, k, mloc] int32 points or [B, k, mloc, F] float32 feature
    rows; ``y`` [B, k, mloc] int8 ±1; ``keys`` [B, 2] task key words
    (or one key to split); ``alive`` optional [B, k, mloc] bool (False
    = padding); ``t_buf`` ensemble-buffer rounds (default
    ``cfg.num_rounds(k·mloc)``); ``cls`` sizes the ensemble buffers
    (:func:`weak.param_dim`).
    """
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    B, k, mloc = x.shape[:3]
    if not ((x.ndim == 3 and x.dtype == torch.int32)
            or (x.ndim == 4 and x.dtype == torch.float32)):
        raise TypeError("the engine takes int32 points [B, k, mloc] or "
                        "float32 feature rows [B, k, mloc, F]")
    kd = task_keys(keys, B, dev)
    if t_buf is None:
        t_buf = cfg.num_rounds(k * mloc)
    alive = (torch.ones((B, k, mloc), dtype=torch.bool, device=dev)
             if alive is None else as_tensor(alive, dev))
    p_dim = weak.param_dim(cls)
    a_max = cfg.opt_budget + 1
    c = cfg.coreset_size

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def f32(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def b8(*shape):
        return torch.zeros(shape, dtype=torch.bool, device=dev)

    return StepState(
        attempt=i32(B), done=b8(B), alive=alive,
        disputed=torch.zeros_like(alive), key_data=kd,
        h_params=f32(B, t_buf, p_dim), rounds=i32(B), min_loss=f32(B),
        hist_stuck=b8(B, a_max), hist_rounds=i32(B, a_max),
        hist_alive=i32(B, a_max), hist_p=i32(B, a_max),
        hist_players=i32(B, a_max), hist_players_h=i32(B, a_max),
        hist_players_last=i32(B, a_max),
        in_attempt=b8(B), akey_data=torch.zeros_like(kd), t=i32(B),
        bound=i32(B), hits=W.init_hits((B, k, mloc), device=dev),
        wsum=f32(B, k), wsum_shift=i32(B, k),
        cur_h=f32(B, t_buf, p_dim),
        core_x=torch.zeros((B, k, c) + tuple(x.shape[3:]), dtype=x.dtype,
                           device=dev),
        core_y=torch.zeros((B, k, c), dtype=torch.int8, device=dev),
        step=i32(B))


def _set_at(arr, idx, val, cond):
    """arr[b, idx[b]] = val[b] where cond[b] (a copy)."""
    rows = torch.arange(arr.shape[0], device=arr.device)
    out = arr.clone()
    out[rows, idx] = torch.where(cond, val.to(arr.dtype), arr[rows, idx])
    return out


def _active(s: StepState, a_max: int) -> torch.Tensor:
    return ~s.done & (s.attempt < a_max)


class StepInfo(NamedTuple):
    """What one step did, per task [B]: the sharded engine's wire
    counters follow from it."""

    active: torch.Tensor     # bool  the lane moved
    start: torch.Tensor      # bool  an attempt started
    stuck: torch.Tensor      # bool  the round was stuck
    ended: torch.Tensor      # bool  the attempt ended
    k_alive: torch.Tensor    # int32 players alive this round
    p_count: torch.Tensor    # int32 distinct points quarantined


def _one_step(cfg: BoostConfig, cls, x, y, x_orders, y_sorted, sched,
              s: StepState, wire: boost_attempt.Wire | None = None,
              no_center: bool = False) -> tuple[StepState, StepInfo]:
    """ONE wire round of every task (the reference's vmapped step) on
    this process's players: x and the player-sharded state fields hold
    the wire's local players, the rest every player (``wire`` default:
    all of them)."""
    wire = boost_attempt.Wire() if wire is None else wire
    a_max = cfg.opt_budget + 1
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    active = _active(s, a_max)
    pa = sched[rows, s.step.clamp(max=sched.shape[1] - 1).long()]   # [B, k]
    # ---- attempt start (no-op when one is already in flight) ----------
    start = ~s.in_attempt
    nk_sub = prng.split(s.key_data, 2)
    key_data = torch.where(start[:, None], nk_sub[:, 0], s.key_data)
    akey_data = torch.where(start[:, None], nk_sub[:, 1], s.akey_data)
    m_alive = wire.psum((s.alive & wire.local(pa)[:, :, None]).sum(
        dim=(1, 2), dtype=torch.int32))
    a = s.attempt
    a_idx = a.clamp(max=a_max - 1).long()
    bound = torch.where(start, num_rounds_dynamic(cfg, m_alive), s.bound)
    hits = torch.where(start[:, None, None], 0, s.hits)
    wsum = torch.where(start[:, None], s.alive.sum(dim=-1).float(), s.wsum)
    wsum_shift = torch.where(start[:, None], 0, s.wsum_shift)
    cur_h = torch.where(start[:, None, None], 0.0, s.cur_h)
    t = torch.where(start, 0, s.t)
    hist_alive = _set_at(s.hist_alive, a_idx, m_alive, start)
    # ---- one BoostAttempt round ----------------------------------------
    alive_sorted = (None if x_orders is None
                    else torch.gather(s.alive, -1, x_orders))
    carry = boost_attempt._Carry(
        t=t, stuck=torch.zeros_like(start), hits=hits, wsum=wsum,
        wsum_shift=wsum_shift, h_params=cur_h, core_x=s.core_x,
        core_y=s.core_y, min_loss=s.min_loss, key=akey_data)
    out = boost_attempt._round_body(
        cfg, cls, x, y, s.alive, x_orders, y_sorted, alive_sorted, carry,
        player_alive=pa, active=active, wire=wire, no_center=no_center)
    stuck = out.stuck
    success = ~stuck & (out.t >= bound)
    ended = stuck | success
    k_alive = pa.sum(dim=-1, dtype=torch.int32)
    # ---- full-point quarantine, masked to the round's senders ---------
    core_flat = out.core_x.reshape((B, -1) + tuple(out.core_x.shape[3:]))
    valid_flat = pa.repeat_interleave(cfg.coreset_size, dim=1)
    masked_flat = classify.mask_invalid_points(core_flat, valid_flat)
    dead_new = (s.alive & classify.match_points(x, masked_flat)
                & stuck[:, None, None])
    p_count = torch.where(
        stuck, classify.distinct_count_masked(core_flat, valid_flat), 0)
    players = s.hist_players[rows, a_idx] + k_alive
    players_h = s.hist_players_h[rows, a_idx] + torch.where(stuck, 0, k_alive)
    always = torch.ones_like(start)
    nxt = StepState(
        attempt=torch.where(ended, a + 1, a),
        done=s.done | success,
        alive=s.alive & ~dead_new,
        disputed=s.disputed | dead_new,
        key_data=key_data,
        h_params=torch.where(success[:, None, None], out.h_params,
                             s.h_params),
        rounds=torch.where(success, out.t, s.rounds),
        min_loss=out.min_loss,
        hist_stuck=_set_at(s.hist_stuck, a_idx, stuck, ended),
        hist_rounds=_set_at(s.hist_rounds, a_idx, out.t, ended),
        hist_alive=hist_alive,
        hist_p=_set_at(s.hist_p, a_idx, p_count, ended),
        hist_players=_set_at(s.hist_players, a_idx, players, always),
        hist_players_h=_set_at(s.hist_players_h, a_idx, players_h, always),
        hist_players_last=_set_at(s.hist_players_last, a_idx, k_alive,
                                  always),
        in_attempt=~ended,
        akey_data=out.key,
        t=out.t, bound=bound, hits=out.hits, wsum=out.wsum,
        wsum_shift=out.wsum_shift, cur_h=out.h_params, core_x=out.core_x,
        core_y=out.core_y, step=s.step + 1)
    # finished lanes freeze
    return StepState(*(
        torch.where(active.reshape((B,) + (1,) * (new.ndim - 1)), new, old)
        for new, old in zip(nxt, s))), StepInfo(
            active=active, start=start, stuck=stuck, ended=ended,
            k_alive=k_alive, p_count=p_count)


def _run_steps(x, y, sched, state: StepState, n: int | None,
               cfg: BoostConfig, cls) -> tuple[StepState, int]:
    """Advance every active task by up to ``n`` rounds; returns the
    state and the number of steps run."""
    a_max = cfg.opt_budget + 1
    x_orders, y_sorted = boost_attempt.sorted_views(cfg, x, y)
    steps = 0
    while (n is None or steps < n) and bool(_active(state, a_max).any()):
        state, _ = _one_step(cfg, cls, x, y, x_orders, y_sorted, sched,
                             state)
        steps += 1
    return state, steps


def run_rounds(state: StepState, x, y, cfg: BoostConfig, cls,
               n: int | None = None, player_sched=None) -> StepState:
    """Advance the protocol by up to ``n`` wire rounds (None = to
    completion, 0 = no-op) on the state's device.

    ``x``/``y`` are the SAME [B, k, mloc(, F)] / [B, k, mloc] arrays
    the state was built from; ``player_sched`` an optional [R, k] or [B, R, k] player-alive
    schedule.  Any slicing gives the same final state as one call.
    """
    dev = state.hits.device
    x, y = as_tensor(x, dev), as_tensor(y, dev)
    B, k = x.shape[:2]
    sched = canon_player_sched(player_sched, B, k, device=dev)
    with obs_trace.span("run_rounds", "engine", engine="batched", B=B,
                        n=-1 if n is None else int(n)):
        state = _run_steps(x, y, sched, state, n, cfg, cls)[0]
        obs_trace.sync_if_tracing(dev)
    return state


@dataclasses.dataclass
class BatchedClassifyResult:
    """Host view of one batched run (B tasks), numpy arrays.

    ``ok[b]`` is False iff task b exhausted ``opt_budget`` attempts.
    ``steps`` counts the engine's rounds (loop iterations) — one
    ``mw_update`` launch each.
    """

    hypotheses: np.ndarray   # [B, T_buf, P]
    rounds: np.ndarray       # [B]
    ok: np.ndarray           # [B] bool
    attempts: np.ndarray     # [B]
    alive: np.ndarray        # [B, k, mloc] final alive mask
    disputed: np.ndarray     # [B, k, mloc]
    min_loss: np.ndarray     # [B]
    hist_stuck: np.ndarray   # [B, A]
    hist_rounds: np.ndarray  # [B, A]
    hist_alive: np.ndarray   # [B, A]
    hist_p: np.ndarray       # [B, A]
    hist_players: np.ndarray
    hist_players_h: np.ndarray
    hist_players_last: np.ndarray
    x: np.ndarray
    y: np.ndarray
    alive0: np.ndarray
    cfg: BoostConfig
    cls: object
    m_true: np.ndarray | None = None
    steps: int = 0

    @property
    def batch(self) -> int:
        return int(self.rounds.shape[0])

    def ledger(self, b: int) -> Ledger:
        """Bit-identical to the reference's ledger of task b; under a
        dropout mask only bits alive players sent are charged."""
        cfg, cls = self.cfg, self.cls
        k, mloc = self.x.shape[1], self.x.shape[2]
        n = L.domain_size(cls)
        m_eff = k * mloc if self.m_true is None else int(self.m_true[b])
        m_bits_m = max(int(np.ceil(np.log2(max(m_eff, 2)))), 1)
        led = Ledger()
        for a in range(int(self.attempts[b])):
            stuck = bool(self.hist_stuck[b, a])
            pl_last = int(self.hist_players_last[b, a])
            led = led + L.boost_attempt_ledger_masked(
                cfg, cls, max(int(self.hist_alive[b, a]), 2),
                int(self.hist_rounds[b, a]), stuck,
                int(self.hist_players[b, a]),
                int(self.hist_players_h[b, a]), pl_last)
            if stuck:
                p = int(self.hist_p[b, a])
                led.bits_control += pl_last * p * L.point_bits(n)
                led.bits_dispute += pl_last * p * 2 * m_bits_m
        return led

    def per_task(self, b: int, player_mask=None) -> ClassifyResult:
        """Task b as a reference-shaped ClassifyResult (host arrays);
        ``player_mask`` ([k] bool) restricts the D-table counts to
        those players' copies."""
        if not self.ok[b]:
            raise RuntimeError(
                f"task {b} exceeded opt_budget={self.cfg.opt_budget}")
        alive0 = self.alive0[b]
        if player_mask is not None:
            alive0 = alive0 & np.asarray(player_mask, bool)[:, None]
        pts, pos, neg = classify.dispute_table(
            self.x[b], self.y[b], alive0, self.disputed[b])
        n_att = int(self.attempts[b])
        return ClassifyResult(
            hypotheses=self.hypotheses[b], rounds=int(self.rounds[b]),
            dispute_x=pts, dispute_y=(pos, neg),
            dispute_count=int(pts.shape[0]), attempts=n_att,
            stuck_history=[bool(v) for v in self.hist_stuck[b, :n_att]],
            ledger=self.ledger(b))

    def classifier(self, b: int,
                   player_mask=None) -> classify.ResilientClassifier:
        return classify.make_classifier(
            self.cls, self.per_task(b, player_mask=player_mask))


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def finalize(state: StepState, x, y, alive0, cfg: BoostConfig, cls,
             m_true=None, steps: int = 0) -> BatchedClassifyResult:
    """Copy stepped state to a host result (no protocol math here),
    under a ``finalize`` span."""
    with obs_trace.span("finalize", "engine", engine="batched"):
        return host_result(state, x, y, alive0, cfg, cls, m_true, steps)


def host_result(state: StepState, x, y, alive0, cfg: BoostConfig, cls,
                m_true=None, steps: int = 0) -> BatchedClassifyResult:
    """:func:`finalize`'s copy, without its span (the sharded engine's
    finalize spans its own)."""
    out = {f: _host(v) for f, v in state._asdict().items()}
    return BatchedClassifyResult(
        hypotheses=out["h_params"], rounds=out["rounds"],
        ok=out["done"], attempts=out["attempt"], alive=out["alive"],
        disputed=out["disputed"], min_loss=out["min_loss"],
        hist_stuck=out["hist_stuck"], hist_rounds=out["hist_rounds"],
        hist_alive=out["hist_alive"], hist_p=out["hist_p"],
        hist_players=out["hist_players"],
        hist_players_h=out["hist_players_h"],
        hist_players_last=out["hist_players_last"],
        x=_host(x), y=_host(y), alive0=_host(alive0), cfg=cfg, cls=cls,
        m_true=None if m_true is None else np.asarray(m_true),
        steps=steps)


def stack_for_dispatch(items, B: int):
    """Stack admitted (x, y, alive, key) tuples into bucket arrays.

    ``items`` holds up to B tasks already padded to a common [k, mloc]
    (numpy x, y, alive; ``key`` [2] words, a tensor or array); a short
    batch is filled by copies of lane 0 (a live lane: dead filler would
    spin through the whole opt_budget, and a batch is as slow as its
    slowest lane).  Returns (x, y, alive, keys, n_real): numpy arrays,
    keys an int64 [B, 2] CPU tensor; lanes ≥ n_real are filler, and
    their results are discarded."""
    n_real = len(items)
    if not 0 < n_real <= B:
        raise ValueError(f"need 1..{B} items, got {n_real}")
    items = list(items) + [items[0]] * (B - n_real)
    x = np.stack([it[0] for it in items])
    y = np.stack([it[1] for it in items])
    alive = np.stack([it[2] for it in items])
    keys = torch.stack([prng.wrap_key_data(it[3]).cpu() for it in items])
    return x, y, alive, keys, n_real


def _dtype_name(v) -> str:
    return str(v.dtype).removeprefix("torch.")


def signature(x, y, cfg: BoostConfig, cls, device) -> tuple:
    """What a bucket program is bound to: cfg, cls, the ensemble buffer
    t_buf, x's shape [B, k, mloc(, F)] and y's, their dtypes, and the
    device."""
    return (cfg, cls, cfg.num_rounds(int(x.shape[1]) * int(x.shape[2])),
            tuple(int(v) for v in x.shape), tuple(int(v) for v in y.shape),
            _dtype_name(x), _dtype_name(y), resolve_device(device))


class ClassifyProgram:
    """The batched engine bound to one input signature (:func:`signature`),
    the port's counterpart of the reference's AOT-compiled executable
    (``repro.core.batched.lower_classify``).

    Building it does the per-shape work once: the canonical all-alive
    player schedule, the ensemble buffer size, and the round body's
    kernels prepared (``boost_attempt.prepare_kernels``: the histogram
    plans it holds; on the card the libraries loaded and the mw_update
    workspace sized).
    Calling it on any other signature raises, as a JAX ``Compiled``
    does; dropping it drops what it holds.  ``builds`` counts the
    programs built in this process (a serving cache's steady state
    builds none).
    """

    builds = 0

    def __init__(self, x, y, cfg: BoostConfig, cls, device=None,
                 kloc: int | None = None):
        self.signature = signature(x, y, cfg, cls, device)
        if tuple(y.shape) != tuple(x.shape[:3]):
            raise ValueError(f"y {tuple(y.shape)} does not fit x "
                             f"{tuple(x.shape)}")
        self.cfg, self.cls = cfg, cls
        self.t_buf = self.signature[2]
        B, k, mloc = self.signature[3][:3]
        self.device = self.signature[-1]
        self.sched = canon_player_sched(None, B, k, device=self.device)
        # this process's players: all k here, a rank's kloc when sharded
        self.hist_plans = boost_attempt.prepare_kernels(
            cfg, cls, B, k if kloc is None else kloc, k, mloc, self.device)
        ClassifyProgram.builds += 1

    def check(self, x, y) -> None:
        """Raise unless x and y fit this program's signature."""
        got = signature(x, y, self.cfg, self.cls, self.device)
        if got != self.signature:
            raise ValueError(
                f"a bucket program bound to x {self.signature[3]}, y "
                f"{self.signature[4]}, dtypes {self.signature[5:7]} was "
                f"called on x {got[3]}, y {got[4]}, dtypes {got[5:7]}")

    def __call__(self, x, y, alive, keys, player_sched=None,
                 m_true=None) -> "BatchedClassifyResult":
        self.check(x, y)
        B, k = self.signature[3][:2]
        state = init_state(x, y, keys, self.cfg, alive=alive,
                           t_buf=self.t_buf, cls=self.cls,
                           device=self.device)
        sched = (self.sched if player_sched is None else
                 canon_player_sched(player_sched, B, k,
                                    device=self.device))
        return _run_to_end(x, y, alive, sched, state, self.cfg, self.cls,
                           m_true)


def lower_classify(x, y, alive, keys, cfg: BoostConfig, cls,
                   device=None) -> ClassifyProgram:
    """The bucket program of one input signature (the reference's
    ``lower_classify``; ``alive`` and ``keys`` are taken for the
    reference's call form and fix nothing here).  A ``compile`` span
    covers the build."""
    with obs_trace.span("compile", "compile", engine="batched",
                        B=int(x.shape[0]), mloc=int(x.shape[2])):
        return ClassifyProgram(x, y, cfg, cls, device=device)


def _run_to_end(x, y, alive, sched, state: StepState, cfg: BoostConfig,
                cls, m_true) -> "BatchedClassifyResult":
    """Rounds to completion under a ``run_rounds`` span, then
    :func:`finalize`."""
    dev = state.hits.device
    xt, yt = as_tensor(x, dev), as_tensor(y, dev)
    with obs_trace.span("run_rounds", "engine", engine="batched",
                        B=int(xt.shape[0]), n=-1):
        state, steps = _run_steps(xt, yt, sched, state, None, cfg, cls)
        obs_trace.sync_if_tracing(dev)
    alive0 = np.ones(tuple(xt.shape[:3]), bool) if alive is None else alive
    return finalize(state, x, y, alive0, cfg, cls, m_true=m_true,
                    steps=steps)


def run_accurately_classify_batched(x, y, keys, cfg: BoostConfig, cls,
                                    alive=None, m_true=None,
                                    player_sched=None, device=None,
                                    compiled: ClassifyProgram | None = None,
                                    ) -> BatchedClassifyResult:
    """B-task AccuratelyClassify to completion on ``device`` (default
    ``cuda``; raises when CUDA is absent unless ``device="cpu"``).

    x, y: [B, k, mloc] int32 shards or [B, k, mloc, F] float32 feature
    rows, and int8 labels (numpy or tensors); ``keys``: [B, 2] task
    key words, or one key [2] to split into B (as the reference takes
    one key or B); ``alive`` optional initial mask; ``m_true`` optional [B]
    true sample sizes (padded buckets); ``player_sched`` an optional
    player-alive schedule (see :func:`canon_player_sched`);
    ``compiled`` a :func:`lower_classify` program of this signature
    (the serving cache passes it; any other signature raises), which
    also fixes the device.
    """
    if compiled is not None:
        if (cfg, cls) != (compiled.cfg, compiled.cls):
            raise ValueError("cfg or cls differs from the program's")
        if device is not None and resolve_device(device) != compiled.device:
            raise ValueError(f"device {device} is not the program's "
                             f"{compiled.device}")
        return compiled(x, y, alive, keys, player_sched=player_sched,
                        m_true=m_true)
    state = init_state(x, y, keys, cfg, alive=alive, cls=cls, device=device)
    dev = state.hits.device
    sched = canon_player_sched(player_sched, state.hits.shape[0],
                               state.hits.shape[1], device=dev)
    return _run_to_end(x, y, alive, sched, state, cfg, cls, m_true)
