"""Process-group-sharded batched AccuratelyClassify — the k players as
ranks of a ``torch.distributed`` group (counterpart of
repro.core.sharded_batched).

Each rank holds kloc = k/p players of every task (rank r the players
r·kloc …), and the round's k → center messages are real collectives:
the coreset x, coreset y and weight sums are ``all_gather``-ed, so are
the per-player histograms (and votes) of the distributed tree growers,
the alive-example count is an ``all_reduce``, and the §2.2 no-center
variant broadcasts the acting center's hypothesis with an
``all_reduce`` of its value and literal zeros.  The round body and the
step are the batched engine's own (``core/boost_attempt.py``,
``core/batched.py``): :class:`PlayersGroup` is the wire they take, in
place of the identity.  Every collective goes through it and is
counted there by kind, so a run can be held to
``ledger.collective_sites_per_round``.

The protocol outputs equal the batched engine's bit for bit on any
group size: the per-player steps touch only local rows, the gathers
reassemble the pooled arrays in player order, and every float sums in
the same order.  Beside the protocol state the engine keeps the
reference's wire counters — coreset examples, weight-sum scalars,
histogram scalars and vote proposals gathered per attempt, collective
bytes, quarantine messages — masked by the player schedule, and
:meth:`ShardedClassifyResult.validate_ledger` holds Theorem 4.1's
accounting to them.

On the card the group is one NCCL rank over an in-process
``HashStore`` (no port, file or network): the collectives run over a
group of one, as the reference's runs over a 1-device mesh.  On the
CPU it is gloo: the backend follows the device, always.  Under
``torchrun`` (or any process that initialised ``torch.distributed``
itself) :func:`make_players_group` takes that world instead, and each
rank of an NCCL world runs on ``cuda:LOCAL_RANK`` (:func:`rank_device`).
State crosses the API as global [B, k, …] arrays on every rank:
:func:`run_rounds_sharded` takes each rank's players out and gathers
them back at the end, as the reference's ``shard_map`` partitions and
assembles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import msgpack_ckpt
from repro_torch.core import batched, boost_attempt, prng
from repro_torch.core import ledger as L
from repro_torch.core.types import BoostConfig
from repro_torch.device import resolve_device
from repro_torch.obs import trace as obs_trace

# per-player state fields: each rank holds its own players' rows
SHARDED_FIELDS = ("alive", "disputed", "hits", "wsum", "wsum_shift")
# the wire counters beside batched.StepState's fields (int32)
WIRE_FIELDS = ("awire_core", "awire_ws", "hist_wire_core", "hist_wire_ws",
               "wire_bytes", "wire_q_points", "wire_q_counts",
               "awire_hist", "awire_votes", "hist_wire_hist",
               "hist_wire_votes")
STATE_DTYPES = dict(batched.STATE_DTYPES, **dict.fromkeys(WIRE_FIELDS,
                                                          "int32"))
_PER_ATTEMPT = ("hist_wire_core", "hist_wire_ws", "hist_wire_hist",
                "hist_wire_votes")
_WS_BYTES = 4                      # a float32 weight sum on the wire

# -- checkpoint identity: the batched StepState's leaves (same names,
# same dtypes, key words uint32 on disk) plus the wire counters
STATE_TREEDEF = "repro_torch.core.sharded_batched.state"


def _unflatten_state(leaves: dict, device) -> dict:
    missing = set(STATE_DTYPES) - set(leaves)
    if missing:
        raise KeyError(f"checkpoint missing sharded-state leaves: "
                       f"{sorted(missing)}")
    batched.check_state_dtypes(leaves, STATE_DTYPES, "sharded state")
    return {f: batched.state_leaf_tensor(f, v, device)
            for f, v in leaves.items()}


msgpack_ckpt.register_treedef(STATE_TREEDEF, _unflatten_state,
                              dict.fromkeys(batched.KEY_FIELDS, "uint32"))


class PlayersGroup(boost_attempt.Wire):
    """The wire of a ``torch.distributed`` group: rank ``rank`` of
    ``size`` holds players [rank·kloc, (rank+1)·kloc).  ``calls``
    counts a run's collectives by kind."""

    def __init__(self, group, k: int, device: torch.device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.kloc = players_per_rank(k, self.size)
        self.device = device
        self.backend = dist.get_backend(group)
        super().__init__()

    def local(self, t: torch.Tensor) -> torch.Tensor:
        lo = self.rank * self.kloc
        return t[:, lo:lo + self.kloc]

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if self.size == 1:
            parts = [torch.empty_like(t)]
        else:
            parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return parts[0] if self.size == 1 else torch.cat(parts, dim=1)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        self.calls["all_gather"] += 1
        return self._all_gather(t)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        self.calls["psum"] += 1
        out = t.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def assemble(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's players of a per-player [B, kloc, …] array back
        to [B, k, …] (the state's way out, not a round's collective)."""
        return self._all_gather(t)


class FoldInKeys(PlayersGroup):
    """The single-attempt sharded form's wire over ``group``'s ranks:
    one player per rank, keyed ``fold_in(kc, player)``."""

    def __init__(self, group: PlayersGroup):
        super().__init__(group.group, group.size, group.device)

    def player_keys(self, kc: torch.Tensor, kloc: int) -> torch.Tensor:
        lo = self.rank * kloc
        return torch.stack([prng.fold_in(kc, lo + i) for i in range(kloc)],
                           dim=1)


def players_per_rank(k: int, p: int) -> int:
    """kloc = k/p; refuses a group size that does not divide k."""
    if p < 1 or k % p:
        raise ValueError(f"a players group of {p} ranks must divide "
                         f"k={k}")
    return k // p


def rank_device(device=None) -> torch.device:
    """This process's device in the players group: ``device`` (default
    ``cuda``), made the current CUDA device.  A bare ``cuda`` in an
    initialised world of more than one rank is ``cuda:LOCAL_RANK``, as
    ``torchrun`` sets it; without ``LOCAL_RANK`` it raises rather than
    put every rank on one card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            local = os.environ.get("LOCAL_RANK")
            if local is None:
                raise RuntimeError(
                    f"rank {dist.get_rank()} of a {dist.get_world_size()}-"
                    f"rank world has no device: set LOCAL_RANK (torchrun "
                    f"does) or pass device='cuda:<i>'")
            dev = torch.device("cuda", int(local))
        else:
            dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def make_players_group(k: int, device=None):
    """The players group of k players on ``device`` (default ``cuda``;
    see :func:`rank_device`).  The backend follows the device: NCCL on
    the card, gloo on the CPU.

    Where ``torch.distributed`` is already initialised (``torchrun``),
    its world is the group, and a world of the other backend is
    refused.  Otherwise this makes a 1-rank group over an in-process
    ``HashStore`` and destroys it on exit, so no group outlives the
    block.  Raises when the world size does not divide k; an NCCL group
    that cannot form fails with NCCL's error.
    """
    dev = rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    owned = not dist.is_initialized()
    if owned:
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    elif dist.get_backend() != backend:
        raise ValueError(f"the initialised world runs "
                         f"{dist.get_backend()}; a players group on {dev} "
                         f"needs {backend}")
    try:
        group = PlayersGroup(None, k, dev)
        # form the communicator now, outside any timed run
        dist.all_reduce(torch.zeros(1, device=dev))
        yield group
    finally:
        if owned:
            dist.destroy_process_group()


def init_state_sharded(x, y, keys, cfg: BoostConfig, alive=None,
                       t_buf: int | None = None, cls=None,
                       device=None) -> dict:
    """Fresh sharded-engine state: ``batched.init_state``'s fields
    (built by it, so the layouts cannot drift) as a dict of global
    [B, …] tensors, plus the int32 [B] / [B, A] wire counters only this
    engine keeps.  Same inputs as ``batched.init_state``."""
    state = batched.init_state(x, y, keys, cfg, alive=alive, t_buf=t_buf,
                               cls=cls, device=device)._asdict()
    dev = state["hits"].device
    B, a_max = state["attempt"].shape[0], cfg.opt_budget + 1
    for f in WIRE_FIELDS:
        shape = (B, a_max) if f in _PER_ATTEMPT else (B,)
        state[f] = torch.zeros(shape, dtype=torch.int32, device=dev)
    return state


def _one_step_sharded(cfg: BoostConfig, cls, no_center: bool,
                      group: PlayersGroup, x, y, x_orders, y_sorted, sched,
                      s: dict) -> dict:
    """ONE wire round of every task on this rank's players: the batched
    step over the group's wire, then the wire counters.  They follow
    the reference's masked formulas: what the round's alive players
    sent (coreset mode: k_alive coresets and weight sums; a distributed
    mode: k_alive histograms, votes and sums, the coresets only on a
    stuck round)."""
    proto = batched.StepState(**{f: s[f] for f in batched.StepState._fields})
    nxt, info = batched._one_step(cfg, cls, x, y, x_orders, y_sorted, sched,
                                  proto, wire=group, no_center=no_center)
    k = x.shape[1] * group.size
    c = cfg.coreset_size
    core = nxt.core_x[0]
    core_pp = (core.numel() // k * core.element_size()
               + nxt.core_y[0].numel() // k * nxt.core_y.element_size())
    k_alive, stuck = info.k_alive, info.stuck
    zero = torch.zeros_like(k_alive)
    if L.tree_comm_mode(cls) == "coreset":
        n_examples = k_alive * c
        n_bytes = k_alive * (core_pp + _WS_BYTES)
        n_hist = n_votes = zero
    else:
        hist_pp = L.hist_scalars_per_player(cls)
        vote_pp = L.vote_entries_per_player(cls)
        n_examples = torch.where(stuck, k_alive * c, zero)
        n_hist = k_alive * hist_pp
        n_votes = k_alive * vote_pp
        n_bytes = (torch.where(stuck, k_alive * core_pp, zero)
                   + k_alive * (_WS_BYTES + 4 * hist_pp + 4 * vote_pp))
    a_idx = s["attempt"].clamp(max=cfg.opt_budget).long()
    # this attempt's running payloads (reset at its start) ...
    awire_core = torch.where(info.start, zero, s["awire_core"]) + n_examples
    awire_ws = torch.where(info.start, zero, s["awire_ws"]) + k_alive
    awire_hist = torch.where(info.start, zero, s["awire_hist"]) + n_hist
    awire_votes = torch.where(info.start, zero, s["awire_votes"]) + n_votes
    # ... go to the attempt's slot when it ends (written once, so adding
    # into the zero slot sets it)
    slot = torch.nn.functional.one_hot(
        a_idx, cfg.opt_budget + 1).to(torch.int32) * info.ended[:, None]
    new = dict(
        nxt._asdict(),
        awire_core=awire_core, awire_ws=awire_ws, awire_hist=awire_hist,
        awire_votes=awire_votes,
        hist_wire_core=s["hist_wire_core"] + slot * awire_core[:, None],
        hist_wire_ws=s["hist_wire_ws"] + slot * awire_ws[:, None],
        hist_wire_hist=s["hist_wire_hist"] + slot * awire_hist[:, None],
        hist_wire_votes=s["hist_wire_votes"] + slot * awire_votes[:, None],
        wire_bytes=s["wire_bytes"] + n_bytes,
        wire_q_points=s["wire_q_points"] + k_alive * info.p_count,
        wire_q_counts=s["wire_q_counts"] + k_alive * info.p_count)
    act = info.active
    for f in WIRE_FIELDS:
        new[f] = torch.where(act.reshape((-1,) + (1,) * (new[f].ndim - 1)),
                             new[f], s[f])
    return new


def _local_state(group: PlayersGroup, state: dict, dev) -> dict:
    return {f: group.local(v.to(dev)).contiguous() if f in SHARDED_FIELDS
            else v.to(dev) for f, v in state.items()}


def _run_steps_sharded(group: PlayersGroup, x, y, sched, s: dict,
                       n: int | None, cfg: BoostConfig, cls,
                       no_center: bool) -> tuple[dict, int]:
    """Advance every active task by up to ``n`` rounds; returns the
    state and the steps taken (``batched._run_steps``'s contract)."""
    a_max = cfg.opt_budget + 1
    x_orders, y_sorted = boost_attempt.sorted_views(cfg, x, y)
    steps = 0
    while (n is None or steps < n) and bool(
            (~s["done"] & (s["attempt"] < a_max)).any()):
        s = _one_step_sharded(cfg, cls, no_center, group, x, y, x_orders,
                              y_sorted, sched, s)
        steps += 1
    return s, steps


@contextlib.contextmanager
def _group_for(group, k: int, device):
    if group is not None:
        players_per_rank(k, group.size)
        yield group
    else:
        with make_players_group(k, device) as g:
            yield g


def run_rounds_sharded(state: dict, x, y, cfg: BoostConfig, cls,
                       group: PlayersGroup | None = None,
                       n: int | None = None, player_sched=None,
                       no_center: bool = False) -> dict:
    """Advance the sharded protocol by up to ``n`` wire rounds (None =
    to completion); the process-group twin of ``batched.run_rounds``.

    ``state``: the global dict of :func:`init_state_sharded` (or of
    ``convert.from_jax_sharded``); ``x``/``y``: the same global
    [B, k, mloc(, F)] / [B, k, mloc] arrays; ``group``: a
    :class:`PlayersGroup` (default: :func:`make_players_group` on the
    state's device for this call); ``player_sched``: [R, k] / [B, R, k]
    bool; ``no_center``: the §2.2 model.  Returns the advanced global
    dict; any slicing gives the batched engine's protocol fields."""
    dev = state["hits"].device if group is None else group.device
    with _group_for(group, cfg.k, dev) as g:
        return _rounds(g, state, x, y, cfg, cls, n, player_sched,
                       no_center)[0]


def _rounds(g: PlayersGroup, state: dict, x, y, cfg: BoostConfig, cls,
            n, player_sched, no_center: bool) -> tuple[dict, int]:
    """The rounds of one call under a ``run_rounds`` span."""
    B = int(state["attempt"].shape[0])
    with obs_trace.span("run_rounds", "engine", engine="sharded", B=B,
                        n=-1 if n is None else int(n),
                        mesh_devices=g.size):
        out = _rounds_body(g, state, x, y, cfg, cls, n, player_sched,
                           no_center)
        obs_trace.sync_if_tracing(g.device)
    return out


def _rounds_body(g: PlayersGroup, state: dict, x, y, cfg: BoostConfig,
                 cls, n, player_sched, no_center: bool) -> tuple[dict, int]:
    dev = g.device
    x, y = batched.as_tensor(x, dev), batched.as_tensor(y, dev)
    B, k = x.shape[:2]
    sched = batched.canon_player_sched(player_sched, B, k, device=dev)
    s, steps = _run_steps_sharded(g, g.local(x).contiguous(),
                                  g.local(y).contiguous(), sched,
                                  _local_state(g, state, dev), n, cfg, cls,
                                  no_center)
    return {f: g.assemble(v) if f in SHARDED_FIELDS else v
            for f, v in s.items()}, steps


@dataclasses.dataclass
class ShardedClassifyResult(batched.BatchedClassifyResult):
    """BatchedClassifyResult + what the collectives moved.

    ``per_task``, ``classifier`` and ``ledger`` are inherited (the
    protocol state equals the batched engine's); the wire fields record
    the payloads, ``collective_calls`` the collectives of the run by
    kind (``steps`` × ``ledger.collective_sites_per_round``)."""

    hist_wire_core: np.ndarray = None   # [B, A] coreset examples gathered
    hist_wire_ws: np.ndarray = None     # [B, A] weight-sum scalars gathered
    wire_bytes: np.ndarray = None       # [B] bytes of the payloads
    wire_q_points: np.ndarray = None    # [B] quarantine point messages
    wire_q_counts: np.ndarray = None    # [B] quarantine count reports
    hist_wire_hist: np.ndarray = None   # [B, A] histogram scalars merged
    hist_wire_votes: np.ndarray = None  # [B, A] vote proposals exchanged
    mesh_devices: int = 1
    backend: str = ""
    collective_calls: dict = None

    def wire_summary(self, b: int) -> dict:
        return {
            "coreset_examples": int(self.hist_wire_core[b].sum()),
            "weight_sum_scalars": int(self.hist_wire_ws[b].sum()),
            "histogram_scalars": int(self.hist_wire_hist[b].sum()),
            "vote_proposals": int(self.hist_wire_votes[b].sum()),
            "collective_bytes": int(self.wire_bytes[b]),
            "quarantine_point_msgs": int(self.wire_q_points[b]),
            "quarantine_count_msgs": int(self.wire_q_counts[b]),
            "mesh_devices": int(self.mesh_devices),
        }

    def validate_ledger(self, b: int) -> dict:
        """Hold task b's Theorem 4.1 ledger to the measured payloads
        (player-mask-aware) and return the comparison; any mismatch
        raises AssertionError (a raise, not an ``assert``: the check
        holds under ``python -O`` too):

        * ledger coreset bits == gathered examples × example_bits(n);
        * ledger weight-sum, histogram and vote bits == the scalars
          gathered in each attempt × that attempt's bit widths;
        * per attempt, the payload is the protocol's message pattern:
          Σ_rounds k_alive coresets (coreset mode) or the stuck round's
          only (distributed modes), Σ_rounds k_alive sums, histograms
          and votes;
        * quarantine messages == Σ_stuck k_alive(stuck round) · P.
        """
        cfg, cls = self.cfg, self.cls
        n = L.domain_size(cls)
        mode = L.tree_comm_mode(cls)
        hist_pp = L.hist_scalars_per_player(cls)
        vote_pp = L.vote_entries_per_player(cls)
        led = self.ledger(b)
        n_att = int(self.attempts[b])
        got_core = int(self.hist_wire_core[b, :n_att].sum())
        got_ws = int(self.hist_wire_ws[b, :n_att].sum())
        exp_ws_bits = exp_hist_bits = exp_vote_bits = exp_q = 0
        for a in range(n_att):
            pl_rounds = int(self.hist_players[b, a])
            pl_last = int(self.hist_players_last[b, a])
            stuck = bool(self.hist_stuck[b, a])
            if mode == "coreset":
                want_core = pl_rounds * cfg.coreset_size
            else:
                want_core = pl_last * cfg.coreset_size if stuck else 0
            got = tuple(int(h[b, a]) for h in (
                self.hist_wire_core, self.hist_wire_ws, self.hist_wire_hist,
                self.hist_wire_votes))
            want = (want_core, pl_rounds, pl_rounds * hist_pp,
                    pl_rounds * vote_pp)
            _expect(got == want, f"task {b} attempt {a}: gathered "
                    f"(examples, sums, histogram scalars, votes) {got}, "
                    f"the message pattern gives {want}")
            m_a = max(int(self.hist_alive[b, a]), 2)
            T_a = cfg.num_rounds(m_a)
            exp_ws_bits += int(self.hist_wire_ws[b, a]) \
                * L.weight_sum_bits(m_a, T_a)
            exp_hist_bits += int(self.hist_wire_hist[b, a]) \
                * L.histogram_cell_bits(m_a, T_a)
            if vote_pp:
                exp_vote_bits += int(self.hist_wire_votes[b, a]) \
                    * L.vote_entry_bits(cls, m_a, T_a)
            if stuck:
                exp_q += pl_last * int(self.hist_p[b, a])
        got = (led.bits_coresets, led.bits_weight_sums,
               led.bits_histograms, led.bits_votes,
               int(self.wire_q_points[b]), int(self.wire_q_counts[b]))
        want = (got_core * L.example_bits(n), exp_ws_bits, exp_hist_bits,
                exp_vote_bits, exp_q, exp_q)
        _expect(got == want, f"task {b}: ledger (coreset, weight-sum, "
                f"histogram, vote bits) and quarantine messages {got}, "
                f"the measured payloads give {want}")
        return {
            "bits_coresets": led.bits_coresets,
            "coreset_examples_gathered": got_core,
            "bits_weight_sums": led.bits_weight_sums,
            "weight_sum_scalars_gathered": got_ws,
            "bits_histograms": led.bits_histograms,
            "histogram_scalars_merged": int(
                self.hist_wire_hist[b, :n_att].sum()),
            "bits_votes": led.bits_votes,
            "vote_proposals_exchanged": int(
                self.hist_wire_votes[b, :n_att].sum()),
            "quarantine_msgs": int(self.wire_q_points[b]),
            "collective_bytes": int(self.wire_bytes[b]),
        }


def _expect(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def finalize_sharded(state: dict, x, y, alive0, cfg: BoostConfig, cls,
                     m_true=None, group: PlayersGroup | None = None,
                     steps: int = 0,
                     collective_calls: dict | None = None,
                     ) -> ShardedClassifyResult:
    """A host :class:`ShardedClassifyResult` from stepped global state
    (``batched.finalize``'s fields plus the wire counters; no protocol
    math)."""
    proto = batched.StepState(**{f: state[f]
                                 for f in batched.StepState._fields})
    with obs_trace.span("finalize", "engine", engine="sharded"):
        base = batched.host_result(proto, x, y, alive0, cfg, cls,
                                   m_true=m_true, steps=steps)
        wire = {f: batched._host(state[f]) for f in WIRE_FIELDS
                if not f.startswith("awire_")}
    return ShardedClassifyResult(
        **{f.name: getattr(base, f.name)
           for f in dataclasses.fields(batched.BatchedClassifyResult)},
        **wire, mesh_devices=1 if group is None else group.size,
        backend="" if group is None else group.backend,
        collective_calls=collective_calls)


class ShardedClassifyProgram(batched.ClassifyProgram):
    """The sharded engine bound to one input signature
    (``batched.signature``) and one :class:`PlayersGroup` — the
    counterpart of the reference's ``lower_classify_sharded``
    executable: ``batched.ClassifyProgram``'s per-shape work on this
    rank's kloc players; another signature or group raises."""

    def __init__(self, x, y, cfg: BoostConfig, cls, group: PlayersGroup,
                 no_center: bool = False):
        players_per_rank(cfg.k, group.size)
        self.group, self.no_center = group, no_center
        super().__init__(x, y, cfg, cls, device=group.device,
                         kloc=group.kloc)

    def __call__(self, x, y, alive, keys, player_sched=None,
                 m_true=None) -> "ShardedClassifyResult":
        self.check(x, y)
        return _run_to_end(self.group, x, y, keys, self.cfg, self.cls,
                           alive, self.no_center, m_true, player_sched,
                           self.t_buf)


def lower_classify_sharded(x, y, alive, keys, cfg: BoostConfig, cls,
                           group: PlayersGroup, no_center: bool = False,
                           ) -> ShardedClassifyProgram:
    """The sharded bucket program of one signature over ``group`` (the
    reference's ``lower_classify_sharded``; ``alive`` and ``keys`` fix
    nothing here), its build under a ``compile`` span."""
    with obs_trace.span("compile", "compile", engine="sharded",
                        B=int(x.shape[0]), mloc=int(x.shape[2])):
        return ShardedClassifyProgram(x, y, cfg, cls, group,
                                      no_center=no_center)


def _run_to_end(g: PlayersGroup, x, y, keys, cfg: BoostConfig, cls, alive,
                no_center: bool, m_true, player_sched,
                t_buf: int | None = None) -> "ShardedClassifyResult":
    state = init_state_sharded(x, y, keys, cfg, alive=alive, t_buf=t_buf,
                               cls=cls, device=g.device)
    if state["hits"].shape[1] != cfg.k:
        raise ValueError(f"x has {state['hits'].shape[1]} players but "
                         f"cfg.k={cfg.k}")
    g.calls = dict.fromkeys(g.calls, 0)
    state, steps = _rounds(g, state, x, y, cfg, cls, None, player_sched,
                           no_center)
    B, k, mloc = state["hits"].shape
    alive0 = np.ones((B, k, mloc), bool) if alive is None else alive
    return finalize_sharded(state, x, y, alive0, cfg, cls, m_true=m_true,
                            group=g, steps=steps,
                            collective_calls=dict(g.calls))


def run_accurately_classify_sharded(x, y, keys, cfg: BoostConfig, cls,
                                    group: PlayersGroup | None = None,
                                    alive=None, no_center: bool = False,
                                    m_true=None, player_sched=None,
                                    device=None,
                                    compiled: ShardedClassifyProgram
                                    | None = None,
                                    ) -> ShardedClassifyResult:
    """B-task AccuratelyClassify over a players group (default: a
    1-rank group on ``device``, ``cuda`` unless ``device="cpu"``).

    Same contract as ``batched.run_accurately_classify_batched`` — and
    the same protocol outputs on the same inputs and schedule — plus
    the wire counters, the group size, its backend, and the run's
    collective calls by kind.  ``compiled``: a
    :func:`lower_classify_sharded` program of this signature, which
    also fixes the group.
    """
    if compiled is not None:
        if (cfg, cls, no_center) != (compiled.cfg, compiled.cls,
                                     compiled.no_center):
            raise ValueError("cfg, cls or no_center differs from the "
                             "program's")
        if group is not None and group is not compiled.group:
            raise ValueError("a sharded bucket program was called with "
                             "another players group than it is bound to")
        return compiled(x, y, alive, keys, player_sched=player_sched,
                        m_true=m_true)
    with _group_for(group, cfg.k, device) as g:
        return _run_to_end(g, x, y, keys, cfg, cls, alive, no_center,
                           m_true, player_sched)
