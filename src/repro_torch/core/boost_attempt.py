"""BoostAttempt (Figure 1): the round body and its host form
(counterpart of repro.core.boost_attempt).

Every player picks its ε-coreset (step 2(a)) and reports its log2
weight sum (2(b)); the center mixes the sums (2(c)) and runs weighted
ERM over the pooled coreset (2(d)); a loss above 1/100 makes the round
stuck (2(e)); otherwise each player applies the multiplicative-weights
hit update (2(f)).  The round runs for B tasks at once: the task axis
the reference ``vmap``s is written out, and the players of every task
form the rows of one ``mw_update`` launch.

One round body serves the port's three execution forms.  What crosses
between players goes through a *wire*: :class:`Wire`, the identity,
where one process holds every player (the batched engine, and the host
form :func:`boost_attempt_arrays` / :func:`run_boost_attempt` at B = 1),
or the process-group collectives of ``core/sharded_batched.py``, where
each rank holds its own players (the sharded engine and
:func:`boost_attempt_sharded`).  The reference keeps one copy of the
body per form, in lockstep; here they cannot drift apart.

Each round splits the attempt's key as the reference does (``key, kc =
split(key)``, then one key per player from ``kc``); the randomized
coreset of the feature track draws from the players' keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import approximation, prng, streaming, weak
from repro_torch.core import weights as W
from repro_torch.core.ledger import tree_comm_mode
from repro_torch.core.pinned import pinned_argmax
from repro_torch.core.types import BoostAttemptResult, BoostConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.mw_update import ops as mw_ops
from repro_torch.obs import trace as obs_trace


class Wire:
    """The players' exchanges of one process that holds every player:
    each is the identity.  ``calls`` counts them by kind, as a
    process-group wire counts its collectives, so every form of the
    round can be held to ``ledger.collective_sites_per_round``."""

    rank = 0
    size = 1

    def __init__(self):
        self.calls = {"all_gather": 0, "psum": 0}

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's players of a [B, k, ...] array every rank holds."""
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """[B, kloc, ...] per rank → [B, k, ...] in player order."""
        self.calls["all_gather"] += 1
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks."""
        self.calls["psum"] += 1
        return t

    def player_keys(self, kc: torch.Tensor, kloc: int) -> torch.Tensor:
        """This rank's players' round keys [B, kloc, 2] from the round's
        key ``kc`` [B, 2]: the host loop's k-key stream, sliced."""
        return self.local(prng.split(kc, kloc * self.size))


class _Carry(NamedTuple):
    t: torch.Tensor          # [B] int32 hypotheses produced so far
    stuck: torch.Tensor      # [B] bool
    hits: torch.Tensor       # [B, k, mloc] int32 MW state
    wsum: torch.Tensor       # [B, k] float32 Σ_alive 2^(wsum_shift − hits)
    wsum_shift: torch.Tensor  # [B, k] int32 the sum's exponent shift
    h_params: torch.Tensor   # [B, T, P] ensemble
    core_x: torch.Tensor     # [B, k, c] last round's coreset points
    core_y: torch.Tensor     # [B, k, c]
    min_loss: torch.Tensor   # [B] last center ERM loss
    key: torch.Tensor        # [B, 2] the attempt's round key (words)
    core_idx: torch.Tensor | None = None  # [B, k, c] last coreset indices


def _gather_coreset(x, y, idx):
    """The coreset's points and labels, with the reference's fill for
    the out-of-range index a dead shard's sampled coreset names."""
    return (approximation.gather_fill(x, idx),
            approximation.gather_fill(y, idx))


def center_erm(cls, cx, cy, mix, c: int):
    """Pooled-coreset ERM under the mixture D_t (steps 2(c)+(d)): every
    coreset example of player i weighs mix_i / c — computed as
    mix_i · (1/c) with the reciprocal rounded to float32, the form XLA
    rewrites the reference's division by the constant c into."""
    B, k = cy.shape[:2]
    inv_c = float(np.float32(1.0) / np.float32(c))
    w = (mix[..., None] * inv_c).expand(B, k, c).reshape(B, k * c)
    return cls.erm(cx.reshape((B, k * c) + cx.shape[3:]),
                   cy.reshape(B, k * c), w)


def _round_body(cfg, cls, x, y, alive, x_orders, y_sorted, alive_sorted,
                carry: _Carry, *, player_alive: torch.Tensor,
                active: torch.Tensor, wire: Wire | None = None,
                no_center: bool = False) -> _Carry:
    """One round of B tasks over this process's players: x [B, kloc,
    mloc] int32 points or [B, kloc, mloc, F] float32 feature rows; y,
    alive [B, kloc, mloc]; ``player_alive`` [B, k] the round's senders;
    ``active`` [B] the lanes whose MW state may move (finished lanes
    freeze).  The sorted views (``x_orders`` …) serve the quantile
    coreset and are None on the randomized track.  ``wire`` carries
    the players' exchanges (default: :class:`Wire`, every player here);
    ``no_center`` is the §2.2 model, where the first alive player acts
    as center and broadcasts its ERM result (a sum of its values and
    literal zeros).

    Steps 2(f) and 2(b) run as one ``mw_update`` over all B·kloc player
    rows.  Its mask folds in the reference's three freezes — a stuck
    round, an absent player, a finished lane — so the new hits equal
    the reference's bit for bit, and the weight sum it returns is the
    next round's step 2(b) (alive changes only at quarantine, which
    ends the attempt, so the carried sum is never stale).  The sum is
    shifted by this round's least alive hit count, as the reference
    shifts by the row maximum of −hits, so its terms stay normal floats
    however many rounds a run takes.
    """
    wire = Wire() if wire is None else wire
    c = cfg.coreset_size
    B, kloc, mloc = x.shape[:3]
    halves = prng.split(carry.key, 2)
    key, keys = halves[:, 0], wire.player_keys(halves[:, 1], kloc)
    senders = wire.local(player_alive)                            # [B, kloc]
    # --- players: step 2(a) coreset + step 2(b) weight sums -------------
    hmin = W.least_alive_hits(carry.hits, alive)                 # [B, kloc]
    lws = W.log_wsums_from_sums(carry.wsum, hmin, carry.wsum_shift)
    idx = approximation.select_coreset(
        x, y, carry.hits, alive, c, is_quantile_track(cfg, x),
        order=x_orders, y_sorted=y_sorted, alive_sorted=alive_sorted,
        hmin=hmin, keys=keys, log_wsum=lws)
    cx, cy = _gather_coreset(x, y, idx)
    # an absent player sends nothing: −inf ⇒ mixture weight 0
    log_wsums = torch.where(senders, lws, -math.inf)
    # --- the wire: every player's coreset and weight sum ----------------
    cx_all, cy_all = wire.gather(cx), wire.gather(cy)
    mix = W.mixture_weights(wire.gather(log_wsums))
    # --- center: step 2(c)+(d) weighted ERM -----------------------------
    if tree_comm_mode(cls) != "coreset":
        # the distributed growers merge per-player histograms (and
        # votes) over the wire; every rank computes the merged answer.
        # The reference's engines keep the true division mix / c here.
        h, loss = cls.erm_players(cx, cy, wire.local(mix) / float(c),
                                  all_gather=wire.gather)
    else:
        h, loss = center_erm(cls, cx_all, cy_all, mix, c)
        if no_center:
            mine = pinned_argmax(player_alive) // kloc == wire.rank   # [B]
            h = wire.psum(torch.where(mine[:, None], h, 0.0))
            loss = wire.psum(torch.where(mine, loss, 0.0))
    stuck_now = loss > cfg.weak_threshold
    # --- players: step 2(f) multiplicative-weights update ---------------
    moves = (~stuck_now & active)[:, None, None] & senders[:, :, None]
    correct = (cls.predict(h, x) == y) & moves
    hits, wsum = mw_ops.mw_update(carry.hits.reshape(B * kloc, mloc),
                                  correct.reshape(B * kloc, mloc),
                                  alive.reshape(B * kloc, mloc),
                                  hmin.reshape(B * kloc))
    rows = torch.arange(B, device=x.device)
    t_idx = carry.t.clamp(max=carry.h_params.shape[1] - 1).long()
    h_params = carry.h_params.clone()
    h_params[rows, t_idx] = torch.where(stuck_now[:, None],
                                        carry.h_params[rows, t_idx], h)
    return _Carry(
        t=torch.where(stuck_now, carry.t, carry.t + 1),
        stuck=stuck_now,
        hits=hits.reshape(B, kloc, mloc),
        wsum=wsum.reshape(B, kloc),
        wsum_shift=hmin,
        h_params=h_params,
        core_x=cx_all, core_y=cy_all,
        min_loss=loss,
        key=key,
        core_idx=idx,
    )


def start_carry(x, y, alive, key, cfg: BoostConfig, cls, num_rounds: int,
                hits0=None) -> _Carry:
    """A fresh attempt's carry for B tasks (x [B, kloc, mloc(, F)],
    key [B, 2]): hits ``hits0`` (default 0, each alive weight 1) and
    their weight sums, an empty ensemble of ``num_rounds``
    hypotheses."""
    B, kloc = x.shape[:2]
    dev = x.device
    if hits0 is None:
        hits = torch.zeros(alive.shape, dtype=torch.int32, device=dev)
        wsum = alive.sum(dim=-1).float()
        shift = torch.zeros((B, kloc), dtype=torch.int32, device=dev)
    else:
        hits = hits0
        wsum, shift = W.wsums_from_hits(hits, alive)
    c = cfg.coreset_size
    return _Carry(
        t=torch.zeros(B, dtype=torch.int32, device=dev),
        stuck=torch.zeros(B, dtype=torch.bool, device=dev),
        hits=hits, wsum=wsum, wsum_shift=shift,
        h_params=torch.zeros((B, num_rounds, weak.param_dim(cls)),
                             dtype=torch.float32, device=dev),
        core_x=torch.zeros((B, kloc, c) + tuple(x.shape[3:]),
                           dtype=x.dtype, device=dev),
        core_y=torch.zeros((B, kloc, c), dtype=y.dtype, device=dev),
        min_loss=torch.zeros(B, dtype=torch.float32, device=dev),
        key=key,
        core_idx=torch.zeros((B, kloc, c), dtype=torch.int64, device=dev))


def prepare_kernels(cfg: BoostConfig, cls, B: int, kloc: int, k: int,
                    mloc: int, device: torch.device) -> dict:
    """The per-shape work of the round body's kernels for one bucket of
    B tasks (kloc of k players here, mloc examples each), done once
    ahead of its runs: a tree class's histogram plans for every level
    (``kernel.plan`` or ``chunk_plan``, memoized, so a launch on the
    card finds its plan made; a shape the kernel does not take raises
    here), and on the card the kernel libraries loaded and the
    mw_update workspace sized for B·kloc rows on the current stream.
    Returns the histogram plans, one per tree level (none for the
    other classes)."""
    from repro_torch.kernels.histogram import kernel as hist_kernel
    from repro_torch.weak_tree import HistogramTrees

    plans = ()
    if isinstance(cls, HistogramTrees):
        c = cfg.coreset_size
        # the center's pooled coreset, or each player's (distributed)
        G, pts = ((B, k * c) if cls.comm_mode == "coreset"
                  else (B * kloc, c))
        chunk = cls.chunk_size
        plans = tuple(
            hist_kernel.chunk_plan(G, pts, chunk, cls.bins)
            if chunk is not None and chunk < pts else
            hist_kernel.plan(G, 1 << level, pts, cls.num_features,
                             cls.bins)
            for level in range(cls.depth))
    if device.type == "cuda":
        from repro_torch.kernels.mw_update import kernel as mw_kernel

        lib = mw_kernel.library()
        mw_kernel.workspace(B * kloc, lib.mw_update_tiles(mloc), device,
                            torch.cuda.current_stream(device))
        if plans:
            hist_kernel.library()
    return plans


def sorted_views(cfg: BoostConfig, x, y):
    """The loop-invariant per-player sort order of the quantile coreset
    and y in that order, hoisted out of the round loop (None, None on
    the randomized track)."""
    if not is_quantile_track(cfg, x):
        return None, None
    x_orders = streaming.sort_order(x, cfg.chunk_size, cfg.domain_size)
    return x_orders, torch.gather(y, -1, x_orders)


def run_attempt(x, y, alive, carry: _Carry, cfg: BoostConfig, cls,
                bound: int, *, wire: Wire | None = None,
                no_center: bool = False) -> _Carry:
    """Rounds of one task (B = 1) until the attempt is stuck or holds
    ``bound`` hypotheses, the reference's ``while_loop``; returns the
    final carry.  One host sync per round."""
    x_orders, y_sorted = sorted_views(cfg, x, y)
    alive_sorted = (None if x_orders is None
                    else torch.gather(alive, -1, x_orders))
    senders = torch.ones((1, x.shape[1] * (wire.size if wire else 1)),
                         dtype=torch.bool, device=x.device)
    active = torch.ones(1, dtype=torch.bool, device=x.device)
    while not bool(carry.stuck[0] | (carry.t[0] >= bound)):
        carry = _round_body(cfg, cls, x, y, alive, x_orders, y_sorted,
                            alive_sorted, carry, player_alive=senders,
                            active=active, wire=wire, no_center=no_center)
    return carry


def boost_attempt_arrays(x, y, alive, hits0, key, cfg: BoostConfig, cls,
                         num_rounds: int, *, round_bound: int | None = None,
                         device=None) -> _Carry:
    """One BoostAttempt of one task on its [k, mloc(, F)] shards, on
    ``device`` (default ``cuda``); returns the final carry (one task:
    no leading batch axis).  ``hits0`` is the starting MW state (None =
    0, as ``run_boost_attempt`` starts); ``num_rounds`` sizes the
    ensemble buffer, and the loop stops at ``round_bound`` (default
    ``num_rounds``) hypotheses or when a round is stuck."""
    dev = resolve_device(device)
    x, y, alive = (_as_tensor(v, dev)[None] for v in (x, y, alive))
    if hits0 is not None:
        hits0 = _as_tensor(hits0, dev)[None]
    key = prng.wrap_key_data(key).to(dev)[None]
    carry = start_carry(x, y, alive, key, cfg, cls, num_rounds, hits0=hits0)
    bound = num_rounds if round_bound is None else int(round_bound)
    carry = run_attempt(x, y, alive, carry, cfg, cls, bound)
    return _Carry(*(v[0] for v in carry))


def run_boost_attempt(x, y, alive, key, cfg: BoostConfig, cls,
                      device=None) -> BoostAttemptResult:
    """Host-facing BoostAttempt on [k, mloc(, F)] shards (``alive``
    [k, mloc] bool, ``key`` [2] words), on ``device`` (default
    ``cuda``): the round bound is T = ⌈6·log2 m_alive⌉ on the host
    path, as in the reference."""
    m = int(np.asarray(alive).sum()) if not torch.is_tensor(alive) \
        else int(alive.sum())
    num_rounds = cfg.num_rounds(max(m, 2))
    with obs_trace.span("boost_attempt", "attempt", m_alive=m,
                        bound=num_rounds) as sp:
        out = boost_attempt_arrays(x, y, alive, None, key, cfg, cls,
                                   num_rounds, device=device)
        if obs_trace.enabled():
            sp.update(rounds=int(out.t), stuck=bool(out.stuck))
    return BoostAttemptResult(
        stuck=bool(out.stuck), rounds=int(out.t),
        hypotheses=out.h_params.cpu().numpy(),
        coreset_index=out.core_idx.to(torch.int32).cpu().numpy(),
        coreset_x=out.core_x.cpu().numpy(),
        coreset_y=out.core_y.cpu().numpy(),
        min_mixture_loss=float(out.min_loss))


def boost_attempt_sharded(group, cfg: BoostConfig, cls, num_rounds: int,
                          no_center: bool = False):
    """The single-attempt sharded form over a players group (one player
    per rank, as the reference's ``data`` mesh axis): returns
    ``fn(x, y, alive, hits, key) → (t, stuck, hits, h_params, loss)``.

    x/y/alive/hits are the [m_total(, F)] arrays of all players end to
    end (rank r's player holds the r-th m_total/p); ``key`` [2] words.
    Each player draws with ``fold_in(kc, rank)`` of the round key, as
    in the reference, its coreset and weight sum cross as collectives,
    and every rank returns the replicated outputs with ``hits``
    gathered back to [m_total].  ``no_center``: player 0 runs the ERM
    and broadcasts it.  ``group`` is a
    ``core.sharded_batched.PlayersGroup``; a ``FoldInKeys`` group (the
    launch tooling's recording wire) is the wire itself.
    """
    from repro_torch.core.sharded_batched import FoldInKeys

    def fn(x, y, alive, hits, key):
        wire = group if isinstance(group, FoldInKeys) else FoldInKeys(group)
        dev = group.device
        p, r = group.size, group.rank

        def mine(v):
            v = _as_tensor(v, dev)
            return v.reshape((p, -1) + tuple(v.shape[1:]))[r][None, None]

        xl, yl, al, hl = (mine(v) for v in (x, y, alive, hits))
        carry = start_carry(xl, yl, al, prng.wrap_key_data(key).to(dev)[None],
                            cfg, cls, num_rounds, hits0=hl)
        carry = run_attempt(xl, yl, al, carry, cfg, cls, num_rounds,
                            wire=wire, no_center=no_center)
        hits_all = group.assemble(carry.hits)[0].reshape(-1)
        return (carry.t[0], carry.stuck[0], hits_all, carry.h_params[0],
                carry.min_loss[0])

    return fn


def _as_tensor(v, device) -> torch.Tensor:
    if not torch.is_tensor(v):
        v = torch.from_numpy(np.array(v))
    return v.to(device)


def is_quantile_track(cfg, x: torch.Tensor) -> bool:
    """The deterministic quantile coreset serves the integer track
    ([B, k, mloc] points); feature rows always draw the randomized
    coreset, as in the reference."""
    return bool(cfg.deterministic_coreset) and x.ndim == 3
