"""Depth-d axis-aligned decision trees grown by weighted histograms
(counterpart of repro.weak_tree.trees).

A depth-d tree is complete: ``nodes = 2^d − 1`` internal nodes in level
order and ``leaves = 2^d``, encoded as one float32 vector

    params = [type=5 | feat_0..feat_{NI−1} | qbin_0..qbin_{NI−1}
              | sign_0..sign_{NL−1}]           (param_dim = 1+2·NI+NL)

Node j routes a point right iff ``bin(x[feat_j]) ≥ qbin_j`` on the
fixed [0, 1) grid of ``kernels/histogram/ref.py``; ``predict`` evaluates
the same comparison the grower optimised.  Growth is greedy and level
by level: one histogram launch per level (:mod:`repro_torch.kernels.
histogram`), reduced to the best (feature, bin) split of every node.

Where the reference ``vmap``s over tasks, the port writes the task
axis out: ``erm(xs [B, K, F], ys [B, K], w [B, K])`` and
``erm_players(cx [B, k, c, F], cy [B, k, c], pw [B, k])`` return
``(params [B, P], loss [B])``.  Every float that decides a split or a
leaf follows the reference's rounding order: the histograms (see
``ref.py``), the leaf sums (windows of 32, :func:`fp32.sum_`), the
player-axis merges and the prefix sums over bins.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import fp32
from repro_torch.kernels.histogram import ops as H

TYPE_TREE = 5.0


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[..., idx[...]] along the last axis of v, for idx with more
    trailing axes than v has (v [*B, n], idx [*B, *pts])."""
    extra = idx.ndim - (v.ndim - 1)
    vv = v.reshape(v.shape[:-1] + (1,) * extra + v.shape[-1:])
    vv = vv.expand(idx.shape + v.shape[-1:])
    return torch.gather(vv, -1, idx[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class HistogramTrees:
    """H = depth-``depth`` axis trees over [0,1)^F on a ``bins``-bin
    grid, grown over the wire in one of three ``comm_mode``s: pooled
    coresets ("coreset"), merged per-player histograms ("histogram"),
    or LightGBM-style parallel voting ("voting").  ``chunk_size``
    accumulates every histogram over point tiles of that many points
    (the streaming tier; bitwise the monolithic histogram on dyadic
    weights)."""

    num_features: int
    depth: int = 2
    bins: int = 32
    comm_mode: str = "coreset"
    vote_topk: int = 2
    chunk_size: int | None = None

    needs_features: bool = dataclasses.field(default=True, init=False,
                                             repr=False)

    def __post_init__(self):
        if self.depth < 1:
            raise ValueError(f"depth must be ≥ 1, got {self.depth}")
        if self.bins < 2 or self.bins & (self.bins - 1):
            raise ValueError(
                f"bins must be a power of two ≥ 2, got {self.bins}")
        if self.comm_mode not in ("coreset", "histogram", "voting"):
            raise ValueError(
                f"comm_mode must be coreset|histogram|voting, "
                f"got {self.comm_mode!r}")
        if self.vote_topk < 1:
            raise ValueError(f"vote_topk must be ≥ 1, got {self.vote_topk}")
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(
                f"chunk_size must be ≥ 1, got {self.chunk_size}")

    # -- shape/bit accounting ---------------------------------------------

    @property
    def nodes(self) -> int:
        return (1 << self.depth) - 1

    @property
    def leaves(self) -> int:
        return 1 << self.depth

    @property
    def param_dim(self) -> int:
        return 1 + 2 * self.nodes + self.leaves

    @property
    def elected(self) -> int:
        """Candidate features the voting election keeps per node."""
        return min(self.num_features, 2 * self.vote_topk)

    @property
    def bin_bits(self) -> int:
        return int(math.log2(self.bins))

    @property
    def feat_bits(self) -> int:
        return max(1, math.ceil(math.log2(max(self.num_features, 2))))

    @property
    def value_bits(self) -> int:
        """A grid point is F bin ids (what a coreset example costs)."""
        return self.num_features * self.bin_bits

    @property
    def vc_dim(self) -> int:
        return self.hypothesis_bits()

    def hypothesis_bits(self) -> int:
        return (self.nodes * (self.feat_bits + self.bin_bits)
                + self.leaves)

    # -- prediction --------------------------------------------------------

    def _route(self, feat, qbin, b):
        """b [*B, *pts, F] bin ids; feat, qbin [*B, NI] → leaf [*B, *pts]."""
        node = torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device)
        for level in range(self.depth):
            flat = node + ((1 << level) - 1)
            f = _take(feat, flat)
            q = _take(qbin, flat)
            xv = torch.gather(b, -1, f[..., None])[..., 0]
            node = node * 2 + (xv >= q).long()
        return node

    def predict(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """params [*B, P], x [*B, *pts, F] → int8 ±1 [*B, *pts]."""
        ni = self.nodes
        feat = params[..., 1:1 + ni].long()
        qbin = params[..., 1 + ni:1 + 2 * ni].long()
        sign = params[..., 1 + 2 * ni:1 + 2 * ni + self.leaves]
        leaf = self._route(feat, qbin, H.bin_index(x, self.bins))
        one = torch.ones((), dtype=torch.int8, device=x.device)
        return torch.where(_take(sign, leaf) > 0, one, -one)

    # -- the weak learner --------------------------------------------------

    def _pack(self, feats, qbins, sign):
        lead = sign.shape[:-1]
        return torch.cat([torch.full(lead + (1,), TYPE_TREE,
                                     device=sign.device),
                          torch.cat(feats, -1).float(),
                          torch.cat(qbins, -1).float(), sign], dim=-1)

    @staticmethod
    def _leaf_loss(w_leaf, wy_leaf):
        sign = torch.where(wy_leaf >= 0, 1.0, -1.0)    # sign(0) := +1
        return sign, fp32.sum_(0.5 * (w_leaf - wy_leaf.abs()))

    def erm(self, xs: torch.Tensor, ys: torch.Tensor, w: torch.Tensor):
        """Greedy level-wise tree on pooled coresets: xs [B, K, F],
        ys [B, K], w [B, K] → (params [B, P], loss [B]), one histogram
        launch per level for all B tasks."""
        wy = w * ys.float()
        b = H.bin_index(xs, self.bins)
        route = torch.zeros(w.shape, dtype=torch.int64, device=w.device)
        feats, qbins = [], []
        for level in range(self.depth):
            N = 1 << level
            onnode = route[..., None] == torch.arange(N, device=w.device)
            wn = torch.where(onnode, w[..., None], 0.0).transpose(-1, -2)
            wyn = torch.where(onnode, wy[..., None], 0.0).transpose(-1, -2)
            f_n, q_n, _ = H.best_node_splits(xs, wn.contiguous(),
                                             wyn.contiguous(), self.bins,
                                             chunk_size=self.chunk_size)
            feats.append(f_n)
            qbins.append(q_n)
            xv = torch.gather(b, -1, torch.gather(f_n, -1, route)[..., None])
            route = route * 2 + (xv[..., 0]
                                 >= torch.gather(q_n, -1, route)).long()
        onleaf = route[..., None] == torch.arange(self.leaves,
                                                  device=w.device)
        # column sums over K in XLA:CPU's reduce order (windows of 32)
        w_leaf = fp32.sum_(torch.where(onleaf, w[..., None], 0.0)
                           .transpose(-1, -2))
        wy_leaf = fp32.sum_(torch.where(onleaf, wy[..., None], 0.0)
                            .transpose(-1, -2))
        sign, loss = self._leaf_loss(w_leaf, wy_leaf)
        return self._pack(feats, qbins, sign), loss

    def erm_players(self, cx: torch.Tensor, cy: torch.Tensor,
                    pw: torch.Tensor, *, all_gather=None):
        """The distributed greedy grower of the ``histogram`` and
        ``voting`` modes: cx [B, kp, c, F], cy [B, kp, c], pw [B, kp]
        the per-example weight of each of this process's players (0 for
        a dead player) → (params [B, P], loss [B]).  Each player's
        histograms come from one launch over (task, player);
        ``all_gather`` pools a [B, kp, …] per-player array to
        [B, k, …] in player order (the identity when the caller holds
        all k players, the batched and host forms; the sharded engine
        passes its collective), and the merge sums the player axis in
        order, so it does not depend on how the players are spread."""
        B, kp, c = cy.shape
        F = self.num_features
        dev = cx.device
        ag = (lambda a: a) if all_gather is None else all_gather
        w = pw[..., None].expand(B, kp, c)
        wy = w * cy.float()
        b = H.bin_index(cx, self.bins)                       # [B, kp, c, F]
        route = torch.zeros((B, kp, c), dtype=torch.int64, device=dev)
        feats, qbins = [], []
        for level in range(self.depth):
            N = 1 << level
            onnode = route[..., None] == torch.arange(N, device=dev)
            wn = torch.where(onnode, w[..., None], 0.0).transpose(-1, -2)
            wyn = torch.where(onnode, wy[..., None], 0.0).transpose(-1, -2)
            hw, hwy = H.node_histograms(cx, wn.contiguous(),
                                        wyn.contiguous(), self.bins,
                                        chunk_size=self.chunk_size)
            if self.comm_mode == "voting":
                _, err_f = H.best_splits_per_feature(hw, hwy)  # [B,kp,N,F]
                prop = torch.argsort(err_f, dim=-1,
                                     stable=True)[..., :self.vote_topk]
                votes_all = ag(prop)                           # [B,k,N,topk]
                alive_all = ag(pw > 0)                         # [B, k]
                onefeat = ((votes_all[..., None]
                            == torch.arange(F, device=dev))
                           & alive_all[:, :, None, None, None])
                votes = onefeat.sum(dim=(1, 3), dtype=torch.int64)  # [B,N,F]
                rank = votes * F + torch.arange(F - 1, -1, -1, device=dev)
                elect = torch.topk(rank, self.elected, dim=-1,
                                   sorted=True).indices          # [B, N, E]
                gidx = elect[:, None, :, :, None].expand(
                    B, kp, N, self.elected, self.bins)
                hw_m = fp32.sum_(ag(torch.gather(hw, 3, gidx)).movedim(1, -1))
                hwy_m = fp32.sum_(ag(torch.gather(hwy, 3, gidx))
                                  .movedim(1, -1))
                sel, q_n, _ = H.best_splits_ref(hw_m, hwy_m)
                f_n = torch.gather(elect, -1, sel[..., None])[..., 0]
            else:                                             # histogram
                hw_m = fp32.sum_(ag(hw).movedim(1, -1))      # [B, N, F, Q]
                hwy_m = fp32.sum_(ag(hwy).movedim(1, -1))
                f_n, q_n, _ = H.best_splits_ref(hw_m, hwy_m)
                sel = f_n
            feats.append(f_n)
            qbins.append(q_n)
            flat = route.reshape(B, kp * c)
            f_pt = torch.gather(f_n, -1, flat).reshape(B, kp, c)
            q_pt = torch.gather(q_n, -1, flat).reshape(B, kp, c)
            xv = torch.gather(b, -1, f_pt[..., None])[..., 0]
            route = route * 2 + (xv >= q_pt).long()
        # leaves from the last level's merged histograms: the chosen
        # column's prefix sums at q give each child's (w, wy)
        N = hw_m.shape[-3]
        col = sel[..., None, None].expand(B, N, 1, self.bins)
        hw_sel = torch.gather(hw_m, -2, col)[..., 0, :]        # [B, N, Q]
        hwy_sel = torch.gather(hwy_m, -2, col)[..., 0, :]
        cw = fp32.cumsum(hw_sel)
        cwy = fp32.cumsum(hwy_sel)
        left_w = torch.gather(cw - hw_sel, -1, q_n[..., None])[..., 0]
        left_wy = torch.gather(cwy - hwy_sel, -1, q_n[..., None])[..., 0]
        w_leaf = torch.stack([left_w, cw[..., -1] - left_w],
                             dim=-1).reshape(B, -1)
        wy_leaf = torch.stack([left_wy, cwy[..., -1] - left_wy],
                              dim=-1).reshape(B, -1)
        sign, loss = self._leaf_loss(w_leaf, wy_leaf)
        return self._pack(feats, qbins, sign), loss

    # -- task generation (core/tasks.py) -----------------------------------

    def sample_points(self, rng: np.random.Generator, m: int):
        """m grid-snapped uniform points of [0, 1)^F (bin centres)."""
        u = rng.random((m, self.num_features))
        return ((np.floor(u * self.bins) + 0.5)
                / self.bins).astype(np.float32)

    def sample_target(self, rng: np.random.Generator, x: np.ndarray):
        """A random tree of this class, both label classes forced
        non-empty when possible (the reference's RNG calls)."""
        feat = rng.integers(0, self.num_features, size=self.nodes)
        qbin = rng.integers(1, self.bins, size=self.nodes)
        sign = rng.choice([-1.0, 1.0], size=self.leaves)
        if np.all(sign == sign[0]):
            sign[rng.integers(self.leaves)] = -sign[0]
        return np.concatenate(
            [[TYPE_TREE], feat, qbin, sign]).astype(np.float32)

    def pack_params(self, feat, qbin, sign) -> np.ndarray:
        """Host-side encoder for planted trees."""
        feat = np.asarray(feat).reshape(self.nodes)
        qbin = np.asarray(qbin).reshape(self.nodes)
        sign = np.asarray(sign).reshape(self.leaves)
        return np.concatenate(
            [[TYPE_TREE], feat, qbin, sign]).astype(np.float32)
