"""Hypothesis classes and the center's weighted-ERM weak learner
(counterpart of repro.core.weak, integer track).

Each ERM enumerates every behaviour the class induces on the pooled
coreset with sorts and prefix sums, so "no hypothesis is 1/100-good"
is an exact certificate (Observation 4.3).  Where the reference
``vmap``s an ERM over tasks, the port writes the task axis out:
``erm(xs [B, K], ys [B, K], w [B, K]) → (params [B, 4], loss [B])``.

Hypotheses are float32 vectors ``(type, a, b, s)``: type 1 singleton
(+1 iff x == a), 2 threshold (s if x ≥ a else −s), 3 interval (+1 iff
a ≤ x ≤ b).  ``predict(params [*B, 4], x [*B, *pts])`` pairs each
leading params row with the matching points and returns int8 ±1 of
``x``'s shape.  The feature-track classes take feature rows: type 4
is an axis stump (s if X[f = a] ≥ b else −s), type 5 a histogram tree
(:mod:`repro_torch.weak_tree`); their ``predict(params [*B, P],
x [*B, *pts, F])`` returns ``[*B, *pts]``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import fp32
from repro_torch.core.pinned import pinned_argmax, pinned_argmin

PARAM_DIM = 4


def param_dim(cls) -> int:
    """Hypothesis-vector width of a class (PARAM_DIM when unstated)."""
    return PARAM_DIM if cls is None else getattr(cls, "param_dim",
                                                 PARAM_DIM)


def needs_features(cls) -> bool:
    """True iff the class consumes feature rows [.., F]."""
    return bool(getattr(cls, "needs_features", False))


def _ceil_log2(v: int) -> int:
    """``int(jnp.ceil(jnp.log2(v)))`` with the reference's float32
    log2."""
    return int(torch.ceil(fp32.log2(torch.tensor([float(v)]))))


def _pm(b: torch.Tensor) -> torch.Tensor:
    one = torch.ones((), dtype=torch.int8, device=b.device)
    return torch.where(b, one, -one)


def _field(params: torch.Tensor, i: int, x: torch.Tensor) -> torch.Tensor:
    """Param field i, with trailing axes to broadcast against x."""
    f = params[..., i]
    return f.reshape(f.shape + (1,) * (x.ndim - f.ndim))


def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[b, idx[b]] for idx [B] → [B]."""
    return torch.gather(v, -1, idx[..., None])[..., 0]


def _sorted_prefix(xs, ys, w, n: int | None = None):
    """Sort each row by point and return per-index prefix sums.

    An integer domain [0, n) with n·K < 2³¹ packs (x, index) into one
    int32 key, as the reference does; the unpacked order is the stable
    argsort either way.  Sums follow the reference's rounding order.
    """
    K = xs.shape[-1]
    if (n is not None and 0 < n * K < 2 ** 31
            and not torch.is_floating_point(xs)):
        keys = xs.to(torch.int32) * K + torch.arange(
            K, dtype=torch.int32, device=xs.device)
        keys_s = torch.sort(keys, dim=-1, stable=True).values
        order = (keys_s % K).long()
        xs_s = (keys_s // K).to(xs.dtype)
    else:
        order = torch.argsort(xs, dim=-1, stable=True)
        xs_s = torch.gather(xs, -1, order)
    pos = torch.gather(ys, -1, order) > 0
    w_o = torch.gather(w, -1, order)
    wp = torch.where(pos, w_o, 0.0)
    wn = torch.where(pos, 0.0, w_o)
    return (order, xs_s, fp32.cumsum(wp), fp32.cumsum(wn), fp32.sum_(wp),
            fp32.sum_(wn))


def _first_occurrence(xs_s: torch.Tensor) -> torch.Tensor:
    """Mask of positions that start a run of equal values."""
    return torch.cat([torch.ones_like(xs_s[..., :1], dtype=torch.bool),
                      xs_s[..., 1:] != xs_s[..., :-1]], dim=-1)


def _stack_params(kind: float, a: torch.Tensor, b, s) -> torch.Tensor:
    """(type, a, b, s) rows; ``b``/``s`` may be tensors or constants."""
    cols = [v if torch.is_tensor(v) else torch.full_like(a, v)
            for v in (kind, a, b, s)]
    return torch.stack(cols, dim=-1)


@dataclasses.dataclass(frozen=True)
class Singletons:
    """H = {h_a : a ∈ [n)}, h_a(x) = +1 iff x == a (Theorem 2.3)."""

    n: int

    vc_dim: int = 1
    needs_features = False

    def hypothesis_bits(self) -> int:
        return _ceil_log2(self.n) + 2

    def sample_points(self, rng, m: int):
        return rng.integers(0, self.n, size=m).astype("int32")

    def sample_target(self, rng, x):
        a = int(x[rng.integers(x.shape[0])])
        return np.array([1.0, a, a, 1.0], np.float32)

    def predict(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return _pm(x == _field(params, 1, x))

    def erm(self, xs, ys, w):
        """Exact ERM: candidates a ∈ coreset ∪ {one point off-coreset}."""
        order, xs_s, cwp, cwn, Wp, _ = _sorted_prefix(xs, ys, w, n=self.n)
        K = xs.shape[-1]
        first = _first_occurrence(xs_s)
        idx = torch.arange(K, device=xs.device).expand_as(xs_s)
        start = torch.cummax(torch.where(first, idx, 0), dim=-1).values
        nxt_first = torch.cat([first[..., 1:], torch.ones_like(first[..., :1])],
                              dim=-1)
        end = torch.where(nxt_first, idx, K - 1)
        end = torch.flip(torch.cummin(torch.flip(end, [-1]), dim=-1).values,
                         [-1])
        prev = (start - 1).clamp(min=0)
        seg_wp = torch.gather(cwp, -1, end) - torch.where(
            start > 0, torch.gather(cwp, -1, prev), 0.0)
        seg_wn = torch.gather(cwn, -1, end) - torch.where(
            start > 0, torch.gather(cwn, -1, prev), 0.0)
        errs = Wp[..., None] - seg_wp + seg_wn
        j = pinned_argmin(errs)
        best_in, err_in = _gather(xs_s, j).float(), _gather(errs, j)
        # off-coreset candidate: first free point (constant −1 behaviour)
        cand = torch.cat([torch.zeros_like(xs_s[..., :1]),
                          (xs_s + 1) % self.n], dim=-1)
        pos = torch.searchsorted(xs_s.contiguous(), cand.contiguous())
        present = (pos < K) & (torch.gather(xs_s, -1, pos.clamp(0, K - 1))
                               == cand)
        free_a = _gather(cand, pinned_argmin(present)).float()
        all_present = present.all(dim=-1)
        take_free = ((Wp < err_in) | all_present) & ~all_present
        a = torch.where(take_free, free_a, best_in)
        loss = torch.where(take_free, Wp, err_in)
        return _stack_params(1.0, a, a, 1.0), loss


@dataclasses.dataclass(frozen=True)
class Thresholds:
    """H = {x ↦ s·sign(x − θ)} over [n).  VC dimension 1."""

    n: int

    vc_dim: int = 1
    needs_features = False

    def hypothesis_bits(self) -> int:
        return _ceil_log2(self.n + 1) + 3

    def sample_points(self, rng, m: int):
        return rng.integers(0, self.n, size=m).astype("int32")

    def sample_target(self, rng, x):
        a = float(np.quantile(x, rng.uniform(0.2, 0.8)))
        s = float(rng.choice([-1.0, 1.0]))
        return np.array([2.0, np.floor(a), np.floor(a), s], np.float32)

    def predict(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        a = _field(params, 1, x)
        s = _field(params, 3, x)
        return torch.where(x >= a, s, -s).to(torch.int8)

    def erm(self, xs, ys, w):
        order, xs_s, cwp, cwn, Wp, Wn = _sorted_prefix(xs, ys, w, n=self.n)
        K = xs.shape[-1]
        first = _first_occurrence(xs_s)
        # θ at position j ⇒ −s for i < j, +s for i ≥ j (value-aligned
        # only at first occurrences; j = K is the constant −s)
        prev_wp = F.pad(cwp, (1, 0))                        # Σ_{i<j} wp
        prev_wn = F.pad(cwn, (1, 0))
        err_plus = prev_wp + (Wn[..., None] - prev_wn)
        valid = torch.cat([first, torch.ones_like(first[..., :1])], dim=-1)
        err_plus = torch.where(valid, err_plus, math.inf)
        err_minus = torch.where(valid, (Wp + Wn)[..., None] - err_plus,
                                math.inf)
        jp, jm = pinned_argmin(err_plus), pinned_argmin(err_minus)
        ep, em = _gather(err_plus, jp), _gather(err_minus, jm)
        use_plus = ep <= em
        j = torch.where(use_plus, jp, jm)
        theta = torch.where(j < K, _gather(xs_s, j.clamp(0, K - 1)).float(),
                            float(self.n))
        s = torch.where(use_plus, 1.0, -1.0)
        loss = torch.where(use_plus, ep, em)
        return _stack_params(2.0, theta, theta, s), loss


@dataclasses.dataclass(frozen=True)
class Intervals:
    """H = {x ↦ +1 iff a ≤ x ≤ b} over [n).  VC dimension 2."""

    n: int

    vc_dim: int = 2
    needs_features = False

    def hypothesis_bits(self) -> int:
        return 2 * _ceil_log2(self.n) + 2

    def sample_points(self, rng, m: int):
        return rng.integers(0, self.n, size=m).astype("int32")

    def sample_target(self, rng, x):
        a, b = np.sort(rng.choice(x, size=2, replace=False))
        return np.array([3.0, a, b, 1.0], np.float32)

    def predict(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        a = _field(params, 1, x)
        b = _field(params, 2, x)
        return _pm((x >= a) & (x <= b))

    def erm(self, xs, ys, w):
        """Kadane over value-grouped gains: err(a,b) = Wp − Σ_[a,b](wp−wn)."""
        order, xs_s, cwp, cwn, Wp, _ = _sorted_prefix(xs, ys, w, n=self.n)
        K = xs.shape[-1]
        nxt_first = torch.cat([xs_s[..., 1:] != xs_s[..., :-1],
                               torch.ones_like(xs_s[..., :1], dtype=torch.bool)],
                              dim=-1)
        # prefix of gain g = wp − wn at run ends (value boundaries)
        P = cwp - cwn
        P_end = torch.where(nxt_first, P, -math.inf)
        prevP = F.pad(P[..., :-1], (1, 0))
        prevP_start = torch.where(_first_occurrence(xs_s), prevP, math.inf)
        gain = P_end - torch.cummin(prevP_start, dim=-1).values
        j = pinned_argmax(gain)
        best_gain = _gather(gain, j)
        # left index: argmin of prevP_start over [0, j]
        idx = torch.arange(K, device=xs.device)
        masked = torch.where(idx <= j[..., None], prevP_start, math.inf)
        i = pinned_argmin(masked)
        a = _gather(xs_s, i).float()
        b = _gather(xs_s, j).float()
        loss_in = Wp - best_gain
        # empty interval (constant −1): encode as a > b
        use_empty = Wp < loss_in
        a = torch.where(use_empty, 1.0, a)
        b = torch.where(use_empty, 0.0, b)
        loss = torch.where(use_empty, Wp, loss_in)
        return _stack_params(3.0, a, b, 1.0), loss


@dataclasses.dataclass(frozen=True)
class AxisStumps:
    """H = {X ↦ s·sign(X[f] − θ)} over feature rows.  VC dim O(log F)."""

    num_features: int
    value_bits: int = 32

    needs_features = True

    @property
    def vc_dim(self) -> int:
        return max(1, _ceil_log2(self.num_features) + 1)

    def hypothesis_bits(self) -> int:
        return _ceil_log2(self.num_features) + self.value_bits + 3

    def sample_points(self, rng, m: int):
        return (rng.standard_normal((m, self.num_features))
                .astype(np.float32) * 100.0)

    def sample_target(self, rng, x):
        f = int(rng.integers(self.num_features))
        theta = float(np.quantile(x[:, f], rng.uniform(0.2, 0.8)))
        s = float(rng.choice([-1.0, 1.0]))
        return np.array([4.0, f, theta, s], np.float32)

    def predict(self, params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """params [*B, 4], x [*B, *pts, F] → int8 [*B, *pts]."""
        f = params[..., 1].long()
        f = f.reshape(f.shape + (1,) * (x.ndim - f.ndim))
        xv = torch.gather(x, -1, f.expand(x.shape[:-1] + (1,)))[..., 0]
        theta = _field(params, 2, xv)
        s = _field(params, 3, xv)
        return torch.where(xv >= theta, s, -s).to(torch.int8)

    def erm(self, xs, ys, w):
        """The 1-D threshold ERM on every feature column at once
        (xs [B, K, F]), the best feature pinned to the lowest index."""
        # Not the stump kernel: the center's weights mix·f32(1/c) take
        # only k values, so candidates tie exactly, and the kernel's
        # closed form ½(W ∓ (2S − Σwy)) rounds (and cancels near zero)
        # otherwise than these prefix sums — it would break protocol
        # parity with the reference.  The kernel computes exact OPT
        # instead (tasks.opt_counts).
        thr = Thresholds(n=1 << self.value_bits)
        cols = xs.transpose(-1, -2)                          # [B, F, K]
        params_f, losses = thr.erm(cols, ys[..., None, :].expand_as(cols),
                                   w[..., None, :].expand_as(cols))
        f = pinned_argmin(losses)
        p = torch.gather(params_f, -2, f[..., None, None].expand(
            f.shape + (1, PARAM_DIM)))[..., 0, :]
        params = torch.stack([torch.full_like(p[..., 0], 4.0), f.float(),
                              p[..., 1], p[..., 3]], dim=-1)
        return params, _gather(losses, f)


def make_class(name: str, *, n: int = 0, num_features: int = 0,
               tree_depth: int = 2, tree_bins: int = 32,
               tree_comm_mode: str = "coreset", tree_vote_topk: int = 2):
    """Build a hypothesis class by name (the reference's signature)."""
    if name == "singletons":
        return Singletons(n=n)
    if name == "thresholds":
        return Thresholds(n=n)
    if name == "intervals":
        return Intervals(n=n)
    if name == "stumps":
        return AxisStumps(num_features=num_features)
    if name == "tree":
        from repro_torch.weak_tree import HistogramTrees
        return HistogramTrees(num_features=num_features, depth=tree_depth,
                              bins=tree_bins, comm_mode=tree_comm_mode,
                              vote_topk=tree_vote_topk)
    raise ValueError(f"unknown hypothesis class {name!r}")


def erm_batch(cls, xs: torch.Tensor, ys: torch.Tensor, w: torch.Tensor):
    """ERM over a leading batch (task) axis: xs [B, c(, F)], ys/w
    [B, c] → (params [B, P], loss [B]).  Every ERM of the port already
    takes the task axis; a padded example carries w = 0 and changes no
    candidate's error, and an all-zero-weight row gives loss 0 and a
    finite first candidate (the reference's padding contract)."""
    return cls.erm(xs, ys, w)


def ensemble_predict(cls, hyp_params: torch.Tensor, rounds: int,
                     x: torch.Tensor) -> torch.Tensor:
    """g(x) = sign(Σ_{t<rounds} h_t(x)); sign(0) := +1.  ``x`` holds
    points, or feature rows [..., F] for a feature-track class."""
    shape = x.shape[:-1] if needs_features(cls) else x.shape
    votes = torch.zeros(shape, dtype=torch.int32, device=x.device)
    for t in range(int(rounds)):
        votes += cls.predict(hyp_params[t], x).to(torch.int32)
    one = torch.ones((), dtype=torch.int8, device=x.device)
    return torch.where(votes >= 0, one, -one)


def empirical_errors(predict_pm: torch.Tensor, y: torch.Tensor,
                     alive=None) -> torch.Tensor:
    """E_S(f): the number of misclassified (alive) examples, int32."""
    wrong = predict_pm != y
    if alive is not None:
        wrong = wrong & alive
    return wrong.sum(dtype=torch.int32)
