"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory) — the
port of ``repro.models.xlstm``.

* mLSTM's prefill is the chunkwise-parallel form: dense stabilised gate
  matrices within a chunk of ``MLSTM_CHUNK`` tokens, the (C, n, m) state
  carried across chunks, so the workspace is O(B·H·L²), not
  O(B·H·S²).  Decode is the O(1) recurrent update.
* sLSTM is sequential (its recurrent matrices are block-diagonal per
  head): the prefill loops over time, decode is one step.

Shapes: d_model D, H heads; mLSTM runs at di = 2·D with hd = di/H.
mLSTM state: C [B, H, hd, hd], n [B, H, hd], m [B, H]; sLSTM state:
h, c, n, m [B, D], all float32.  ``jax.nn.gelu`` defaults to the tanh
approximation, and so does the port's sLSTM FFN.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models import layers as L

MLSTM_CHUNK = 256
NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(key: torch.Tensor, cfg) -> dict:
    """The reference's ``split(key, 8)``: up, wq, wk, wv, wi, wf, down."""
    D = cfg.d_model
    di = 2 * D
    ks = prng.split(key, 8)
    return {"up": L.linear_init(ks[0], D, 2 * di),          # [x_m, z-gate]
            "wq": L.linear_init(ks[1], di, di),
            "wk": L.linear_init(ks[2], di, di),
            "wv": L.linear_init(ks[3], di, di),
            "wi": L.linear_init(ks[4], di, cfg.num_heads, bias=True),
            "wf": L.linear_init(ks[5], di, cfg.num_heads, bias=True),
            "norm": L.rmsnorm_init(di, key.device),
            "down": L.linear_init(ks[6], di, D)}


def _mlstm_qkv(p, cfg, xm: torch.Tensor):
    B, S, di = xm.shape
    H = cfg.num_heads
    hd = di // H
    q = L.reshape(L.linear(p["wq"], xm), B, S, H, hd)
    k = L.reshape(L.linear(p["wk"], xm), B, S, H, hd) / math.sqrt(float(hd))
    v = L.reshape(L.linear(p["wv"], xm), B, S, H, hd)
    logi = L.linear(p["wi"], xm).float()                    # [B, S, H]
    logf = F.logsigmoid(L.linear(p["wf"], xm).float())      # [B, S, H]
    return q, k, v, logi, logf


def _mlstm_chunk(state, qq, kk, vv, li, lf):
    """One chunk of L tokens against the carried (C, n, m): returns the
    new state and h [B, L, H, hd] float32.  With a = i − F (F the
    cumulative log forget) and M_t = max(cummax(a)_t, m_prev), every
    gate exp(a_s − M_t) ≤ 1."""
    C, n, m_prev = state
    Lc = qq.shape[1]
    Fc = torch.cumsum(lf, dim=1)                            # [B, L, H]
    a = li - Fc
    M = torch.maximum(torch.cummax(a, dim=1).values, m_prev[:, None])
    E = torch.exp(a[:, None] - M[:, :, None])               # [B, t, s, H]
    tril = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                 device=qq.device))
    E = torch.where(tril[None, :, :, None], E, 0.0)
    qf, kf, vf = qq.float(), kk.float(), vv.float()
    intra = torch.einsum("bthd,bshd->btsh", qf, kf) * E
    carry = torch.exp(torch.clamp(m_prev[:, None] - M, max=0.0))
    num = (torch.einsum("btsh,bshd->bthd", intra, vf)
           + torch.einsum("bthd,bhde->bthe", qf, C) * carry[..., None])
    qn = intra.sum(2) + torch.einsum("bthd,bhd->bth", qf, n) * carry
    floor = torch.exp(torch.clamp(-(Fc + M), max=30.0))
    h = num / torch.maximum(qn.abs(), floor)[..., None]
    M_L, F_L = M[:, -1], Fc[:, -1]                          # [B, H]
    kw = kf * torch.exp(a - M_L[:, None])[..., None]
    decay = torch.exp(torch.clamp(m_prev - M_L, max=0.0))
    C = C * decay[..., None, None] + torch.einsum("bshd,bshe->bhde", kw, vf)
    n = n * decay[..., None] + kw.sum(1)
    return (C, n, F_L + M_L), h


def mlstm_forward(p, cfg, x: torch.Tensor):
    """Chunkwise-parallel prefill.  x [B, S, D] → (y [B, S, D], state
    {"C", "n", "m"}).  S pads to whole chunks of min(MLSTM_CHUNK, S)
    with logi = −1e30 (no input) and logf = 0 (no forgetting), so the
    padding leaves the state as it is.  On DTensors the chunks run on
    each device's batch rows (:func:`layers.on_rows`): the recurrences
    are independent per row, and stepped op by op through DTensor (the
    launch tooling's dry run) an xLSTM prefill's chunks and steps would
    take hours."""
    B, S, D = x.shape
    xm, z = L.linear(p["up"], x).chunk(2, dim=-1)
    q, k, v, logi, logf = _mlstm_qkv(p, cfg, xm)
    H, hd = q.shape[2], q.shape[3]
    Lc = min(MLSTM_CHUNK, S)
    pad = (-S) % Lc
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=NEG)
        logf = F.pad(logf, (0, 0, 0, pad))

    def scan(q, k, v, logi, logf):
        st = mlstm_init_state(cfg, q.shape[0], device=q.device)
        state = (st["C"], st["n"], st["m"])
        hs = []
        for c0 in range(0, S + pad, Lc):
            sl = slice(c0, c0 + Lc)
            state, h = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl],
                                    logi[:, sl], logf[:, sl])
            hs.append(h.to(x.dtype))
        return (torch.cat(hs, dim=1), *state)

    h, *state = L.on_rows(scan, q, "bbbbb", "bbbb")(q, k, v, logi, logf)
    out = h.reshape(B, S + pad, H * hd)[:, :S]
    out = L.rms_norm(p["norm"], out, cfg.norm_eps)
    y = L.linear(p["down"], out * F.silu(z))
    return y, dict(zip(("C", "n", "m"), state))


def mlstm_init_state(cfg, batch: int, device=None) -> dict:
    di = 2 * cfg.d_model
    H = cfg.num_heads
    hd = di // H
    return {"C": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, H, hd), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, H), NEG, dtype=torch.float32,
                            device=device)}


def mlstm_decode(p, cfg, x: torch.Tensor, state: dict):
    """x [B, 1, D] → (y [B, 1, D], new state), O(1) per token."""
    xm, z = L.linear(p["up"], x).chunk(2, dim=-1)
    q, k, v, logi, logf = _mlstm_qkv(p, cfg, xm)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                     # [B, H, hd]
    logi, logf = logi[:, 0], logf[:, 0]                     # [B, H]
    m_new = torch.maximum(logf + state["m"], logi)
    fg = torch.exp(logf + state["m"] - m_new)[..., None]
    ig = torch.exp(logi - m_new)[..., None]
    C = state["C"] * fg[..., None] + ig[..., None] \
        * (k[..., :, None] * v[..., None, :]).float()
    n = state["n"] * fg + ig * k.float()
    qf = q.float()
    num = torch.einsum("bhkv,bhk->bhv", C, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(x.shape[0], 1, -1).to(x.dtype)
    y = L.rms_norm(p["norm"], y, cfg.norm_eps)
    out = L.linear(p["down"], y * F.silu(z))
    return out, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(key: torch.Tensor, cfg) -> dict:
    """The reference's ``split(key, 7)``: wx, r, up, down."""
    D = cfg.d_model
    H = cfg.num_heads
    hd = D // H
    ks = prng.split(key, 7)
    return {"wx": L.linear_init(ks[0], D, 4 * D, bias=True),  # i, f, z, o
            "r": L.normal(ks[1], (4, H, hd, hd), 0.02),      # block-diag
            "norm": L.rmsnorm_init(D, key.device),
            "up": L.linear_init(ks[2], D, 2 * ((4 * D) // 3)),
            "down": L.linear_init(ks[3], (4 * D) // 3, D)}


def _slstm_step(p, cfg, xt: torch.Tensor, state):
    """xt [B, 4D] pre-activations from x; state (h, c, n, m) [B, D]."""
    h, c, n, m = state
    B, D = h.shape
    H = cfg.num_heads
    rec = L.reshape(torch.einsum("bhd,ghde->gbhe",
                                 L.reshape(h, B, H, D // H), p["r"].float()),
                    4, B, D)
    pre = L.reshape(xt.float(), B, 4, D).transpose(0, 1) + rec
    li, lf = pre[0], F.logsigmoid(pre[1])
    z, o = torch.tanh(pre[2]), torch.sigmoid(pre[3])
    m_new = torch.maximum(lf + m, li)
    ig = torch.exp(li - m_new)
    fg = torch.exp(lf + m - m_new)
    c_new = fg * c + ig * z
    n_new = fg * n + ig
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return (h_new, c_new, n_new, m_new)


def _slstm_out(p, cfg, y: torch.Tensor) -> torch.Tensor:
    y = L.rms_norm(p["norm"], y, cfg.norm_eps)
    g, u = L.linear(p["up"], y).chunk(2, dim=-1)
    return L.linear(p["down"], F.gelu(g, approximate="tanh") * u)


def slstm_forward(p, cfg, x: torch.Tensor):
    """x [B, S, D] → (y [B, S, D], state {"h", "c", "n", "m"}): the
    recurrence stepped over time (on DTensors, on each device's batch
    rows, the recurrent weights replicated: :func:`layers.on_rows`)."""
    xg = L.linear(p["wx"], x)                               # [B, S, 4D]

    def scan(r, xg):
        state = slstm_init_state(cfg, xg.shape[0], device=xg.device)
        hs = []
        for t in range(xg.shape[1]):
            state = _slstm_step({"r": r}, cfg, xg[:, t], state)
            hs.append(state[0])
        return (torch.stack(hs, dim=1), *state)             # y [B, S, D]

    y, *state = L.on_rows(scan, xg, "rb", "bbbbb")(p["r"], xg)
    return (_slstm_out(p, cfg, y.to(x.dtype)),
            dict(zip(("h", "c", "n", "m"), state)))


def slstm_init_state(cfg, batch: int, device=None) -> tuple:
    D = cfg.d_model
    zeros = [torch.zeros((batch, D), dtype=torch.float32, device=device)
             for _ in range(3)]
    return (*zeros, torch.full((batch, D), NEG, dtype=torch.float32,
                               device=device))


def slstm_decode(p, cfg, x: torch.Tensor, state):
    """x [B, 1, D], state (h, c, n, m) → (y [B, 1, D], new state)."""
    xg = L.linear(p["wx"], x)[:, 0]
    state = _slstm_step(p, cfg, xg, state)
    return _slstm_out(p, cfg, state[0][:, None].to(x.dtype)), state
