"""Mamba selective state-space block (jamba's mixer) — the port of
``repro.models.ssm``.

The prefill runs in chunks of ``CHUNK`` steps: within a chunk the
first-order recurrence h_t = dA_t·h_{t−1} + dBu_t is a log-depth
(Hillis–Steele) scan over [B, CHUNK, d_inner, d_state] float32 tensors,
across chunks the state is carried, so the scan's workspace stays at
one chunk.  Padded steps past S are identity steps, so the carried
state is the state at position S.  A decode step is the O(1) update.

State per layer: h [B, d_inner, d_state] float32; the conv ring
[B, cw − 1, d_inner], bf16 after a prefill (the reference casts it).

The initial ``dt_bias`` and ``A_log`` are the reference's eager XLA:CPU
transcendentals (``log(expm1(exp(u)))`` with bounds that are XLA
``log``s; ``log(1..d_state)``), spelled out with
:mod:`repro_torch.core.fp32`, so the parameters match bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import fp32, prng
from repro_torch.models import layers as L

CHUNK = 128


def _dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    dt_rank = max(cfg.d_model // 16, 1)
    return di, cfg.ssm_state_dim, dt_rank, cfg.ssm_conv_width


def init(key: torch.Tensor, cfg) -> dict:
    """The reference's ``split(key, 6)``: in_proj, conv_w, x_proj,
    dt_proj, dt_bias, out_proj."""
    D = cfg.d_model
    di, ds, dtr, cw = _dims(cfg)
    dev = key.device
    ks = prng.split(key, 6)
    lo, hi = (float(v) for v in fp32.log(torch.tensor([1e-3, 1e-1])))
    u = prng.uniform(ks[4], (di,), lo, hi)
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": L.linear_init(ks[0], D, 2 * di),
        "conv_w": L.normal(ks[1], (cw, di), 0.1),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=dev),
        "x_proj": L.linear_init(ks[2], di, dtr + 2 * ds),
        "dt_proj": L.linear_init(ks[3], dtr, di, scale=dtr ** -0.5),
        "dt_bias": fp32.log(fp32.expm1(fp32.exp(u))),
        "A_log": fp32.log(a).expand(di, ds).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": L.linear_init(ks[5], di, D),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0) (torch's ``softplus``
    switches to x above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_inputs(p, cfg, u: torch.Tensor):
    """u [B, S', di] post-conv activations → (dA, dBu [B, S', di, ds],
    C [B, S', ds]), float32."""
    di, ds, dtr, _ = _dims(cfg)
    xdbc = L.linear(p["x_proj"], u).float()
    dt, Bc, Cc = torch.split(xdbc, [dtr, ds, ds], dim=-1)
    dt = _softplus(L.linear(p["dt_proj"], dt.to(u.dtype)).float()
                   + p["dt_bias"])
    A = -torch.exp(p["A_log"])                               # [di, ds]
    dA = torch.exp(dt[..., None] * A)
    dBu = (dt * u.float())[..., None] * Bc[..., None, :]
    return dA, dBu, Cc


def _conv(p, cfg, x: torch.Tensor, state=None):
    """Causal depthwise conv1d.  x [B, S, di]; state [B, cw − 1, di] or
    None → (out [B, S, di], new state: the last cw − 1 inputs)."""
    cw = cfg.ssm_conv_width
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # [B, S+cw−1, di]
    S = x.shape[1]
    out = xp[:, :S] * p["conv_w"][0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * p["conv_w"][i].to(x.dtype)
    out = out + p["conv_b"].to(x.dtype)
    new_state = xp[:, -(cw - 1):] if cw > 1 else pad
    return out, new_state


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) pairs over dim 1 under
    (a1, b1)∘(a2, b2) = (a1·a2, a2·b1 + b2): (∏a, h from a zero state)."""
    L_ = a.shape[1]
    s = 1
    while s < L_:
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def forward(p, cfg, x: torch.Tensor):
    """Prefill / training form.  x [B, S, D] → (y [B, S, D], final
    state {"h", "conv"})."""
    B, S, D = x.shape
    xz = L.linear(p["in_proj"], x)
    u, z = xz.chunk(2, dim=-1)
    u, conv_state = _conv(p, cfg, u)
    u = F.silu(u)
    h = init_state(cfg, B, device=x.device)["h"]
    ys = []
    for c0 in range(0, S, CHUNK):
        uc = u[:, c0:c0 + CHUNK]
        dA, dBu, Cc = _ssm_inputs(p, cfg, uc)
        # a short last chunk is the padded one: its missing steps are
        # identity steps, so the state is the state at position S
        cumA, hs = _scan(dA, dBu)
        hs = hs + cumA * h[:, None]
        y = torch.einsum("bsdn,bsn->bsd", hs, Cc)
        y = y + uc.float() * p["D"]
        h = hs[:, -1]
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1) * F.silu(z)
    state = {"h": h, "conv": conv_state.to(torch.bfloat16)}
    return L.linear(p["out_proj"], y), state


def init_state(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    di, ds, _, cw = _dims(cfg)
    return {"h": torch.zeros((batch, di, ds), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cw - 1, di), dtype=dtype,
                                device=device)}


def decode_step(p, cfg, x: torch.Tensor, state: dict):
    """x [B, 1, D] → (y [B, 1, D], new state).  O(1) per token."""
    xz = L.linear(p["in_proj"], x)
    u, z = xz.chunk(2, dim=-1)
    u, conv_state = _conv(p, cfg, u, state["conv"])
    u = F.silu(u)
    dA, dBu, Cc = _ssm_inputs(p, cfg, u)                    # S = 1
    h = state["h"] * dA[:, 0] + dBu[:, 0]                    # [B, di, ds]
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None]
    y = y + u.float() * p["D"]
    y = y.to(x.dtype) * F.silu(z)
    return L.linear(p["out_proj"], y), {"h": h, "conv": conv_state}
