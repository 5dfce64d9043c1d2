"""The comparison that decides ``correct``.

A checked request is a prompt (with the tokens served after it), the
positions whose logits the timed path produced, the tokens it served
there and, where kept, those logits.  The plain reference runs once
over the prompt and its served tokens, and two numbers are read at
each position, over the real vocabulary:

* ``token_gap``: how far the served token's reference logit lies below
  the reference's best, in units of the reference logits' standard
  deviation at that position (0 where the served token is the
  reference's choice; a near tie gives a small gap);
* ``logit_rel_l2``: ‖program − reference‖₂ / ‖reference‖₂ of the logits.

A cell's number is the largest over its checked positions; it is
correct when every number is at most its limit and every request was
served.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Request:
    tokens: torch.Tensor          # [b, S] the inputs the reference runs over
    out_pos: list                 # positions whose logits were produced
    served: torch.Tensor          # [len(rows), len(out_pos)] tokens served
    logits: torch.Tensor | None   # [len(rows), len(out_pos), Vp] the program's
    prompt_len: int               # tokens before the first decode step
    rows: list | None = None      # the checked rows of ``tokens`` (all: None)


def numbers(ref, served, logits, vocab: int) -> dict:
    """Per-position ``token_gap`` and ``logit_rel_l2`` (flat tensors)."""
    r = ref[..., :vocab].double().reshape(-1, vocab)
    s = served.reshape(-1).long().to(r.device)
    gap = (r.max(-1).values - r.gather(-1, s[:, None])[:, 0]) / r.std(-1)
    out = {"token_gap": gap}
    if logits is not None:
        x = logits[..., :vocab].double().reshape(-1, vocab).to(r.device)
        out["logit_rel_l2"] = (x - r).norm(dim=-1) / r.norm(dim=-1)
    return out


def compare(reference, params, config, requests, products="f32") -> dict:
    """The cell's numbers: for each request the reference's logits, and
    with ``products="fp8"`` also the control's (the reference in the
    next precision down, put in the program's place: it serves its own
    argmax and is judged as the program is)."""
    worst = {}
    V = config["vocab_size"]
    for q in requests:
        ref = reference.logits(params, config, q.tokens, q.out_pos,
                               prompt_len=q.prompt_len)
        rows = slice(None) if q.rows is None else q.rows
        ref = ref[rows]
        if products == "f32":
            got = numbers(ref, q.served, q.logits, V)
        else:
            ctl = reference.logits(params, config, q.tokens, q.out_pos,
                                   products=products,
                                   prompt_len=q.prompt_len)[rows]
            got = numbers(ref, ctl[..., :V].argmax(-1), ctl, V)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), float(v.max()))
    return worst


def verdict(worst: dict, limits: dict, served_all: bool):
    """(correct, {name: {"value", "limit"}})."""
    missing = set(limits) - set(worst)
    if missing:
        raise KeyError(f"no reading of {sorted(missing)}")
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    ok = served_all and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
