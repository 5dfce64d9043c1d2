"""End-to-end LM training driver — the port of ``repro.launch.train``.

Resilient-boosting data weighting and quarantine (the paper's mechanism
as a training flag, :mod:`repro_torch.core.resilient`), AdamW with
warmup-cosine, checkpoints, and an eval on the held-out clean split.
The same flags and the same JSON lines as the reference, plus
``--device``: the run is on the card unless ``--device cpu`` asks for
the CPU.  The final line adds ``device`` and ``kernel_launches`` (the
trainer runs the einsum attention path, as the reference's, so no
flash kernel launches).

Usage (CPU):
    python -m repro_torch.launch.train --device cpu --steps 30 \
        --noise 0.1 --resilient --check-every 10
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.core import resilient
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build
from repro_torch.optim import adamw


def run(args, cfg=None) -> dict:
    """Train per ``args``; ``cfg`` (optional) replaces the config that
    ``--arch``/``--smoke`` would pick (a caller's depth-cut one)."""
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = configs.get_config(args.arch)
        if args.smoke:
            cfg = configs.reduced(cfg, d_model=args.d_model, vocab=args.vocab)
    model = build(cfg)
    dc = DataConfig(vocab_size=min(cfg.vocab_size, args.vocab),
                    seq_len=args.seq_len, num_examples=args.num_examples,
                    noise_frac=args.noise, seed=args.seed)
    corpus = SyntheticCorpus(dc)
    params = model.init(args.seed, dev)
    opt = adamw.adamw_init(params)
    n_params = sum(p.numel() for p in adamw.tree_leaves(params))
    train_step = model.make_train_step(
        lr=args.lr, warmup=max(args.steps // 10, 10),
        total_steps=args.steps)
    rc = resilient.ResilientConfig(
        num_examples=dc.num_examples, check_every=args.check_every,
        coreset_size=args.coreset, min_hits_gap=args.min_gap,
        mw_enabled=args.resilient, quarantine_enabled=args.resilient)
    state = resilient.init_state(rc)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    rng = np.random.default_rng(args.seed)
    history = []
    flash_ops.launches = 0
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = corpus.batch(rng, args.batch, alive=state.alive, device=dev)
        w, alive = resilient.batch_weights(state, batch["ids"], rc, dev)
        ids = batch.pop("ids")
        params, opt, met = train_step(
            params, opt, dict(batch, weights=w, alive=alive))
        state = resilient.update(state, ids, met["per_example_nll"],
                                 rc, step)
        if step % args.log_every == 0 or step == args.steps:
            stats = resilient.quarantine_stats(state, corpus.noisy_ids)
            rec = {"step": step, "loss": float(met["loss"]),
                   "grad_norm": float(met["grad_norm"]),
                   "elapsed_s": round(time.time() - t0, 1), **stats}
            history.append(rec)
            print(json.dumps(rec))
        if ckpt and step % args.ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt})
    # clean-split eval: loss on non-noisy examples only
    clean = np.setdiff1d(np.arange(dc.num_examples), corpus.noisy_ids)
    eval_ids = clean[:min(256, clean.size)]
    ne = eval_ids.size
    eb = {"tokens": torch.from_numpy(corpus.tokens[eval_ids]).to(dev),
          "labels": torch.from_numpy(corpus.labels[eval_ids]).to(dev),
          "loss_mask": torch.ones((ne, dc.seq_len), dtype=torch.float32,
                                  device=dev),
          "weights": torch.ones((ne,), device=dev),
          "alive": torch.ones((ne,), device=dev)}
    em = _eval_loss(model, params, eb, args.batch)
    result = {
        "arch": cfg.name, "params": int(n_params),
        "steps": args.steps, "resilient": bool(args.resilient),
        "noise": args.noise,
        "final_train_loss": float(met["loss"]),
        "clean_eval_loss": float(em["loss"]),
        **resilient.quarantine_stats(state, corpus.noisy_ids),
        "history": history,
        "device": dev.type,
        "kernel_launches": {"flash_attention": flash_ops.launches},
    }
    print(json.dumps({k: v for k, v in result.items()
                      if k != "history"}))
    return result


def _eval_loss(model, params, eb: dict, rows: int) -> dict:
    """``model.loss_fn`` of the eval batch, its per-example NLL computed
    ``rows`` examples at a time (at full vocab the whole batch's logits
    would not fit) and weighed as ``loss_fn`` weighs them."""
    with torch.no_grad():
        nll = torch.cat([
            model.loss_fn(params, {k: v[i:i + rows] for k, v in eb.items()}
                          )[1]["per_example_nll"]
            for i in range(0, eb["tokens"].shape[0], rows)])
    w = (eb["weights"] * eb["alive"]).float()
    w = w / torch.clamp(w.sum(), min=1e-9)
    return {"loss": torch.sum(nll * w), "per_example_nll": nll}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--num-examples", type=int, default=2048)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--resilient", action="store_true")
    ap.add_argument("--check-every", type=int, default=25)
    ap.add_argument("--coreset", type=int, default=48)
    ap.add_argument("--min-gap", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def main():
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
