"""Top-level model API — the port of ``repro.models.model``, for every
family: decoder-only stacks of any block pattern (dense, MoE, Mamba
hybrid, xLSTM; a vision prefix of frontend embeddings) and the
encoder-decoder.

``build(cfg, use_flash)`` returns a :class:`Model` with ``init`` (the
reference's parameters for a seed, bit for bit), ``logits``,
``loss_fn``, ``make_train_step``, ``make_prefill_step`` and
``make_decode_step``, as in the reference.  The resilient-boosting hook:
``train_step`` takes a per-example weight vector and an alive mask (the
multiplicative-weights state of :mod:`repro_torch.core.resilient`) and
weighs the per-example loss with them.  Gradients come from
``torch.autograd`` through the einsum attention path: the reference
trains with ``use_flash=False``, so the trainer runs no flash kernel.
``init_serve_cache``/``decode_window`` give the cache of a decode
shape of ``INPUT_SHAPES``, as the reference's.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (DEFAULT_SWA_WINDOW, ModelConfig,
                                      ShapeConfig)
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import decode_graph, encdec, transformer
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Per-token NLL with masking: logits float32 [B, S, V], labels
    [B, S] → [B, S].  DTensor logits (the launch tooling's dry run,
    vocab-parallel) take the gold logit as a one-hot masked sum, the
    same value: DTensor's vocab-parallel gather cannot take the
    select that follows it (torch 2.13)."""
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        hot = labels.long()[..., None] == torch.arange(
            logits.shape[-1], device=labels.device)
        gold = torch.where(hot, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold) * mask


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    use_flash: bool = False

    def init(self, seed: int = 0, device=None) -> dict:
        """The reference's ``init(jax.random.key(seed))``, bit for bit,
        on ``device`` (``cuda`` unless the caller asks for the CPU).
        On ``"meta"`` it is the reference's ``jax.eval_shape(init)``:
        the same tree, shapes and dtypes, and no draw (a key on
        ``meta`` draws empty tensors, :mod:`repro_torch.core.prng`)."""
        dev = resolve_device(device, meta=True)
        key = prng.key(seed, dev)
        if self.cfg.encoder_layers:
            return encdec.init_params(key, self.cfg)
        return transformer.init_params(key, self.cfg)

    def logits(self, params, batch):
        cfg = self.cfg
        if cfg.encoder_layers:
            return encdec.forward(params, cfg, batch["frames"],
                                  batch["tokens"])
        return transformer.forward(params, cfg, batch["tokens"],
                                   prefix_embeds=batch.get("prefix_embeds"),
                                   use_flash=self.use_flash)

    def loss_fn(self, params, batch):
        """Weighted LM loss.  batch: tokens/labels/loss_mask [B, St],
        weights [B] (MW weights), alive [B] (quarantine mask), optional
        prefix_embeds / frames → (loss + aux, metrics).  With a prefix
        the loss covers the token tail only."""
        logits, aux = self.logits(params, batch)
        labels = batch["labels"]
        mask = batch["loss_mask"].float()
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        nll = cross_entropy(logits, labels, mask)               # [B, S]
        per_example = nll.sum(-1) / torch.clamp(mask.sum(-1), min=1.0)
        w = (batch["weights"] * batch["alive"]).float()
        w = w / torch.clamp(w.sum(), min=1e-9)
        loss = torch.sum(per_example * w)
        metrics = {"loss": loss, "aux_loss": aux,
                   "per_example_nll": per_example, "tokens": mask.sum()}
        return loss + aux, metrics

    def make_train_step(self, *, lr: float = 3e-4, warmup: int = 100,
                        total_steps: int = 10_000, clip: float = 1.0):
        """``train_step(params, opt_state, batch) → (params, opt_state,
        metrics)``: autograd gradients, global-norm clipping, AdamW at
        the warmup-cosine rate of the step.  The metrics are detached
        tensors on the parameters' device.  A model built with
        ``use_flash`` refuses: the flash kernel has no backward pass
        (nor has the reference's)."""
        if self.use_flash:
            raise ValueError("training runs the einsum attention path: "
                             "build the model with use_flash=False")

        def train_step(params, opt_state, batch):
            leaves = adamw.tree_leaves(params)
            ids = {id(p): i for i, p in enumerate(leaves)}
            live = [p.detach().requires_grad_(True) for p in leaves]
            tracked = adamw.tree_map(lambda p: live[ids[id(p)]], params)
            (total, metrics) = self.loss_fn(tracked, batch)
            grads = torch.autograd.grad(total, live)
            gtree = adamw.tree_map(lambda p: grads[ids[id(p)]], params)
            gtree, gnorm = adamw.clip_by_global_norm(gtree, clip)
            lr_t = adamw.linear_warmup_cosine(
                opt_state["step"] + 1, lr, warmup, total_steps).to(
                    leaves[0].device)
            with torch.no_grad():
                new_params, new_opt = adamw.adamw_update(
                    params, gtree, opt_state, lr=lr_t)
            metrics = {k: v.detach() if torch.is_tensor(v) else v
                       for k, v in metrics.items()}
            metrics.update(grad_norm=gnorm, lr=lr_t)
            return new_params, new_opt, metrics

        return train_step

    def make_prefill_step(self, window: int = 0):
        """``prefill_step(params, batch) → (last logits [B, Vp],
        caches)``.  The encoder-decoder's caches are (cross, self): each
        decoder layer's cross K/V over the encoded ``frames`` and an
        empty self-attention cache of St + 1 slots (len 0), as the
        reference's."""
        cfg = self.cfg

        def prefill_step(params, batch):
            with obs_trace.span("prefill_step", "model"):
                tokens = batch["tokens"]
                if cfg.encoder_layers:
                    enc_out = encdec.encode(params, cfg, batch["frames"])
                    cross = encdec.build_cross_cache(params, cfg, enc_out)
                    self_cache = encdec.init_self_cache(
                        cfg, tokens.shape[0], int(tokens.shape[1]) + 1,
                        tokens.device)
                    logits, _ = encdec.decode_train(params, cfg, enc_out,
                                                    tokens)
                    return logits[:, -1], (cross, self_cache)
                logits, _, caches = transformer.prefill(
                    params, cfg, tokens,
                    prefix_embeds=batch.get("prefix_embeds"),
                    use_flash=self.use_flash, window=window)
                return logits, caches

        return prefill_step

    def make_decode_step(self, window: int = 0):
        """``decode_step(params, caches, tokens) → (logits [B, Vp],
        caches)``.  On the card an attention stack's step is replayed
        as one CUDA graph (:mod:`repro_torch.models.decode_graph`); the
        graphs belong to this closure, so a new ``make_decode_step()``
        starts with none."""
        cfg = self.cfg

        def eager_step(params, caches, tokens):
            if cfg.encoder_layers:
                cross, self_cache = caches
                logits, self_cache = encdec.decode_step(
                    params, cfg, cross, self_cache, tokens)
                return logits, (cross, self_cache)
            return transformer.decode_step(params, cfg, caches, tokens,
                                           window=window)

        graphs = decode_graph.DecodeGraphs(cfg, eager_step)

        def decode_step(params, caches, tokens):
            with obs_trace.span("decode_step", "model"):
                return graphs(params, caches, tokens)

        return decode_step

    def init_serve_cache(self, shape: ShapeConfig, filled: bool = True,
                         device=None):
        """The cache of decode shape ``shape``; the capacity honours the
        long-context mode (a ``swa`` arch keeps a ring of
        ``DEFAULT_SWA_WINDOW`` slots for ``long_500k``).  ``device``
        ``"meta"`` gives the layout without memory."""
        cfg = self.cfg
        dev = resolve_device(device, meta=True)
        window = self.decode_window(shape)
        capacity = min(shape.seq_len, window) if window else shape.seq_len
        B = shape.global_batch
        if cfg.encoder_layers:
            cross = [{n: torch.zeros((B, shape.seq_len, cfg.num_kv_heads,
                                      cfg.hd), dtype=torch.bfloat16,
                                     device=dev) for n in "kv"}
                     for _ in range(cfg.num_layers)]
            return cross, encdec.init_self_cache(cfg, B, 1024, dev,
                                                 filled=False)
        return transformer.init_cache(cfg, B, capacity, dev, filled=filled)

    def decode_window(self, shape: ShapeConfig) -> int:
        cfg = self.cfg
        if cfg.sliding_window:
            return cfg.sliding_window
        if shape.name == "long_500k" and cfg.long_context_mode == "swa":
            return DEFAULT_SWA_WINDOW
        return 0


def build(cfg: ModelConfig, use_flash: bool = False) -> Model:
    transformer.check_pattern(cfg)
    return Model(cfg=cfg, use_flash=use_flash)
