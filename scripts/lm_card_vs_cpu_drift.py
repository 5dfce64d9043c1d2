"""How far the reduced LM families' logits drift between the card and
the CPU, and where: for each arch, seed-0 weights on both devices, a
prefill of 200 tokens and 4 teacher-forced decode steps (the inputs of
``chip_smoke.py``'s card-against-CPU phase), with cuBLAS's bf16
reduced-precision reduction allowed and not allowed.  Prints, per step,
the largest absolute difference of the logits and its margin over the
2e-2 allclose bound (positive: past it), and, per layer, the largest
difference of the prefill's hidden state.

    PYTHONPATH=src python3 scripts/lm_card_vs_cpu_drift.py [arch ...]

Needs one CUDA card.  One JSON line per (arch, setting), then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch import configs, models
from repro_torch.models import layers, transformer

TOL = 2e-2
ARCHS = ("xlstm-1.3b", "jamba-v0.1-52b", "granite-moe-3b-a800m")


def drift(arch: str, B: int = 2, P: int = 200, n: int = 4) -> dict:
    cfg = configs.reduced(configs.get_config(arch))
    model = models.build(cfg, use_flash=True)
    params = {d: model.init(seed=0, device=d) for d in ("cpu", "cuda")}
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(B, P + n)).astype(np.int32)

    def logits(dev):
        t = torch.as_tensor(toks, device=dev)
        out, caches = model.make_prefill_step()(params[dev],
                                                {"tokens": t[:, :P]})
        steps = [out]
        for i in range(P, P + n):
            out, caches = model.make_decode_step()(params[dev], caches,
                                                   t[:, i:i + 1])
            steps.append(out)
        return torch.stack(steps).cpu()

    def hidden(dev):
        t = torch.as_tensor(toks[:, :P], device=dev)
        h = layers.embed(params[dev]["embed"], t)
        pos = torch.arange(P, dtype=torch.int32, device=dev)[None]
        out = []
        for p, (mixer, ffn) in zip(params[dev]["blocks"],
                                   transformer.layer_kinds(cfg)):
            h = transformer._apply_block(p, cfg, mixer, ffn, h, pos,
                                         window=0, use_flash=False)[0]
            out.append(h.float().cpu())
        return out

    got, want = logits("cuda"), logits("cpu")
    d = (got - want).abs()
    margin = (d - (TOL + TOL * want.abs())).amax(dim=(1, 2))
    return {"max_abs_err_per_step": d.amax(dim=(1, 2)).tolist(),
            "allclose_margin_per_step": margin.tolist(),
            "prefill_hidden_err_per_layer": [
                float((a - b).abs().max())
                for a, b in zip(hidden("cuda"), hidden("cpu"))]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*", default=ARCHS)
    archs = ap.parse_args().archs
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    try:
        for allow in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = allow
            for arch in archs:
                print(json.dumps({"arch": arch,
                                  "bf16_reduced_precision_reduction": allow,
                                  **drift(arch)}), flush=True)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
