"""The plain references against ``repro_torch``'s model on the CPU, at
tiny widths, on the same drawn weights, with the model's products run
in float32 (so only the order of float32 operations differs)."""

import pytest
import torch

from portbench import spec, weights
from portbench.reference import dense, moe as moe_ref
from portbench.tests.precision import float32_products
from repro_torch import models
from repro_torch.models import moe, transformer

torch.set_num_threads(1)

DATA = spec.PKG / "tests" / "data"
SEED = 2**31 + 11


def setup(name):
    config = spec.load_json(DATA / "configs" / f"{name}.json")
    cfg = spec.port_config(config)
    model = models.build(cfg, use_flash=True)
    params = weights.draw(model.init(0, "meta"), SEED, "cpu",
                          config["assumed"]["weight_draw"])
    g = weights.generator(SEED, 1, "cpu")
    tokens = torch.randint(0, config["vocab_size"], (3, 96), generator=g)
    return config, model, params, tokens


def close(a, b, tol=2e-5):
    scale = b.abs().max()
    assert (a - b).abs().max() <= tol * scale, float((a - b).abs().max() / scale)


@pytest.mark.parametrize("name,ref", [("tiny-dense", dense), ("tiny-moe", moe_ref)])
def test_prefill_logits_match_the_model(name, ref):
    config, model, params, tokens = setup(name)
    S = tokens.shape[1]
    with float32_products(), torch.no_grad():
        last, _ = model.make_prefill_step()(params, {"tokens": tokens})
        full, _ = model.logits(params, {"tokens": tokens})
    got = ref.logits(params, config, tokens, list(range(S)), prompt_len=S)
    close(got[:, -1], last)
    close(got, full)


@pytest.mark.parametrize("name,ref", [("tiny-dense", dense), ("tiny-moe", moe_ref)])
def test_decode_through_the_cache_matches_the_full_pass(name, ref):
    """Prefill of 64 tokens, then 8 decode steps teacher-forced with the
    next tokens: the reference's one pass with ``prompt_len`` 64 (the
    MoE drop-free past it)."""
    config, model, params, tokens = setup(name)
    P, n = 64, 8
    with float32_products(), torch.no_grad():
        last, caches = model.make_prefill_step()(params, {"tokens": tokens[:, :P]})
        grown = transformer.init_cache(model.cfg, tokens.shape[0], P + n, "cpu",
                                       dtype=torch.float32, filled=False)
        for c, g in zip(caches, grown):
            g["k"][:, :P], g["v"][:, :P] = c["k"], c["v"]
            g["len"] = c["len"]
        step = model.make_decode_step()
        steps = [last]
        for i in range(n):
            logits, grown = step(params, grown, tokens[:, P + i:P + i + 1].int())
            steps.append(logits)
    got = ref.logits(params, config, tokens[:, :P + n], list(range(P - 1, P + n)),
                     prompt_len=P)
    close(got, torch.stack(steps, 1))


def test_moe_capacity_drops_as_the_model_does():
    """A router that sends most tokens to expert 0: the group's capacity
    drops choices, and the reference drops the same ones."""
    config, model, params, tokens = setup("tiny-moe")
    for blk in params["blocks"]:
        blk["ffn"]["router"]["w"][:, 0] += 0.5
    x = torch.randn(1, 96, config["d_model"], generator=weights.generator(SEED, 9, "cpu"))
    p = params["blocks"][0]["ffn"]
    idx, _, keep = moe_ref.route(p, config, x[0], torch.arange(96))
    assert not keep.all()
    cfg = spec.port_config(config)
    pos, kept = moe.einsum_slots(idx[None], cfg.num_experts,
                                 moe.capacity(cfg, 96, exact=False))
    assert torch.equal(kept[0], keep)
    with float32_products(), torch.no_grad():
        y, _ = moe.apply(p, cfg, x)
    close(moe_ref.ffn(p, config, x, dense.Products("f32")), y)


def test_fp8_products_round_to_three_mantissa_bits():
    t = torch.linspace(-3.0, 3.0, 1001)
    err = (dense.fp8(t) - t).abs() / t.abs().clamp(min=0.05)
    assert 0.01 < float(err.max()) <= 2.0**-4
