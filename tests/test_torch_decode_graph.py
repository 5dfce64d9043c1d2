"""The decode step's CUDA graph (``models/decode_graph.py``): when it
engages, what its key sees, its counters, and on the card the replayed
step against the eager one.

On the CPU every step runs eagerly; the tests hold each reason a step
must stay eager (the CPU, a DTensor cache, a tensor that requires grad,
a Mamba, xLSTM or encoder-decoder stack) to ``decode_graph.eager_steps``
and no capture, and the key to the storage it names.  On the card the
graph-replayed step must give the eager step's logits and K/V bit for
bit over 20 steps that include a restart (new ``len`` tensors, fresh
tokens), at a dense, an MoE and a sliding-window configuration.  The
file imports no JAX, so the card-only tests run where only the port is
installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_decode_graph.py
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import base
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build, decode_graph, transformer
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim import adamw

torch.set_num_threads(1)

GRAPHABLE = {"deepseek-7b", "qwen3-32b", "internlm2-20b", "command-r-35b",
             "granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b", "pixtral-12b"}
EAGER_FAMILIES = {"jamba-v0.1-52b": "Mamba hybrid", "xlstm-1.3b": "xLSTM",
                  "seamless-m4t-medium": "encoder-decoder"}


@pytest.fixture
def registry():
    """A fresh default registry, handed back to the next test fresh."""
    yield obs_metrics.reset_default_registry()
    obs_metrics.reset_default_registry()


def _counts(reg) -> dict:
    return {n: reg.counter(f"decode_graph.{n}").value
            for n in ("captures", "replays", "eager_steps")}


def _prefilled(arch, device, B=2, P=8, seed=0, **replace):
    """reduced(arch) (fields ``replace``d), its parameters and the caches
    of a prefill of P tokens, and the tokens after them [B, 24]."""
    cfg = dataclasses.replace(base.reduced(base.get_config(arch)), **replace)
    model = build(cfg, use_flash=device != "cpu")
    params = model.init(seed=seed, device=device)
    g = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (B, P + 24), generator=g,
                         dtype=torch.int32).to(device)
    batch = {"tokens": toks[:, :P]}
    if cfg.encoder_layers:
        batch["frames"] = (0.02 * torch.randn(B, P, cfg.d_model,
                                              generator=g)).to(
            torch.bfloat16).to(device)
    _, caches = model.make_prefill_step()(params, batch)
    return model, params, caches, toks[:, P:]


def _clone(caches):
    return [{n: t.clone() for n, t in c.items()} for c in caches]


@pytest.mark.parametrize("arch", sorted(base.ASSIGNED_ARCHS))
def test_graphable_stacks(arch):
    """Attention stacks with an MLP or MoE FFN are recorded; Mamba,
    xLSTM and the encoder-decoder are not."""
    cfg = base.get_config(arch)
    assert decode_graph.graphable(cfg) == (arch in GRAPHABLE)
    assert decode_graph.graphable(base.reduced(cfg)) == (arch in GRAPHABLE)
    assert (arch in GRAPHABLE) != (arch in EAGER_FAMILIES)


@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-3b-a800m",
                                  *sorted(EAGER_FAMILIES)])
def test_cpu_steps_stay_eager(arch, registry):
    """On the CPU every decode step is eager, counted, and never
    captured; a Mamba, xLSTM or encoder-decoder stack is refused before
    the device is looked at."""
    model, params, caches, toks = _prefilled(arch, "cpu")
    step = model.make_decode_step()
    for i in range(3):
        _, caches = step(params, caches, toks[:, i:i + 1])
    assert _counts(registry) == {"captures": 0, "replays": 0,
                                 "eager_steps": 3}
    if arch in EAGER_FAMILIES:
        assert decode_graph.eager_reason(model.cfg, [], caches,
                                         toks[:, :1]) == "stack"
    else:
        assert decode_graph.eager_reason(
            model.cfg, decode_graph.leaves(params), caches,
            toks[:, :1]) == "device"


def test_grad_stays_eager(registry):
    """Parameters that require grad keep the step eager (the test is on
    the tensors, not on grad mode), and the step still decodes."""
    model, params, caches, toks = _prefilled("deepseek-7b", "cpu")
    want, _ = transformer.decode_step(
        params, model.cfg, _clone(caches), toks[:, :1])
    grads = adamw.tree_map(lambda t: t.detach().requires_grad_(True), params)
    assert decode_graph.eager_reason(model.cfg, decode_graph.leaves(grads),
                                     caches, toks[:, :1]) == "grad"
    got, _ = model.make_decode_step()(grads, caches, toks[:, :1])
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    assert _counts(registry) == {"captures": 0, "replays": 0,
                                 "eager_steps": 1}


def test_dtensor_cache_stays_eager(registry):
    """A DTensor cache (the dry run's) keeps the step eager, on a 1-rank
    gloo mesh: the graph never sees it."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    cfg = base.reduced(base.get_config("granite-moe-3b-a800m"))
    calls = []

    def eager(params, caches, tokens):
        calls.append(tokens)
        return tokens, caches

    graphs = decode_graph.DecodeGraphs(cfg, eager)
    tok = torch.zeros(2, 1, dtype=torch.int32)
    with mesh_lib.make_host_mesh(device="cpu") as mesh:
        rep = (Replicate(),) * mesh.ndim
        cache = [{n: distribute_tensor(torch.zeros(2, 4, 1, 8), mesh, rep)
                  for n in "kv"}]
        cache[0]["len"] = distribute_tensor(
            torch.zeros(2, dtype=torch.int32), mesh, rep)
        assert decode_graph.eager_reason(cfg, [], cache, tok) == "dtensor"
        graphs({}, cache, tok)
        graphs({}, cache, tok)
    assert len(calls) == 2
    assert _counts(registry) == {"captures": 0, "replays": 0,
                                 "eager_steps": 2}


def _key_inputs():
    cfg = base.reduced(base.get_config("deepseek-7b"))
    model = build(cfg)
    params = model.init(seed=0, device="cpu")
    caches = transformer.init_cache(cfg, 2, 16, "cpu")
    return params, caches, torch.zeros(2, 1, dtype=torch.int32)


def _key(params, caches, tokens):
    return decode_graph.graph_key(decode_graph.leaves(params), caches, tokens)


def test_key_ignores_len_and_token_tensors():
    """New ``len`` or token tensors (a restart, a new request) keep the
    key: the replay copies their values in."""
    params, caches, tok = _key_inputs()
    key = _key(params, caches, tok)
    fresh = [dict(c, len=torch.full((2,), 5, dtype=torch.int32))
             for c in caches]
    assert _key(params, fresh, torch.ones(2, 1, dtype=torch.int32)) == key
    assert _key(params, caches, torch.arange(4, dtype=torch.int32)[::2, None]
                ) == key


@pytest.mark.parametrize("change", ["kv_storage", "param_storage",
                                    "token_shape", "token_dtype",
                                    "cache_shape", "entry_point"])
def test_key_sees_storage_shapes_and_entry_point(change, monkeypatch):
    """New K/V or parameter storage (K/V is never copied), other token
    shapes or dtypes, another cache capacity, and a patched decode
    attention entry point each give a new key."""
    params, caches, tok = _key_inputs()
    key = _key(params, caches, tok)
    if change == "kv_storage":
        caches = [dict(c, k=c["k"].clone()) if i == 1 else c
                  for i, c in enumerate(caches)]
    elif change == "param_storage":
        params = adamw.tree_map(lambda t: t, params)
        params["final_norm"] = {k: v.clone()
                                for k, v in params["final_norm"].items()}
    elif change == "token_shape":
        tok = torch.zeros(3, 1, dtype=torch.int32)
    elif change == "token_dtype":
        tok = tok.long()
    elif change == "cache_shape":
        cfg = base.reduced(base.get_config("deepseek-7b"))
        caches = transformer.init_cache(cfg, 2, 32, "cpu")
    else:
        monkeypatch.setattr(decode_ops, "decode_attention",
                            lambda *a, **kw: None)
    assert _key(params, caches, tok) != key


def test_leaves_are_the_parameters():
    """The per-step flatten holds every parameter tensor once, as the
    sorted ``tree_leaves`` does."""
    params, _, _ = _key_inputs()
    got = decode_graph.leaves(params)
    want = adamw.tree_leaves(params)
    assert sorted(map(id, got)) == sorted(map(id, want))


def test_counters_reset_with_the_default_registry():
    """The counters live in the default registry: a reset starts them
    from zero."""
    model, params, caches, toks = _prefilled("deepseek-7b", "cpu")
    step = model.make_decode_step()
    obs_metrics.reset_default_registry()
    step(params, caches, toks[:, :1])
    step(params, caches, toks[:, 1:2])
    assert _counts(obs_metrics.default_registry())["eager_steps"] == 2
    reg = obs_metrics.reset_default_registry()
    assert reg.names() == []
    step(params, caches, toks[:, 2:3])
    assert _counts(reg) == {"captures": 0, "replays": 0, "eager_steps": 1}
    obs_metrics.reset_default_registry()


# ---------------------------------------------------------------------------
# the graph on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _equal_steps(model, params, caches, toks, window, steps, restart_at,
                 step=None):
    """Decode ``steps`` tokens with the graph (``step``, default a fresh
    closure) and eagerly on a clone of ``caches``, feeding both the
    eager argmax; at ``restart_at`` both restart (new ``len`` tensors at
    the prompt length, the next column of ``toks`` as fresh tokens).
    Every step's logits and every layer's K/V and ``len`` must be equal
    bit for bit.  Returns the graph side's caches."""
    cfg = model.cfg
    step = step or model.make_decode_step(window=window)
    ref = _clone(caches)
    P = int(caches[0]["len"][0])
    tok = toks[:, :1]
    for i in range(steps):
        if i == restart_at:
            for side in (caches, ref):
                for c in side:
                    c["len"] = torch.full_like(c["len"], P)
            tok = toks[:, 1:2]
        want, ref = transformer.decode_step(params, cfg, ref, tok,
                                            window=window)
        got, caches = step(params, caches, tok)
        assert torch.equal(got, want), f"step {i}: logits differ"
        for c, r in zip(caches, ref):
            for n in ("k", "v", "len"):
                assert torch.equal(c[n], r[n]), f"step {i}: {n} differs"
        tok = want[:, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    return caches, step


@pytest.mark.cuda
@pytest.mark.parametrize("arch, window", [("deepseek-7b", 0),
                                          ("granite-moe-3b-a800m", 0),
                                          ("deepseek-7b", 12)])
def test_graph_step_equals_eager(card, registry, arch, window):
    """Dense, MoE and sliding-window steps: 20 steps, a restart at step
    10, the graph's logits and K/V those of the eager step bit for bit;
    one warm-up step, one capture, 19 replays."""
    model, params, caches, toks = _prefilled(arch, card, B=4, P=32)
    _equal_steps(model, params, caches, toks, window, 20, 10)
    torch.cuda.synchronize()
    assert _counts(registry) == {"captures": 1, "replays": 19,
                                 "eager_steps": 1}


@pytest.mark.cuda
def test_new_kv_storage_is_captured_anew(card, registry):
    """Caches moved to new storage get a new warm-up and capture, and
    the replays stay equal to the eager step."""
    model, params, caches, toks = _prefilled("deepseek-7b", card, B=4, P=32)
    caches, step = _equal_steps(model, params, caches, toks, 0, 4, 99)
    _equal_steps(model, params, _clone(caches), toks[:, 2:], 0, 4, 99,
                 step=step)
    assert _counts(registry) == {"captures": 2, "replays": 6,
                                 "eager_steps": 2}


@pytest.mark.cuda
def test_launches_advance_across_replays(card, registry):
    """``decode_ops.launches`` advances by one per attention layer and
    step, replays included (their Python does not run)."""
    model, params, caches, toks = _prefilled("deepseek-7b", card, B=4, P=32)
    step = model.make_decode_step()
    before = decode_ops.launches
    tok = toks[:, :1]
    for _ in range(8):
        logits, caches = step(params, caches, tok)
        tok = logits[:, :model.cfg.vocab_size].argmax(-1).to(
            torch.int32)[:, None]
    torch.cuda.synchronize()
    assert decode_ops.launches - before == model.cfg.num_layers * 8
    assert _counts(registry)["replays"] == 7
