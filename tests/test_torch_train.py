"""The port's resilient LM training against the JAX package.

Reduced deepseek-7b and qwen3-32b, both initialised from the same seed
(the port's parameters equal the reference's bit for bit,
tests/test_torch_lm_init.py).  Tolerances:

* one ``train_step``: ``loss``, ``per_example_nll`` and ``grad_norm``,
  and every gradient leaf by relative L2, within 2e-2 — the LM
  tolerance of tests/test_torch_lm.py (the forward runs bf16 products,
  summed in another order than XLA's);
* ``adamw_update``, ``sgd_update``, ``clip_by_global_norm`` and the
  schedules on the same float32 inputs within 1e-6 relative;
* the ``resilient`` bookkeeping on the same numpy inputs, the corpus,
  its batches and ``make_batch``: equal;
* ``train.run`` at the reference's smoke defaults with ``--steps 30
  --noise 0.1 --resilient --check-every 10``: the same logged steps,
  every loss and grad norm within 2e-2, the quarantine stats equal.
"""

import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.core import resilient as j_res
from repro.data import pipeline as j_pipe
from repro.launch import train as j_train
from repro.models import build as j_build
from repro.models import model as j_model
from repro.optim import adamw as j_adamw
from repro_torch import configs, convert, models
from repro_torch.ckpt import restore_pytree
from repro_torch.core import prng, resilient
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import model as p_model
from repro_torch.optim import adamw

torch.set_num_threads(1)

TOL = 2e-2
OPT_TOL = 1e-6


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@functools.cache
def _setup(arch):
    jcfg = j_base.reduced(j_base.get_config(arch))
    cfg = configs.reduced(configs.get_config(arch))
    return jcfg, cfg, j_build(jcfg), models.build(cfg)


def _batch(cfg, B=4, S=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.1).astype(np.float32)
    w = np.array([1.0, 0.5, 0.25, 1.0], np.float32)[:B]
    alive = np.array([1.0, 1.0, 0.0, 1.0], np.float32)[:B]
    return dict(tokens=toks, labels=labels, loss_mask=mask, weights=w,
                alive=alive)


@pytest.mark.parametrize("arch", ["deepseek-7b", "qwen3-32b"])
def test_train_step_matches_reference(arch):
    jcfg, cfg, jm, pm = _setup(arch)
    nb = _batch(cfg)
    jparams = jm.init(jax.random.key(0))
    params = pm.init(0, "cpu")
    (jtotal, jmet), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    jstep = jax.jit(jm.make_train_step(lr=1e-3, warmup=10,
                                       total_steps=30))
    jnew, _, jm2 = jstep(jparams, j_adamw.adamw_init(jparams),
                         {k: jnp.asarray(v) for k, v in nb.items()})
    step = pm.make_train_step(lr=1e-3, warmup=10, total_steps=30)
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    new, opt, met = step(params, adamw.adamw_init(params), tb)
    assert abs(float(met["loss"]) - float(jmet["loss"])) <= TOL * abs(
        float(jmet["loss"]))
    assert _rel(met["per_example_nll"], jmet["per_example_nll"]) <= TOL
    assert abs(float(met["grad_norm"]) - float(jm2["grad_norm"])) <= TOL * \
        float(jm2["grad_norm"])
    assert float(met["aux_loss"]) == 0.0 and int(opt["step"]) == 1
    np.testing.assert_allclose(float(met["lr"]), float(jm2["lr"]),
                               rtol=OPT_TOL)
    # every gradient leaf (the reference's, un-clipped, against the
    # port's own autograd of its loss)
    tracked = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
    total, _ = pm.loss_fn(tracked, tb)
    leaves = adamw.tree_leaves(tracked)
    grads = torch.autograd.grad(total, leaves)
    want = adamw.tree_leaves(convert.lm_params_from_jax(
        jax.device_get(jgrads), cfg, "cpu"))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert _rel(g.numpy(), w.numpy()) <= TOL
    # and the updated parameters
    for a, b in zip(adamw.tree_leaves(new), adamw.tree_leaves(
            convert.lm_params_from_jax(jax.device_get(jnew), cfg, "cpu"))):
        assert _rel(a.numpy(), b.numpy()) <= TOL


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    want = j_model.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(mask))
    got = p_model.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OPT_TOL,
                               atol=OPT_TOL)


def test_train_step_refuses_the_flash_model():
    _, cfg, _, _ = _setup("deepseek-7b")
    with pytest.raises(ValueError, match="use_flash=False"):
        models.build(cfg, use_flash=True).make_train_step()


def test_remat_gives_the_same_gradients():
    _, cfg, _, pm = _setup("deepseek-7b")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = []
    for remat in (False, True):
        m = models.build(dataclasses.replace(cfg, remat=remat))
        params = adamw.tree_map(lambda p: p.requires_grad_(True),
                                m.init(0, "cpu"))
        total, _ = m.loss_fn(params, tb)
        out.append(torch.autograd.grad(total, adamw.tree_leaves(params)))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ optim

def _tree(seed, shapes=((3, 5), (7,), (2, 2, 4))):
    rng = np.random.default_rng(seed)
    return {"b": [rng.standard_normal(s).astype(np.float32) for s in shapes],
            "a": {"w": rng.standard_normal((4, 3)).astype(np.float32)}}


def _to_torch(t):
    return adamw.tree_map(lambda a: torch.from_numpy(np.array(a)), t)


def _close_trees(got, want, rtol=OPT_TOL):
    g, w = adamw.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(0)
    jc, jn = j_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                         max_norm)
    pc, pn = adamw.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(pn), float(jn), rtol=OPT_TOL)
    _close_trees(pc, jc)


def test_schedules_match_reference():
    for step in (0, 1, 5, 9, 10, 11, 57, 200, 250):
        for warm, total in ((10, 200), (1, 30), (100, 10_000)):
            np.testing.assert_allclose(
                float(adamw.linear_warmup_cosine(step, 3e-4, warm, total)),
                float(j_adamw.linear_warmup_cosine(jnp.int32(step), 3e-4,
                                                   warm, total)),
                rtol=OPT_TOL)
        np.testing.assert_allclose(
            float(adamw.cosine_schedule(step, 1e-3, 120)),
            float(j_adamw.cosine_schedule(jnp.int32(step), 1e-3, 120)),
            rtol=OPT_TOL)


def test_adamw_and_sgd_updates_match_reference():
    p, g = _tree(1), _tree(2)
    jp, jg = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g)
    js = j_adamw.adamw_init(jp)
    ps = adamw.adamw_init(_to_torch(p))
    tp, tg = _to_torch(p), _to_torch(g)
    for lr in (1e-3, 3e-4, 1e-2):                    # three steps
        jp, js = j_adamw.adamw_update(jp, jg, js, lr=lr)
        tp, ps = adamw.adamw_update(tp, tg, ps, lr=lr)
    assert int(ps["step"]) == int(js["step"]) == 3
    _close_trees(tp, jp)
    _close_trees(ps["m"], js["m"])
    _close_trees(ps["v"], js["v"])
    sp, ss = _to_torch(p), adamw.sgd_init(_to_torch(p))
    jp2, js2 = jax.tree.map(jnp.asarray, p), j_adamw.sgd_init(
        jax.tree.map(jnp.asarray, p))
    for _ in range(2):
        sp, ss = adamw.sgd_update(sp, tg, ss, lr=0.1, weight_decay=0.01)
        jp2, js2 = j_adamw.sgd_update(jp2, jg, js2, lr=0.1,
                                      weight_decay=0.01)
    _close_trees(sp, jp2)
    _close_trees(ss["mom"], js2["mom"])


# -------------------------------------------------------------- resilient

def _stream(mod, cfg, noisy_ids, steps, seed, dup=False):
    """tests/test_resilient_quarantine.py's NLL stream, through ``mod``."""
    rng = np.random.default_rng(seed)
    state = mod.init_state(cfg)
    N = cfg.num_examples
    noisy = np.zeros(N, bool)
    noisy[noisy_ids] = True
    for step in range(1, steps + 1):
        ids = rng.choice(N, size=128, replace=dup)
        nll = np.where(noisy[ids], 3.0, 0.5) + rng.normal(0.0, 0.05, 128)
        state = mod.update(state, ids, nll.astype(np.float32), cfg, step)
    return state


@pytest.mark.parametrize("case", ["planted", "clean", "deterministic",
                                  "duplicates"])
def test_resilient_bookkeeping_equals_reference(case):
    n, noisy, steps, seed = {
        "planted": (1024, np.arange(0, 1024, 25), 600, 0),
        "clean": (1024, np.array([], int), 600, 1),
        "deterministic": (512, np.arange(0, 512, 20), 400, 3),
        "duplicates": (512, np.arange(0, 512, 16), 300, 4)}[case]
    kw = dict(num_examples=n, coreset_size=64 if n == 1024 else 32,
              check_every=50)
    want = _stream(j_res, j_res.ResilientConfig(**kw), noisy, steps, seed,
                   dup=case == "duplicates")
    got = _stream(resilient, resilient.ResilientConfig(**kw), noisy, steps,
                  seed, dup=case == "duplicates")
    for f in ("hits", "alive", "nll_ema", "seen"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert len(got.quarantined_at) == len(want.quarantined_at)
    for (t1, q1), (t2, q2) in zip(got.quarantined_at, want.quarantined_at):
        assert t1 == t2
        np.testing.assert_array_equal(q1, q2)
    assert resilient.quarantine_stats(got, noisy) == \
        j_res.quarantine_stats(want, noisy)
    if case == "planted":
        assert resilient.quarantine_stats(got, noisy)["noise_recall"] >= 0.9


def test_batch_weights_equal_reference():
    kw = dict(num_examples=16, mw_enabled=True, mw_loss_weighting=True,
              mw_cap_bits=3)
    js, ps = (j_res.init_state(j_res.ResilientConfig(**kw)),
              resilient.init_state(resilient.ResilientConfig(**kw)))
    for s in (js, ps):
        s.hits[:] = np.arange(16)
        s.alive[10] = False
    ids = np.array([0, 1, 2, 3, 9, 10, 15])
    for on in (True, False):
        kw2 = dict(kw, mw_loss_weighting=on)
        jw, ja = j_res.batch_weights(js, ids, j_res.ResilientConfig(**kw2))
        pw, pa = resilient.batch_weights(
            ps, ids, resilient.ResilientConfig(**kw2), "cpu")
        assert pw.dtype == pa.dtype == torch.float32
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))


# ------------------------------------------------------------------- data

def test_corpus_batches_and_make_batch_equal_reference():
    for noise in (0.0, 0.1):
        kw = dict(vocab_size=512, seq_len=16, num_examples=300,
                  noise_frac=noise, seed=3)
        jc = j_pipe.SyntheticCorpus(j_pipe.DataConfig(**kw))
        pc = pipeline.SyntheticCorpus(pipeline.DataConfig(**kw))
        for f in ("successors", "tokens", "labels", "noisy_ids", "ids"):
            np.testing.assert_array_equal(getattr(pc, f), getattr(jc, f))
        alive = np.ones(300, bool)
        alive[::3] = False
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        for a in (None, alive):
            jb = jc.batch(r1, 40, alive=a)
            pb = pc.batch(r2, 40, alive=a, device="cpu")
            np.testing.assert_array_equal(pb["ids"], np.asarray(jb["ids"]))
            for f in ("tokens", "labels", "loss_mask"):
                np.testing.assert_array_equal(pb[f].numpy(),
                                              np.asarray(jb[f]))
    cfg = configs.reduced(configs.get_config("deepseek-7b"))
    for seed in (0, 4):
        jb = j_pipe.make_batch(jax.random.key(seed), cfg, 3, 11)
        pb = pipeline.make_batch(prng.key(seed), cfg, 3, 11)
        for f in jb:
            np.testing.assert_array_equal(pb[f].numpy(), np.asarray(jb[f]))


# ------------------------------------------------------------------ train

def _run_both(argv):
    args = train.build_parser().parse_args(argv + ["--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        want = j_train.run(args)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = train.run(args)
    return got, want, out.getvalue()


def test_train_run_matches_reference():
    got, want, out = _run_both(["--steps", "30", "--noise", "0.1",
                                "--resilient", "--check-every", "10",
                                "--log-every", "5"])
    assert [r["step"] for r in got["history"]] == \
        [r["step"] for r in want["history"]] == [5, 10, 15, 20, 25, 30]
    for a, b in zip(got["history"], want["history"]):
        for f in ("loss", "grad_norm"):
            assert abs(a[f] - b[f]) <= TOL * abs(b[f]), (a, b)
        for f in ("quarantined", "alive", "noise_recall",
                  "noise_precision"):
            assert a[f] == b[f], (f, a, b)
    for f in ("final_train_loss", "clean_eval_loss"):
        assert abs(got[f] - want[f]) <= TOL * abs(want[f])
    same = {k for k in want if k not in ("history", "final_train_loss",
                                          "clean_eval_loss")}
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert got["kernel_launches"] == {"flash_attention": 0}
    assert got["device"] == "cpu"
    assert len(out.strip().splitlines()) == len(got["history"]) + 1


def test_train_cli_flags_and_checkpoints(tmp_path):
    args = train.build_parser().parse_args([])
    assert (args.smoke, args.steps, args.batch, args.arch) == (
        True, 200, 32, "deepseek-7b")
    assert train.build_parser().parse_args(["--no-smoke"]).smoke is False
    ck = tmp_path / "ck"
    args = train.build_parser().parse_args(
        ["--steps", "2", "--batch", "4", "--seq-len", "16",
         "--num-examples", "64", "--ckpt-dir", str(ck), "--ckpt-every", "1",
         "--device", "cpu"])
    with contextlib.redirect_stdout(io.StringIO()):
        res = train.run(args)
    assert res["steps"] == 2 and np.isfinite(res["final_train_loss"])
    tree, meta = restore_pytree(str(ck / "ckpt_00000002.msgpack"),
                                device="cpu")
    assert meta["step"] == 2
    assert int(tree["opt"]["step"].reshape(-1)[0]) == 2
