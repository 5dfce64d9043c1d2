"""The harness on the CPU at test sizes: a run end to end, a cell and a
metric added as files alone, the check failing for the control and for
each fault the cells can have, and ``BENCHMARK.json`` against its
files.

The test cells (``tests/data``) are tiny models (two layers, width 64)
whose limits are set from CPU readings at that size, as the chip
cells' are from chip readings: over seeds 1–3 the program read
``logit_rel_l2`` 0.0047–0.0076 and ``token_gap`` ≤ 0.0161, the control
0.046–0.067 and 0–0.19; so 0.02 and 0.06.  Over 300 batches of the
test seed the dense cell's program reads at most 0.0069 and the control
at least 0.0383; the MoE cell runs its products in float32 (see
``execute``).
"""

import contextlib
import copy
import json
import math
import time

import pytest
import torch

from portbench import check, run, spec
from portbench.tests.precision import float32_products

torch.set_num_threads(1)

DATA = spec.PKG / "tests" / "data"
SEED = 2**31 + 5
CELLS = {"tiny-dense.prefill": ("tiny-dense", "tiny-prefill"),
         "tiny-moe.prefill": ("tiny-moe", "tiny-prefill"),
         "tiny-dense.decode": ("tiny-dense", "tiny-decode")}
BENCH = {
    "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1}
                  for n, (c, t) in CELLS.items()],
    "end_to_end": [
        {"name": "ttft_p90_ms", "unit": "ms",
         "workloads": ["tiny-dense.prefill", "tiny-moe.prefill"]},
        {"name": "tokens_per_s", "unit": "tokens/s"},
        {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": "device_idle.prefill", "unit": "%",
                   "moves": "ttft_p90_ms"}]}


def execute(name, bench=BENCH, dirs=(DATA, spec.PKG), trace=False, **kw):
    cell = spec.cell(bench, name, dirs=dirs)
    # The tiny MoE in bf16 flips a routing choice at a near tie in about
    # 3 % of its batches (logit_rel_l2 0.023-0.054 over 300 batches, where
    # the fp8 control reads 0.038 at the least), so no limit parts the
    # two at this size and the sampled batches would decide the test; its
    # products run in float32 (0.0000 over the same 300 batches), so the
    # test is about the harness.
    moe_in_f32 = cell.config["arch_type"] == "moe"
    with float32_products() if moe_in_f32 else contextlib.nullcontext():
        return run.execute(cell, SEED, 0.3, trace, device="cpu",
                           process_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_sound_run_is_correct(name):
    r = execute(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == ({"ttft_p90_ms", "tokens_per_s", "setup_s"}
                                 if "prefill" in name
                                 else {"tokens_per_s", "setup_s"})
    assert list(r)[-1] == "checks"


def test_a_cell_and_a_metric_appear_by_adding_files(tmp_path):
    """A new traffic mix, cell and per-layer metric are new files and
    new entries; no file of the harness changes."""
    for kind in ("traffic", "workloads", "metrics"):
        (tmp_path / kind).mkdir()
    (tmp_path / "traffic" / "tiny-prefill-b3.json").write_text(json.dumps(
        {"driver": "lm_prefill", "batch": 3, "prompt_len": 32}))
    (tmp_path / "workloads" / "tiny-dense.prefill-b3.json").write_text(
        (DATA / "workloads" / "tiny-dense.prefill.json").read_text())
    (tmp_path / "metrics" / "batches.prefill.py").write_text(
        "def read(run):\n    return float(run.stats['batches'])\n")
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "tiny-dense.prefill-b3",
                               "config": "tiny-dense",
                               "traffic": "tiny-prefill-b3", "chips": 1})
    bench["per_layer"].append({"name": "batches.prefill", "unit": "count",
                               "moves": "ttft_p90_ms",
                               "workloads": ["tiny-dense.prefill-b3"]})
    r = execute("tiny-dense.prefill-b3", bench=bench,
                dirs=(tmp_path, DATA, spec.PKG), trace=True)
    assert r["correct"]
    assert r["metrics"]["batches.prefill"]["value"] * 3 == r["attempted"]
    # a reader that finds nothing (no device here) leaves its metric out
    assert "device_idle.prefill" not in r["metrics"]
    assert r["breakdown"]["device_ops"] == []


class Broken:
    """The model with its steps broken underneath the harness."""

    def __init__(self, model, fault):
        self._m, self.fault = model, fault
        self.cfg, self.use_flash = model.cfg, model.use_flash
        self._last = None

    def init(self, *a, **kw):
        return self._m.init(*a, **kw)

    def init_serve_cache(self, *a, **kw):
        return self._m.init_serve_cache(*a, **kw)

    def _answer(self, logits):
        if self.fault == "half":             # half the batch left out
            half = logits.shape[0] // 2
            logits = logits.clone()
            logits[half:] = logits[:half].mean(0)
        if self.fault == "token":            # a token altered where produced
            logits = logits.clone()
            logits[-1] = logits[-1].roll(1)
        return logits

    def make_prefill_step(self):
        step = self._m.make_prefill_step()

        def prefill(params, batch):
            logits, caches = step(params, batch)
            if self.fault == "unchanged":    # the previous call's answer
                logits, self._last = (logits if self._last is None
                                      else self._last), logits
            return self._answer(logits), caches
        return prefill

    def make_decode_step(self):
        step = self._m.make_decode_step()

        def decode(params, caches, tokens):
            if self.fault == "unchanged":    # the cache is not advanced
                kept = [{k: v.clone() for k, v in c.items()} for c in caches]
                logits, _ = step(params, caches, tokens)
                for c, k in zip(caches, kept):
                    c.update(k)
                return logits, caches
            logits, caches = step(params, caches, tokens)
            return self._answer(logits), caches
        return decode


@pytest.mark.parametrize("fault", ["unchanged", "half", "token"])
@pytest.mark.parametrize("name", ["tiny-dense.prefill", "tiny-moe.prefill",
                                  "tiny-dense.decode"])
def test_a_broken_step_is_not_correct(name, fault):
    """Each fault a single-chip serving cell can have (no exchange
    between chips exists on one card)."""
    r = execute(name, wrap_model=lambda m: Broken(m, fault))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["tiny-moe.prefill", "tiny-dense.decode"])
def test_the_control_is_not_correct(name):
    """The reference in float8 products, put in the program's place,
    fails the cell's limits, and reads at least three times the
    program."""
    r = execute(name, control=True)
    assert r["correct"]
    limits = r["checks"]
    control_ok, _ = check.verdict(
        r["control"], {k: c["limit"] for k, c in limits.items()}, True)
    assert not control_ok, r["control"]
    assert max(r["control"][k] / c["value"] for k, c in limits.items()
               if c["value"] > 0) >= 3


def test_the_configs_state_what_the_port_runs():
    """Each chip configuration file equals the port's registered
    config, cuts nothing, and gives a key where the port departs from
    the source with the published value under ``departs``; a key the
    port has not, or a multiplier it does not run, is refused."""
    from repro_torch import configs

    bench = spec.benchmark()
    for c in bench["configs"]:
        config = spec.load_json(spec.ROOT / c["file"])
        assert spec.port_config(config) == configs.get_config(
            config["port_config"])
        assert config["reduced"] == c["reduced"] == []
        for key, published in config["departs"].items():
            assert config[key] != published
    config = spec.load_json(spec.PKG / "configs" / "granite-moe-3b-a800m.json")
    with pytest.raises(KeyError):
        spec.port_config(dict(config, shared_expert=1))
    with pytest.raises(ValueError):
        spec.port_config(dict(config, residual_multiplier=0.22))


def test_every_cell_has_its_files_and_readers():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert cell.driver().run and cell.reference().logits
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
        limits = cell.workload["check"]["limits"]
        assert limits and set(limits) <= {"token_gap", "logit_rel_l2"}


def test_benchmark_json_keeps_to_its_form():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            reported = {x["name"] for x in spec.cell_metrics(bench, w)[0]}
            assert m["moves"] in reported
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert math.isfinite(bench["run_seconds"])


def test_result_fields_are_plain_json():
    r = execute("tiny-dense.decode")
    assert json.loads(json.dumps(r)) == r
