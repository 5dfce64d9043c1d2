"""The port stands alone: no jax, no repro, no silent CPU fallback."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.core import batched, prng, scenarios, tasks, weak
from repro_torch.core.types import BoostConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.mw_update import ops as mw_ops
from repro_torch.kernels.stump import ops as stump_ops
from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
missing = sorted(set(NEW) - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 15 else 0)
"""
# the modules of the scenario slice, which the walk must reach
NEW = ("repro_torch.core.scenarios", "repro_torch.core.tasks",
       "repro_torch.kernels.stump.kernel", "repro_torch.kernels.stump.ops",
       "repro_torch.kernels.stump.ref")


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c",
                           f"NEW = {NEW!r}\n" + _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for "
                    "hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    x = np.zeros((1, 2, 8), np.int32)
    y = np.ones((1, 2, 8), np.int8)
    cfg = BoostConfig(k=2, coreset_size=4, domain_size=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched.run_accurately_classify_batched(x, y, prng.key(0), cfg,
                                                weak.Thresholds(n=16))
    assert resolve_device("cpu").type == "cpu"
    hits = torch.zeros((1, 8), dtype=torch.int32)
    mask = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mw_ops.mw_update(hits, mask, mask, interpret=False)
    feats = torch.zeros((1, 8, 2))
    w = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        hist_ops.node_histograms(feats, w, w, 4, interpret=False)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        stump_ops.stump_scores(feats, w[:, 0], torch.zeros((1, 2, 3)),
                               interpret=False)
    args = serve.build_parser().parse_args(
        ["--workload", "classify", "--cls", "stumps", "--scenario",
         "dropout", "--m", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run_classify(args)


def test_opt_and_reports_default_to_the_card():
    """OPT and the guarantee reports run where the entry points do:
    called without a device on a host with no card, they raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for "
                    "hosts without one")
    cls = weak.AxisStumps(num_features=2)
    task = tasks.make_task(cls, m=16, k=2, noise=1, seed=0)
    none_ok = SimpleNamespace(ok=np.zeros(1, bool))
    spec = scenarios.InfraSpec(name="dropout", player=1, drop_round=1)
    for call in (lambda: tasks.true_opt(task),
                 lambda: tasks.opt_counts(cls, task.flat_x[None],
                                          task.flat_y[None]),
                 lambda: scenarios.planted_errors(task),
                 lambda: scenarios.class_floor(task),
                 lambda: scenarios.scenario_reports([task], none_ok),
                 lambda: scenarios.infra_reports([task], none_ok, spec)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tasks.true_opt(task, "cpu") == \
        scenarios.class_floor(task, device="cpu") <= 1


def test_lm_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the check is for "
                    "hosts without one")
    cfg = configs.reduced(configs.get_config("deepseek-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.build(cfg, use_flash=True).init(seed=0)
    args = serve.build_parser().parse_args(["--workload", "lm"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run_lm(args)
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_ops.flash_attention(q, q, q, interpret=False)
