"""The port stands alone: no jax, no repro, no silent CPU fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.core import batched, prng, weak
from repro_torch.core.types import BoostConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.histogram import ops as hist_ops
from repro_torch.kernels.mw_update import ops as mw_ops
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
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
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
