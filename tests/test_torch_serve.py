"""``python -m repro_torch.launch.serve`` on the CPU: ``--workload
classify`` and ``lm`` (``serve-stream`` is tests/test_torch_scheduler.py's)."""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serve_classify_cpu_prints_one_json_line():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "classify", "--device", "cpu", "--batch", "3", "--m", "256",
         "--noise", "1"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["ok"] == out["batch"] == 3
    assert out["device"] == "cpu"
    assert out["kernel_launches"] == {"mw_update": 0, "histogram": 0,
                                      "stump": 0}
    assert out["steps"] > 0 and out["tasks_per_s"] > 0


@pytest.mark.parametrize("flags", [
    ["--cls", "stumps", "--features", "4", "--k", "2", "--m", "128",
     "--coreset", "64", "--noise", "1"],
    ["--cls", "tree", "--features", "4", "--tree-depth", "2",
     "--tree-bins", "8", "--comm-mode", "voting", "--m", "256",
     "--noise", "2"],
], ids=["stumps", "tree"])
def test_serve_feature_track_cpu_prints_one_json_line(flags):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "classify", "--device", "cpu", "--batch", "2"] + flags, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["class"] == flags[1] and out["batch"] == 2
    assert 1 <= out["ok"] <= 2 and out["steps"] > 0
    assert out["kernel_launches"] == {"mw_update": 0, "histogram": 0,
                                      "stump": 0}


def test_serve_lm_cpu_prints_one_json_line():
    """The default workload is lm, as in the reference; on the CPU the
    flash wrapper runs its plain version, so the kernel launches 0
    times."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["arch"] == "deepseek-7b-smoke"
    assert (out["batch"], out["prompt_len"], out["generated"]) == (2, 16, 3)
    assert out["device"] == "cpu" and out["flash"] is True
    assert out["tokens_finite"] and len(out["sample"]) == 4
    assert all(0 <= t < 512 for t in out["sample"])
    assert out["kernel_launches"] == {"flash_attention": 0,
                                      "decode_attention": 0}


def test_serve_lm_flags_parse_as_in_the_reference():
    ap = serve.build_parser()
    args = ap.parse_args([])
    assert (args.workload, args.arch, args.smoke) == ("lm", "deepseek-7b",
                                                      True)
    assert ap.parse_args(["--smoke"]).smoke is True
    assert ap.parse_args(["--no-smoke"]).smoke is False
    args = ap.parse_args(["--arch", "qwen3-32b", "--device", "cpu",
                          "--batch", "1", "--prompt-len", "8", "--gen",
                          "2"])
    out, run = serve.run_lm(args)
    assert out["arch"] == "qwen3-32b-smoke"
    assert run.prefill_logits.shape == (1, 512)
    assert run.generated.shape == (1, 3)
