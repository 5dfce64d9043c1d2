"""``python -m repro_torch.launch.serve --workload classify`` on the CPU."""

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
    assert out["kernel_launches"] == {"mw_update": 0, "histogram": 0}
    assert out["steps"] > 0 and out["tasks_per_s"] > 0


@pytest.mark.parametrize("flags,item", [
    (["--engine", "sharded"], "item 9"),
    (["--scenario", "byzantine"], "item 11"),
    (["--cls", "tree", "--scenario", "xor"], "item 11"),
])
def test_serve_names_the_queue_item_of_what_is_not_ported(flags, item):
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--batch", "1", "--m", "64"] + flags)
    with pytest.raises(NotImplementedError, match=item):
        serve.run_classify(args)


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
    assert out["kernel_launches"] == {"mw_update": 0, "histogram": 0}
