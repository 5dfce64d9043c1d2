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
    assert out["device"] == "cpu" and out["kernel_launches"] == 0
    assert out["steps"] > 0 and out["tasks_per_s"] > 0


@pytest.mark.parametrize("flags,item", [
    (["--engine", "sharded"], "item 9"),
    (["--scenario", "byzantine"], "item 11"),
    (["--cls", "tree"], "item 8"),
])
def test_serve_names_the_queue_item_of_what_is_not_ported(flags, item):
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--batch", "1", "--m", "64"] + flags)
    with pytest.raises(NotImplementedError, match=item):
        serve.run_classify(args)
