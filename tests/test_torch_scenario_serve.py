"""``serve --workload classify --scenario …``: the port ≡ the JAX package.

The port's JSON line and every per-task report field (``errors``,
``opt``, ``guarantee_ok``, ``attempts``, ``disputed``,
``contradicted``, both recalls, ``bits``; ``survivors`` under an
infrastructure adversary) must equal ``repro.launch.serve.
run_classify``'s on the CPU, timings and the port's own fields
(``device``, ``steps``, ``kernel_launches``, ``reports_s``) aside.  The
reference's reports are recorded as its ``run_classify`` makes them.
Shards stay clear of 250–300 points (the reference's sampled-coreset
fault, ROADMAP queue 3); the tree case first probes that this host's
XLA sums histograms in the port's order, as the engine tests do.
"""

import pytest
import torch

from repro.core import scenarios as j_scen
from repro.launch import serve as j_serve
from repro_torch.core import scenarios
from repro_torch.launch import serve

from test_torch_feature_engine import _probe_histogram_order

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

PORT_ONLY = {"device", "steps", "kernel_launches", "reports_s"}
TIMINGS = {"wall_s", "tasks_per_s"}
CASES = {
    "thresholds-targeted_heavy": ["--cls", "thresholds", "--domain", "64",
                                  "--scenario", "targeted_heavy",
                                  "--noise", "8", "--batch", "3"],
    "stumps-boundary": ["--cls", "stumps", "--features", "4", "--scenario",
                        "boundary", "--noise", "8", "--batch", "2"],
    "stumps-byzantine": ["--cls", "stumps", "--features", "4",
                         "--scenario", "byzantine", "--batch", "3"],
    "tree-xor": ["--cls", "tree", "--features", "4", "--tree-bins", "8",
                 "--scenario", "xor", "--noise", "4", "--batch", "2"],
    "thresholds-dropout": ["--cls", "thresholds", "--scenario", "dropout",
                           "--noise", "4", "--batch", "3"],
    "stumps-dropout": ["--cls", "stumps", "--features", "4", "--scenario",
                       "dropout", "--noise", "8", "--batch", "2"],
    "stumps-flaky": ["--cls", "stumps", "--features", "4", "--scenario",
                     "flaky", "--noise", "4", "--batch", "2"],
}


def _recording(monkeypatch, name, into):
    fn = getattr(j_scen, name)

    def record(*a, **kw):
        into.append(fn(*a, **kw))
        return into[-1]

    monkeypatch.setattr(j_scen, name, record)


@pytest.mark.parametrize("case", list(CASES))
def test_scenario_serve_equals_the_reference(case, monkeypatch):
    argv = ["--workload", "classify", "--m", "512", "--k", "4"] + CASES[case]
    if case.startswith("tree"):
        _probe_histogram_order(2, 4, 8)
    ref_reports = []
    for name in ("scenario_report", "infra_report"):
        _recording(monkeypatch, name, ref_reports)
    ref = j_serve.run_classify(j_serve.build_parser().parse_args(argv))
    # the reference runs the engine twice (compile, then timed) but
    # reports once
    out, res, ts, reports = serve.run_classify(
        serve.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert out["ok"] >= 1, out
    assert {k: v for k, v in out.items() if k not in PORT_ONLY | TIMINGS} \
        == {k: v for k, v in ref.items() if k not in TIMINGS}
    assert reports == ref_reports
    assert len(reports) == out["ok"]
    assert out["kernel_launches"] == {"mw_update": 0, "histogram": 0,
                                      "stump": 0}
    assert out["reports_s"] >= 0
    for r in reports:
        assert r["guarantee_ok"] and r["errors"] <= r["opt"], r
    # one task's report alone, its OPT computed by itself, is the same
    b = int(res.ok.argmax())
    if "survivors" in out:
        spec = scenarios.InfraSpec(name=out["scenario"], player=1,
                                   drop_round=5, rejoin_round=13)
        alone = scenarios.infra_report(ts[b], res, b, spec, device="cpu")
    else:
        alone = scenarios.scenario_report(ts[b], res, b, device="cpu")
    assert alone == reports[0]
    if "--cls" in argv and argv[argv.index("--cls") + 1] == "stumps" \
            and "boundary" in argv:
        assert all(r["opt"] <= out["noise"] for r in reports)


def test_scenario_serve_refuses_what_the_reference_refuses():
    base = ["--workload", "classify", "--device", "cpu", "--m", "64"]
    for flags in (["--scenario", "xor"],
                  ["--cls", "tree", "--tree-depth", "1", "--scenario",
                   "xor"],
                  ["--cls", "tree", "--features", "1", "--scenario",
                   "checkerboard", "--tree-depth", "4"]):
        with pytest.raises(SystemExit):
            serve.run_classify(serve.build_parser().parse_args(base + flags))
    with pytest.raises(SystemExit):
        serve.build_parser().parse_args(base + ["--scenario", "gaussian"])
    args = serve.build_parser().parse_args(
        base + ["--cls", "stumps", "--features", "2", "--scenario",
                "targeted_heavy"])
    with pytest.raises(ValueError, match="duplicated points"):
        serve.run_classify(args)
