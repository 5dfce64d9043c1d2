"""The port's scenarios ≡ the JAX package's (repro.core.scenarios).

Task construction is numpy in both packages (labels from each
package's own ``predict``), so the same seeds must give identical
arrays: ``x``, ``y``, ``flipped``, ``noise_count``, ``target_params``
and the scenario's name, for every noise adversary on every class it
admits, and for every planted tree concept under each corruptor; an
adversary a sample cannot carry (``targeted_heavy`` on a continuous
sample) is refused by both.  The infrastructure schedules, the point
sets behind the quarantine recalls (which the port finds by sorting
rows, not by the reference's m × m compare), the planted concept's
errors and the class floors (stumps through the stump kernel's exact
counts, trees through the greedy ERM) must be equal too.  The serve
path's reports are held to the reference in
tests/test_torch_scenario_serve.py.
"""

import numpy as np
import pytest
import torch

from repro.core import scenarios as j_scen
from repro.core import tasks as j_tasks
from repro.core import weak as j_weak
from repro_torch.core import scenarios, tasks, weak

# the inputs are small: torch's intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

M, K = 512, 4
CLASSES = {                      # name → make_class keywords
    "thresholds": dict(n=1 << 12),
    "thresholds_small_domain": dict(n=64),
    "intervals": dict(n=1 << 12),
    "singletons": dict(n=64),
    "stumps": dict(num_features=4),
    "tree": dict(num_features=4, tree_depth=2, tree_bins=8),
}


def _classes(name, **kw):
    kw = {**CLASSES[name], **kw}
    base = name.split("_")[0]
    return j_weak.make_class(base, **kw), weak.make_class(base, **kw)


def _assert_tasks_equal(ref, got):
    for f in ("x", "y", "target_params", "flipped"):
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, f)
    assert ref.noise_count == got.noise_count
    assert ref.scenario == got.scenario


def _both(fn_ref, fn_port):
    """Both results, or both refusals (a ValueError each)."""
    try:
        ref = fn_ref()
    except ValueError as e:
        with pytest.raises(ValueError):
            fn_port()
        return str(e), None
    return ref, fn_port()


@pytest.mark.parametrize("cls_name", list(CLASSES))
@pytest.mark.parametrize("scenario", j_scen.SCENARIOS)
def test_noise_scenarios_give_identical_tasks(scenario, cls_name):
    cj, ct = _classes(cls_name)
    ref, got = _both(
        lambda: j_tasks.make_batch(cj, 2, M, K, 8, seed0=3,
                                   scenario=scenario),
        lambda: tasks.make_batch(ct, 2, M, K, 8, seed0=3,
                                 scenario=scenario))
    if got is None:
        assert scenario == "targeted_heavy", ref
        return
    np.testing.assert_array_equal(ref[0], got[0])
    np.testing.assert_array_equal(ref[1], got[1])
    for a, b in zip(ref[2], got[2]):
        _assert_tasks_equal(a, b)


@pytest.mark.parametrize("noise_kind", ["uniform", "boundary", "drift",
                                        "targeted_heavy"])
@pytest.mark.parametrize("scenario", j_scen.FEATURE_SCENARIOS)
def test_feature_concepts_give_identical_tasks(scenario, noise_kind):
    cj, ct = _classes("tree", tree_depth=4, tree_bins=32)
    spec_j = j_scen.ScenarioSpec(name=scenario, noise=6,
                                 noise_kind=noise_kind)
    spec_t = scenarios.ScenarioSpec(name=scenario, noise=6,
                                    noise_kind=noise_kind)
    for seed in (0, 5):
        ref, got = _both(
            lambda: j_scen.make_scenario_task(cj, M, K, spec_j, seed=seed),
            lambda: scenarios.make_scenario_task(ct, M, K, spec_t,
                                                 seed=seed))
        if got is None:
            assert noise_kind == "targeted_heavy", ref
            continue
        _assert_tasks_equal(ref, got)
        assert scenarios.planted_errors(got, device="cpu") == \
            j_scen.planted_errors(ref)


def test_feature_concepts_refuse_what_the_reference_refuses():
    cj, ct = _classes("stumps")
    with pytest.raises(ValueError, match="HistogramTrees"):
        scenarios.make_feature_task(ct, M, K,
                                    scenarios.ScenarioSpec(name="xor"))
    cj, ct = _classes("tree", tree_depth=1)
    with pytest.raises(ValueError, match="depth"):
        scenarios.make_feature_task(ct, M, K,
                                    scenarios.ScenarioSpec(name="xor"))
    for kw in (dict(name="gaussian"), dict(name="xor", cells=3),
               dict(name="bands", noise_kind="byzantine")):
        with pytest.raises(ValueError):
            j_scen.ScenarioSpec(**kw)
        with pytest.raises(ValueError):
            scenarios.ScenarioSpec(**kw)
    for name in j_scen.FEATURE_SCENARIOS:
        assert (scenarios.ScenarioSpec(name=name).min_tree_depth()
                == j_scen.ScenarioSpec(name=name).min_tree_depth())


@pytest.mark.parametrize("name", j_scen.INFRA)
def test_infra_schedules_and_survivors_are_equal(name):
    for k in (2, 4):
        for seed in (0, 3):
            for player in (0, 1, 5):
                kw = dict(name=name, player=player, drop_round=4,
                          rejoin_round=9, miss_rate=0.4, horizon=32)
                spec_j, spec_t = (j_scen.InfraSpec(**kw),
                                  scenarios.InfraSpec(**kw))
                np.testing.assert_array_equal(spec_j.schedule(k, seed),
                                              spec_t.schedule(k, seed))
                np.testing.assert_array_equal(spec_j.survivors(k, seed),
                                              spec_t.survivors(k, seed))
    if name != "none":
        with pytest.raises(ValueError):
            scenarios.InfraSpec(name=name).schedule(1)


def test_infra_spec_refusals():
    with pytest.raises(ValueError):
        scenarios.InfraSpec(name="crash")
    with pytest.raises(ValueError):
        scenarios.InfraSpec(name="rejoin", drop_round=5, rejoin_round=5)


def _point_set_tasks():
    """(reference, port) task pairs with contradicted points: integer
    points of a small domain, grid rows of a coarse tree grid, and
    continuous stump rows (no duplicates at all)."""
    out = []
    for cls_name, scenario, kw in (
            ("thresholds_small_domain", "targeted_heavy", {}),
            ("singletons", "uniform", {}),
            ("tree", "uniform", dict(num_features=2, tree_bins=4)),
            ("tree", "targeted_heavy", dict(num_features=2, tree_bins=4)),
            ("stumps", "boundary", {})):
        cj, ct = _classes(cls_name, **kw)
        for seed in (1, 2):
            out.append((
                j_scen.make_scenario_task(
                    cj, M, K, j_scen.ScenarioSpec(name=scenario, noise=40),
                    seed=seed),
                scenarios.make_scenario_task(
                    ct, M, K, scenarios.ScenarioSpec(name=scenario,
                                                     noise=40), seed=seed)))
    return out


def test_point_sets_and_recalls_are_equal():
    rng = np.random.default_rng(0)
    for ref, got in _point_set_tasks():
        _assert_tasks_equal(ref, got)
        contr = scenarios.contradicted_points(got)
        np.testing.assert_array_equal(j_scen.contradicted_points(ref),
                                      contr)
        planted = scenarios.planted_points(got)
        np.testing.assert_array_equal(j_scen.planted_points(ref), planted)
        flat = got.flat_x
        for frac in (0.0, 0.1, 0.5, 1.0):
            pick = flat[rng.random(flat.shape[0]) < frac]
            extra = (rng.random((7,) + flat.shape[1:]) * 9).astype(
                flat.dtype)
            dispute = np.concatenate([pick, extra])
            for target in (contr, planted):
                assert (scenarios.quarantine_recall(dispute, target)
                        == j_scen.quarantine_recall(dispute, target))
        assert contr.shape[0] > 0 or got.cls.needs_features


def test_recall_of_rows_follows_equality():
    """−0.0 equals +0.0 and a row holding a NaN equals nothing, as
    under the reference's ``==``."""
    tgt = np.array([[0.0, 1.0], [np.nan, 2.0], [3.0, 4.0]], np.float32)
    dis = np.array([[-0.0, 1.0], [np.nan, 2.0], [3.0, 5.0]], np.float32)
    assert scenarios.quarantine_recall(dis, tgt) == \
        j_scen.quarantine_recall(dis, tgt) == pytest.approx(1 / 3)
    assert scenarios.quarantine_recall(dis[:0], tgt) == 0.0
    assert scenarios.quarantine_recall(dis, tgt[:0]) == 1.0


@pytest.mark.parametrize("floor_cls", ["own", "stumps"])
@pytest.mark.parametrize("scenario", ["xor", "bands"])
def test_planted_errors_and_class_floors_are_equal(scenario, floor_cls):
    cj, ct = _classes("tree", tree_depth=3, tree_bins=16)
    spec_j = j_scen.ScenarioSpec(name=scenario, noise=5)
    spec_t = scenarios.ScenarioSpec(name=scenario, noise=5)
    for seed in (0, 1):
        ref = j_scen.make_scenario_task(cj, M, K, spec_j, seed=seed)
        got = scenarios.make_scenario_task(ct, M, K, spec_t, seed=seed)
        assert scenarios.planted_errors(got, device="cpu") == \
            j_scen.planted_errors(ref)
        if floor_cls == "own":
            want = j_scen.class_floor(ref)
            assert scenarios.class_floor(got, device="cpu") == want
            assert tasks.true_opt(got, "cpu") == j_tasks.true_opt(ref) == want
        else:
            want = j_scen.class_floor(ref, j_weak.AxisStumps(num_features=4))
            assert scenarios.class_floor(
                got, weak.AxisStumps(num_features=4), "cpu") == want
            assert want >= 0.25 * M or scenario != "xor"


@pytest.mark.parametrize("cls_name", ["thresholds", "intervals",
                                      "singletons", "stumps"])
def test_class_floors_of_noisy_tasks_are_equal(cls_name):
    cj, ct = _classes(cls_name)
    for scenario in ("uniform", "drift", "byzantine"):
        ref = j_scen.make_scenario_task(
            cj, M, K, j_scen.ScenarioSpec(name=scenario, noise=20), seed=4)
        got = scenarios.make_scenario_task(
            ct, M, K, scenarios.ScenarioSpec(name=scenario, noise=20),
            seed=4)
        assert scenarios.class_floor(got, device="cpu") == \
            j_scen.class_floor(ref)
