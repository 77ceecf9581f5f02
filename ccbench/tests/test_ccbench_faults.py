"""The check of ``correct`` fails the control and every fault a cell can
have, planted under a whole run (``ccbench/faults.py``), and passes the
program as it is."""

import pytest

from ccbench import faults
from ccbench.tests import helpers

CASES = [
    ("tiny.remove_lanes", "control"),
    ("tiny.remove_lanes", "unchanged"),
    ("tiny.remove_lanes", "half_rows"),
    ("tiny.remove_lanes", "half_lanes"),
    ("tiny.remove_lanes", "altered"),
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return helpers.tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload,plant", CASES)
def test_a_planted_fault_reads_not_correct(root, workload, plant):
    with faults.planted(plant):
        rc, result, err = helpers.run_cpu(root, workload, seed=7)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, err[-3000:]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_the_same_run_unplanted_reads_correct(root):
    rc, result, err = helpers.run_cpu(root, "tiny.remove_lanes", seed=7)
    assert rc == 0 and result["correct"] is True, err[-3000:]


def test_plants_are_undone():
    from cruise_control_tpu_torch.analyzer import context, optimizer, solver

    from ccbench.harness import program
    now = lambda: (context.broker_channel_sums, optimizer.GoalOptimizer._run_lanes,  # noqa: E731
                   solver.GoalSolver.optimize_goal, program.broker_sums)
    before = now()
    for plant in faults.PLANTS:
        with faults.planted(plant):
            assert now() != before
    assert now() == before
    with pytest.raises(ValueError):
        faults.planted("no_such_fault")
