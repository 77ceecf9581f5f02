"""The port's scenario fuzzer (``cruise_control_tpu_torch.fuzzsvc``) against
the JAX package's, on the CPU.

The generator and the shrinker are numpy only: the same seeds must give the
same scenarios, byte for byte in JSON, and the same snapshots.  The
invariants run on the port's modules, so each kind's fixed-seed scenario
(seeds 100–107, one a kind, every invariant of the kind) must pass whole;
one base solve is judged by the JAX package's verifier against the JAX
base solve.  ``mesh_parity`` is trivial at one rank here; two ranks hold it
in ``tests/test_torch_parallel.py``.  The storm, the shrink-and-replay loop,
the CLI, the config and the ``Fuzz.*`` counters follow.
"""


import jax.numpy as jnp
import numpy as np
import pytest

from cruise_control_tpu.analyzer import relax as jrelax
from cruise_control_tpu.config.cruise_control_config import CruiseControlConfig as JConfig
from cruise_control_tpu.fuzzsvc import invariants as jinvariants
from cruise_control_tpu.fuzzsvc import runner as jrunner
from cruise_control_tpu.fuzzsvc import scenario as jscenario
from cruise_control_tpu.model.state import Placement as JPlacement
from cruise_control_tpu.testing.verifier import verify_placement
from cruise_control_tpu_torch import main as tmain
from cruise_control_tpu_torch.common import metrics
from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
from cruise_control_tpu_torch.fuzzsvc import invariants, runner, scenario
from cruise_control_tpu_torch.fuzzsvc.runner import FuzzConfig, fuzz_sensors, run_fuzz, run_one
from cruise_control_tpu_torch.fuzzsvc.scenario import SCENARIO_KINDS, Scenario, generate_scenario
from cruise_control_tpu_torch.fuzzsvc.storm import audit_coherence, run_storm

SEEDS = range(100, 108)
FUZZ_SENSORS = {"Fuzz.scenarios-run", "Fuzz.scenario-failures", "Fuzz.invariant-failures",
                "Fuzz.storm-cycles", "Fuzz.shrink-steps"}


def _np(t):
    return t.numpy() if hasattr(t, "numpy") and not isinstance(t, np.ndarray) else \
        np.asarray(t)


# --------------------------------------------------------------- generator

@pytest.mark.parametrize("kind", SCENARIO_KINDS + (None,))
def test_generator_equals_jax(kind):
    """Every kind (and the seed's own draw) at seeds 100–107: the same JSON,
    the same shrink candidates, the same round trip."""
    for seed in SEEDS:
        s, j = generate_scenario(seed, kind=kind), jscenario.generate_scenario(seed, kind=kind)
        assert s.to_json() == j.to_json()
        assert [(label, c.to_json()) for label, c in scenario.shrink_steps(s)] == \
            [(label, c.to_json()) for label, c in jscenario.shrink_steps(j)]
        back = Scenario.from_json(s.to_json())
        assert back.to_json() == s.to_json() and back.props == s.props
        assert back.to_json() == jscenario.Scenario.from_json(j.to_json()).to_json()


def test_bench_config_9_scenario_equals_jax():
    s, j = generate_scenario(3146, kind="exp_skew"), jscenario.generate_scenario(
        3146, kind="exp_skew")
    assert s.to_json() == j.to_json()
    assert (scenario.SMOKE_GOALS, scenario.BASE_INVARIANTS) == \
        (jscenario.SMOKE_GOALS, jscenario.BASE_INVARIANTS)


def test_replay_command_names_the_port():
    s = generate_scenario(9, kind="exp_skew")
    assert s.replay_command() == ("python -m cruise_control_tpu_torch.fuzzsvc "
                                  "--device cuda --seed 9 --kind exp_skew")
    assert s.replay_command("/tmp/x.json", "cpu") == (
        "python -m cruise_control_tpu_torch.fuzzsvc --device cpu --replay /tmp/x.json")


@pytest.mark.parametrize("i,kind", list(enumerate(SCENARIO_KINDS)))
def test_materialized_snapshot_equals_jax(i, kind):
    s = generate_scenario(100 + i, kind=kind)
    ts, tp, tm = s.materialize(device="cpu")
    js, jp, jm = jscenario.generate_scenario(100 + i, kind=kind).materialize()
    for name in ts.__dataclass_fields__:
        assert np.array_equal(_np(getattr(ts, name)), np.asarray(getattr(js, name))), name
    for name in ("broker", "disk", "is_leader"):
        assert np.array_equal(_np(getattr(tp, name)), np.asarray(getattr(jp, name))), name
    assert (tm.broker_ids, tm.topics, tm.partitions, tm.num_replicas) == \
        (jm.broker_ids, jm.topics, jm.partitions, jm.num_replicas)


# -------------------------------------------------------------- invariants

def test_registry_is_the_fourteen():
    assert list(invariants.INVARIANTS) == list(jinvariants.INVARIANTS)
    assert len(invariants.INVARIANTS) == 14
    run = set()
    for i, kind in enumerate(SCENARIO_KINDS):
        run |= set(generate_scenario(100 + i, kind=kind).invariants)
    assert run == set(invariants.INVARIANTS)


@pytest.mark.parametrize("i,kind", list(enumerate(SCENARIO_KINDS)))
def test_fixed_seed_corpus_invariants(i, kind):
    """The corpus: one scenario a kind, every invariant of the kind."""
    out = run_one(generate_scenario(100 + i, kind=kind), storm_cycles=0, device="cpu")
    assert [r.name for r in out.invariants] == list(out.scenario.invariants)
    assert out.ok, f"{kind}: {out.failures}"


def test_base_solve_no_worse_than_jax():
    """One scenario's base solve, judged by the JAX package's verifier:
    violated goals no worse than the JAX base solve's."""
    s = generate_scenario(101, kind="exp_skew")
    m = invariants.Materialized(s, device="cpu")
    was_on = jrelax.relaxation_enabled()
    jrelax.set_relaxation(False)
    try:
        jm = jinvariants.Materialized(jscenario.generate_scenario(101, kind="exp_skew"))
        jbase = jm.base
    finally:
        jrelax.set_relaxation(was_on)
    final = m.base.final_placement
    pl = JPlacement(broker=jnp.asarray(final.broker.numpy()),
                    disk=jnp.asarray(final.disk.numpy()),
                    is_leader=jnp.asarray(final.is_leader.numpy()))
    failures, jfailures = (
        verify_placement(jm.state, jm.placement, jm.meta, p, goal_names=list(s.goal_names),
                         verifications=("GOAL_VIOLATION", "DEAD_BROKERS"))
        for p in (pl, jbase.final_placement))
    assert len(failures) <= len(jfailures)
    assert len(m.base.violated_goals_after) <= len(jbase.violated_goals_after)
    assert m.base.balancedness_score >= jbase.balancedness_score


def test_a_failing_invariant_is_reported_not_raised(monkeypatch):
    def boom(m):
        raise RuntimeError("boom")

    monkeypatch.setitem(invariants.INVARIANTS, "load_conservation", boom)
    got = invariants.run_invariants(generate_scenario(100, kind="uniform_baseline"),
                                    which=("load_conservation", "no_such"), device="cpu")
    assert [(r.name, r.ok) for r in got] == [("load_conservation", False), ("no_such", False)]
    assert "raised RuntimeError: boom" in got[0].detail


def test_memory_ledger_invariant_restores_the_process_ledger():
    from cruise_control_tpu_torch.obsvc.memory import memory_ledger

    before = memory_ledger()
    m = invariants.Materialized(generate_scenario(100, kind="uniform_baseline"), device="cpu")
    assert invariants.memory_ledger_balanced(m) == []
    assert memory_ledger() is before


# ------------------------------------------------------------------- storm

def test_storm_cycle_converges_with_coherent_audit():
    rep = run_storm(generate_scenario(205, kind="maintenance_window"), cycles=1,
                    device="cpu")
    assert rep.ok, rep.problems
    assert rep.cycles_run == 1 and rep.anomalies_detected >= 1
    assert rep.audit and audit_coherence(rep.audit) == []


def test_storm_soak_every_kind():
    """Two storm cycles on every kind (the JAX package runs this soak
    nightly; the port's takes seconds on the CPU)."""
    cfg = FuzzConfig(num_scenarios=len(SCENARIO_KINDS), base_seed=300, storm_cycles=2,
                     device="cpu")
    report = run_fuzz(cfg, log=lambda *_: None)
    assert report.ok, [f for o in report.outcomes for f in o.failures]


# ------------------------------------------------------------------ runner

def test_injected_failure_shrinks_and_replays_as_jax(tmp_path, monkeypatch):
    """Every invariant unknown: each scenario fails without a solve.  Both
    packages shrink along the same trail, and the printed replay commands
    reproduce the failure through the port's ``main``."""
    reports = {}
    for name, inv_mod, run, cfg_cls, extra in (
            ("torch", invariants, run_fuzz, FuzzConfig, {"device": "cpu"}),
            ("jax", jinvariants, jrunner.run_fuzz, jrunner.FuzzConfig, {})):
        monkeypatch.setattr(inv_mod, "INVARIANTS", {})
        logs = []
        cfg = cfg_cls(num_scenarios=1, base_seed=42, storm_cycles=0,
                      corpus_dir=str(tmp_path / name), shrink_max_steps=3,
                      kinds=("hetero_racks",), **extra)
        reports[name] = (run(cfg, log=logs.append), logs)
    (report, logs), (jreport, jlogs) = reports["torch"], reports["jax"]
    assert not report.ok and report.replay_lines
    trail = [ln for ln in logs if "shrunk via" in ln]
    assert trail and [ln.replace("/torch/", "/x/") for ln in trail] == \
        [ln.replace("/jax/", "/x/") for ln in jlogs if "shrunk via" in ln]
    saved = sorted(p.name for p in (tmp_path / "torch" / "failing").glob("*.json"))
    assert saved == sorted(p.name for p in (tmp_path / "jax" / "failing").glob("*.json"))
    for p in saved:
        assert (tmp_path / "torch" / "failing" / p).read_text() == \
            (tmp_path / "jax" / "failing" / p).read_text()

    for line in report.replay_lines:
        assert line.startswith("python -m cruise_control_tpu_torch.fuzzsvc --device cpu ")
        args = line.split("cruise_control_tpu_torch.fuzzsvc ", 1)[1].split()
        assert runner.main(args + ["--storm-cycles", "0"]) == 1


def test_cli_list_kinds(capsys):
    assert runner.main(["--list-kinds"]) == 0
    assert capsys.readouterr().out.split() == list(SCENARIO_KINDS)


def test_cli_replays_a_passing_seed_on_the_cpu(capsys):
    assert runner.main(["--seed", "100", "--kind", "uniform_baseline", "--storm-cycles",
                        "0", "--device", "cpu"]) == 0
    assert "uniform_baseline-s100: ok" in capsys.readouterr().out


def test_cli_without_a_card_refuses_cuda(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert runner.main(["--seed", "100", "--device", "cuda"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_fuzz_config_from_cc_config_equals_jax():
    props = {"fuzz.num.scenarios": 3, "fuzz.storm.cycles": 0, "fuzz.corpus.dir": "/tmp/fz",
             "fuzz.shrink.max.steps": 2, "solver.relaxation.tolerance": 0.125,
             "solver.relaxation.waves": 3}
    cfg = FuzzConfig.from_cc_config(CruiseControlConfig(props))
    jcfg = jrunner.FuzzConfig.from_cc_config(JConfig(props))
    for name in ("num_scenarios", "base_seed", "budget_s", "corpus_dir", "storm_cycles",
                 "shrink_max_steps", "kinds"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.device == "cuda"
    assert (cfg.relaxation.tolerance, cfg.relaxation.waves) == (0.125, 3)


def test_fuzz_counters_advance_as_jax():
    sensors, jsensors = fuzz_sensors(), jrunner.fuzz_sensors()
    assert set(sensors) == set(jsensors)
    before = {k: c.count for k, c in sensors.items()}
    out = run_one(generate_scenario(100, kind=SCENARIO_KINDS[0]), storm_cycles=0,
                  which=("load_conservation",), device="cpu")
    assert out.ok
    assert sensors["scenarios"].count == before["scenarios"] + 1
    assert sensors["failures"].count == before["failures"]
    assert metrics.registry().counter("Fuzz.scenarios-run") is sensors["scenarios"]


def test_build_app_registers_fuzz_sensors_at_boot(monkeypatch):
    monkeypatch.setattr(metrics, "_GLOBAL", metrics.MetricRegistry())
    app = tmain.build_app(CruiseControlConfig({"obs.history.enabled": "false",
                                               "compile.warmup.enabled": "false"}),
                          port=0, device="cpu")
    try:
        assert FUZZ_SENSORS <= set(metrics.registry().snapshot())
    finally:
        app.user_tasks.shutdown()
        app.server.server_close()
        app.cc.shutdown()
