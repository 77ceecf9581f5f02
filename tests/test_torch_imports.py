"""The PyTorch port stands alone: it imports torch, numpy and the standard
library, never ``jax``, ``flax`` or the JAX package ``cruise_control_tpu``."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cruise_control_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "cruise_control_tpu"}


def _port_modules():
    return sorted(p for p in PORT.rglob("*.py") if "_build" not in p.parts)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_modules() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", _port_modules() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_string_names_a_jax_module(path):
    """A string can start a module without importing it (``python -m ...``,
    or the module's name as one argument): none names one of the JAX
    package."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [node.value for node in ast.walk(tree)
           if isinstance(node, ast.Constant) and isinstance(node.value, str)
           and re.search(r"(^|-m\s+)cruise_control_tpu\.\w", node.value)]
    assert not bad, f"{path.relative_to(ROOT)}: {bad}"


def test_scan_covers_every_module_of_the_port():
    """Both checks walk the whole package: the builder, the JSON snapshot,
    the fixtures, budgets, relaxation and lanes, the monitor, the resident
    model, the executor, the detectors, the verifier, the config, resilience
    and observatory packages, the maintenance reader, the facade and their
    host-side support included, and the REST server, the bootstrap, the CLI,
    the SLO evaluator, the profiler and the SPNEGO test validator, and the
    ingestion edge: the reporter's serde, transports and agent, the
    consuming and Prometheus samplers, and the platform layers: the compile
    service's chunking, telemetry, cache, warmup and service, the memory
    ledger, the solver's device failover and the hermetic guards, and the
    last two subpackages: the multi-process solves and the fuzzer."""
    names = {".".join(p.relative_to(PORT).with_suffix("").parts) for p in _port_modules()}
    assert {"model.builder", "model.snapshot", "model.state", "model.cpu_model",
            "testing.deterministic", "analyzer.budget", "analyzer.relax",
            "analyzer.optimizer", "analyzer.solver", "client.propose",
            "model.resident", "model.sanity", "common.metrics", "obsvc.tracer",
            "compilesvc.buckets", "monitor.__init__", "monitor.aggregator",
            "monitor.capacity", "monitor.load_monitor", "monitor.metadata",
            "monitor.metric_def", "monitor.sample_store", "monitor.sampler",
            "monitor.samples", "monitor.task_runner",
            "common.actions", "common.exceptions", "obsvc.audit", "obsvc.oplog",
            "obsvc.execution", "utils.netsec", "executor.__init__", "executor.tasks",
            "executor.strategies", "executor.planner", "executor.journal",
            "executor.backend", "executor.broker_simulator",
            "executor.subprocess_backend", "executor.executor", "detector.__init__",
            "detector.anomalies", "detector.notifier", "detector.detectors",
            "detector.manager", "testing.verifier", "model.ops",
            "config.__init__", "config.config_def", "config.cruise_control_config",
            "resilience.__init__", "resilience.retry", "resilience.circuit",
            "resilience.reconnect", "obsvc.__init__", "obsvc.convergence", "obsvc.history",
            "obsvc.fidelity", "detector.maintenance_reader", "facade",
            "servlet.__init__", "servlet.progress", "servlet.purgatory",
            "servlet.user_tasks", "servlet.security", "servlet.schemas", "servlet.server",
            "servlet.openapi", "main", "client.cccli", "obsvc.slo", "obsvc.profiler",
            "testing.fake_gss", "reporter.__init__", "reporter.serde",
            "reporter.transport", "reporter.agent", "monitor.fetcher",
            "monitor.prometheus", "compilesvc.__init__", "compilesvc.chunking",
            "compilesvc.telemetry", "compilesvc.cache", "compilesvc.warmup",
            "compilesvc.service", "obsvc.memory", "resilience.failover",
            "utils.hermetic", "parallel.__init__", "parallel.mesh", "parallel.multihost",
            "fuzzsvc.__init__", "fuzzsvc.__main__", "fuzzsvc.scenario",
            "fuzzsvc.invariants", "fuzzsvc.storm", "fuzzsvc.runner"} <= names


def test_broker_simulator_starts_without_torch():
    """The admin simulator is a separate process that must start in
    milliseconds: its import path (the executor package's ``__init__``
    included) pulls in neither torch nor numpy."""
    code = ("import sys\n"
            "import cruise_control_tpu_torch.executor.broker_simulator as sim\n"
            "s = sim.BrokerSimulator()\n"
            "assert s.handle({'op': 'ping'})['ok']\n"
            "heavy = sorted(m for m in ('torch', 'numpy') if m in sys.modules)\n"
            "assert not heavy, heavy\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_executor_package_exports_resolve():
    import cruise_control_tpu_torch.executor as ex

    assert ex.Executor.__module__ == "cruise_control_tpu_torch.executor.executor"
    assert ex.ExecutionTaskPlanner.__module__ == "cruise_control_tpu_torch.executor.planner"
    assert sorted(ex.__all__) == sorted(["ExecutionTask", "ExecutionTaskState",
                                         "ExecutionTaskTracker", "ExecutionTaskPlanner",
                                         "Executor", "ExecutorState"])
    with pytest.raises(AttributeError):
        ex.NoSuchName


def test_fresh_interpreter_import_pulls_no_jax():
    """Importing every module of the port pulls in neither JAX nor PyYAML
    (the chip machine has no PyYAML: ``servlet.openapi`` imports it only to
    render the spec)."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in _port_modules() if p.name != "__init__.py"]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN | {"yaml"}) + ")\n"
            + "assert not bad, bad\nprint(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_unported_goal_is_named():
    from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name

    with pytest.raises(ValueError, match="unknown goal: 'com.example.NoSuchGoal'"):
        goal_by_name("com.example.NoSuchGoal")
    assert goal_by_name("CpuUsageDistributionGoal").name == "CpuUsageDistributionGoal"
    assert goal_by_name("com.linkedin.kafka.cruisecontrol.analyzer.goals."
                        "RackAwareGoal").name == "RackAwareGoal"
