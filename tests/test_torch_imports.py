"""The PyTorch port stands alone: it imports torch, numpy and the standard
library, never ``jax``, ``flax`` or the JAX package ``cruise_control_tpu``."""

import ast
import os
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


def test_scan_covers_every_module_of_the_port():
    """Both checks walk the whole package: the builder, the JSON snapshot,
    the fixtures, budgets, relaxation and lanes included."""
    names = {".".join(p.relative_to(PORT).with_suffix("").parts) for p in _port_modules()}
    assert {"model.builder", "model.snapshot", "model.state", "model.cpu_model",
            "testing.deterministic", "analyzer.budget", "analyzer.relax",
            "analyzer.optimizer", "analyzer.solver", "client.propose"} <= names


def test_fresh_interpreter_import_pulls_no_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in _port_modules() if p.name != "__init__.py"]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\n"
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
