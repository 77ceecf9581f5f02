"""The port's config package against the JAX package's.

The counterpart of ``tests/test_config_env.py`` (the ``${env:VAR}``
indirection, each of its eight tests held on the port), then the two
packages' definitions side by side: the same key set, each key with the same
type, default and validator verdict on good and bad values; a properties
file written here parses to equal values in both; and the derived
``BalancingConstraint`` and ``ExecutorConfig`` have equal fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.common.exceptions import ConfigError as JConfigError
from cruise_control_tpu.config import CruiseControlConfig as JConfig
from cruise_control_tpu.config.config_def import ConfigType as JConfigType
from cruise_control_tpu_torch.common.exceptions import ConfigError
from cruise_control_tpu_torch.config import CruiseControlConfig
from cruise_control_tpu_torch.config.config_def import (
    ConfigType,
    get_configured_instance,
    load_properties,
    resolve_env_refs,
)
from cruise_control_tpu_torch.config.cruise_control_config import inert_item

# ------------------------------------------ tests/test_config_env.py, ported


def test_plain_values_pass_through():
    assert resolve_env_refs("plain") == "plain"
    assert resolve_env_refs("") == ""
    assert resolve_env_refs(42) == 42
    assert resolve_env_refs(None) is None
    assert resolve_env_refs(True) is True


def test_single_ref_resolves(monkeypatch):
    monkeypatch.setenv("CC_TEST_SECRET", "s3cr3t")
    assert resolve_env_refs("${env:CC_TEST_SECRET}") == "s3cr3t"


def test_embedded_and_multiple_refs(monkeypatch):
    monkeypatch.setenv("CC_TEST_USER", "alice")
    monkeypatch.setenv("CC_TEST_PW", "hunter2")
    assert (resolve_env_refs("${env:CC_TEST_USER}:${env:CC_TEST_PW}@host")
            == "alice:hunter2@host")


def test_unset_var_is_a_config_error(monkeypatch):
    monkeypatch.delenv("CC_TEST_MISSING", raising=False)
    with pytest.raises(ConfigError, match="CC_TEST_MISSING"):
        resolve_env_refs("${env:CC_TEST_MISSING}")


def test_malformed_ref_passes_through_verbatim():
    assert resolve_env_refs("${envCC_X}") == "${envCC_X}"
    assert resolve_env_refs("$env:CC_X") == "$env:CC_X"


def test_load_properties_resolves_secrets(tmp_path, monkeypatch):
    monkeypatch.setenv("CC_TEST_WEBHOOK_TOKEN", "tok-123")
    path = tmp_path / "cc.properties"
    path.write_text("# comment\n"
                    "compile.persistent.cache.path=${env:CC_TEST_WEBHOOK_TOKEN}\n"
                    "compile.warmup.lanes=8\n")
    props = load_properties(str(path))
    assert props["compile.persistent.cache.path"] == "tok-123"
    assert props["compile.warmup.lanes"] == "8"


def test_load_properties_unset_secret_fails_loud(tmp_path, monkeypatch):
    monkeypatch.delenv("CC_TEST_MISSING", raising=False)
    path = tmp_path / "cc.properties"
    path.write_text("compile.persistent.cache.path=${env:CC_TEST_MISSING}\n")
    with pytest.raises(ConfigError, match="CC_TEST_MISSING"):
        load_properties(str(path))


def test_programmatic_overrides_get_the_same_indirection(monkeypatch):
    monkeypatch.setenv("CC_TEST_CACHE_DIR", "/var/cache/cc")
    monkeypatch.setenv("CC_TEST_MAX_BYTES", "1048576")
    cfg = CruiseControlConfig({
        "compile.persistent.cache.path": "${env:CC_TEST_CACHE_DIR}",
        "compile.persistent.cache.max.bytes": "${env:CC_TEST_MAX_BYTES}",
    })
    assert cfg.get("compile.persistent.cache.path") == "/var/cache/cc"
    assert cfg.get("compile.persistent.cache.max.bytes") == 1048576


# ------------------------------------------------- the two definitions, side by side

_JKEYS = JConfig().definition.keys()
_TKEYS = CruiseControlConfig().definition.keys()

# Candidate raw values per type: each goes through both packages' coercion
# and validator, and the verdict (value or error) must agree.
_PROBES = {
    "INT": ["0", "1", "-1", "7", "100000", "x"],
    "LONG": ["0", "1", "-5", "30000", "99999999999", "1.5"],
    "DOUBLE": ["0", "0.5", "1.0", "1.001", "-0.1", "2", "1e9", "nan?"],
    "BOOLEAN": ["true", "false", "1", "no", "YES"],
    "STRING": ["", "a", "lowered", "off", "full", "bogus"],
    "LIST": ["", "a,b", "RackAwareGoal, ReplicaCapacityGoal"],
    "CLASS": ["", "os.path.join"],
}


def test_key_sets_equal_jax():
    assert set(_TKEYS) == set(_JKEYS)
    assert len(_TKEYS) > 150


@pytest.mark.parametrize("name", sorted(_JKEYS))
def test_key_type_default_and_verdicts_equal_jax(name):
    jk, tk = _JKEYS[name], _TKEYS[name]
    assert tk.config_type.value == jk.config_type.value
    assert tk.has_default == jk.has_default
    if jk.has_default:
        assert tk.default == jk.default
    for raw in _PROBES[jk.config_type.name]:
        verdicts = []
        for cfg_cls, err in ((JConfig, JConfigError), (CruiseControlConfig, ConfigError)):
            try:
                verdicts.append(("ok", cfg_cls({name: raw})[name]))
            except err as e:
                verdicts.append(("error", type(e).__name__))
        assert verdicts[1] == verdicts[0], (name, raw)
    # Keys the port accepts but does not read yet name the item that ports them.
    item = inert_item(name)
    if item is not None:
        assert f"ROADMAP Queue 1 item {item}" in tk.doc


def test_no_class_default_names_the_jax_package():
    for key in _TKEYS.values():
        if key.config_type is ConfigType.CLASS and key.default:
            assert not str(key.default).startswith("cruise_control_tpu."), key.name
    # CLASS keys resolve by importlib, in the port's own namespace.
    assert get_configured_instance(
        "cruise_control_tpu_torch.compilesvc.buckets.ShapeBucketPolicy").pad_targets(10, 3) \
        == (64, 8)


PROPERTIES = """\
# A deployment's properties: every subsystem, with comments and blanks.
default.goals=com.linkedin.kafka.cruisecontrol.analyzer.goals.RackAwareGoal,\
ReplicaCapacityGoal,DiskCapacityGoal,CpuUsageDistributionGoal
hard.goals=RackAwareGoal,ReplicaCapacityGoal
anomaly.detection.goals=RackAwareGoal

cpu.balance.threshold=1.2
network.outbound.capacity.threshold=0.65
disk.low.utilization.threshold=0.1
max.replicas.per.broker=4000
topic.replica.count.balance.threshold=2.5
topic.names.with.min.leaders.per.broker=orders, payments
min.topic.leaders.per.broker=2
goal.violation.distribution.threshold.multiplier=1.5
num.partition.metrics.windows=3
partition.metrics.window.ms=60000
min.valid.partition.ratio=0.9
num.concurrent.partition.movements.per.broker=7
num.concurrent.leader.movements=250
max.num.cluster.movements=900
execution.progress.check.interval.ms=2500
default.replication.throttle=50000000
task.execution.alerting.threshold.ms=45000
auto.adjust.concurrency=true
self.healing.enabled=true
anomaly.detection.interval.ms=10000
proposal.expiration.ms=30000
model.resident.max.delta.chain=64
trace.solver.rounds=true
solver.default.deadline.ms=2000
solver.shutdown.grace.ms=1500
compile.warmup.lanes=4,16
memory.analysis.mode=full
resilience.retry.max.attempts=6
webserver.http.port=9191
unknown.key.is.ignored=42
! a bang comment
"""


def test_properties_file_parses_equal_jax(tmp_path):
    path = tmp_path / "cruisecontrol.properties"
    path.write_text(PROPERTIES)
    jcfg, tcfg = JConfig.from_properties_file(str(path)), CruiseControlConfig.from_properties_file(
        str(path))
    assert tcfg.values == jcfg.values
    assert tcfg.originals == jcfg.originals
    for key in ("default.goals", "hard.goals", "anomaly.detection.goals"):
        assert tcfg.goal_names(key) == jcfg.goal_names(key)
    assert tcfg["topic.names.with.min.leaders.per.broker"] == ["orders", "payments"]
    assert "unknown.key.is.ignored" not in tcfg.values


def test_unknown_goal_is_a_config_error_in_both():
    for cfg_cls, err in ((JConfig, JConfigError), (CruiseControlConfig, ConfigError)):
        with pytest.raises(err, match="default.goals"):
            cfg_cls({"default.goals": "NoSuchGoal"})


def _fields(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
    return out


@pytest.mark.parametrize("props", [{}, "file"], ids=["defaults", "file"])
def test_derived_objects_equal_jax(props, tmp_path):
    if props == "file":
        path = tmp_path / "cc.properties"
        path.write_text(PROPERTIES)
        jcfg = JConfig.from_properties_file(str(path))
        tcfg = CruiseControlConfig.from_properties_file(str(path))
    else:
        jcfg, tcfg = JConfig(), CruiseControlConfig()
    assert _fields(tcfg.balancing_constraint()) == _fields(jcfg.balancing_constraint())
    assert tcfg.balancing_constraint().balance_threshold.dtype == np.float32
    assert _fields(tcfg.executor_config()) == _fields(jcfg.executor_config())
    assert type(tcfg.balancing_constraint()).__module__.startswith("cruise_control_tpu_torch.")
    assert type(tcfg.executor_config()).__module__.startswith("cruise_control_tpu_torch.")
    assert JConfigType.CLASS.value == ConfigType.CLASS.value
