"""The port's executor against the JAX package's.

The first half holds the port to the JAX package's own executor tests
(``tests/test_executor.py``) and journal tests (``tests/test_resilience.py``),
one counterpart each, on the port's classes.  The second half sends the same
numpy-seeded proposal sets through both packages' planner, strategies,
executor and journal over the same fake cluster, and compares what comes out
exactly: task states, the order of every submitted batch, throttles, sensor
values, the final metadata, the journal's lines (apart from timestamps and
batch ids, with task ids by their place in the batch) and the recovery
outcomes.  Nothing here is a float computed two ways, so nothing has a
tolerance.
"""

import importlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from cruise_control_tpu_torch.common.actions import (
    ExecutionProposal,
    ReplicaPlacementInfo,
    TopicPartition,
)
from cruise_control_tpu_torch.common.exceptions import OngoingExecutionError
from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.executor.backend import FakeClusterBackend
from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig, ExecutorState
from cruise_control_tpu_torch.executor.journal import ExecutionJournal
from cruise_control_tpu_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.strategies import (
    PostponeUrpReplicaMovementStrategy,
    PrioritizeLargeReplicaMovementStrategy,
    PrioritizeSmallReplicaMovementStrategy,
    strategy_by_name,
)
from cruise_control_tpu_torch.executor.subprocess_backend import BackendTransportError
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, ExecutionTaskState, TaskType
from cruise_control_tpu_torch.monitor.metadata import (
    BrokerInfo,
    FakeMetadataBackend,
    PartitionInfo,
)

JOIN_S = 5  # every join is bounded, as in the JAX tests


def proposal(topic, part, old, new, size=100.0, mod=None):
    a = mod.actions if mod is not None else None
    tp, rpi, ep = ((a.TopicPartition, a.ReplicaPlacementInfo, a.ExecutionProposal) if a
                   else (TopicPartition, ReplicaPlacementInfo, ExecutionProposal))
    return ep(topic_partition=tp(topic, part), partition_size=size,
              old_leader=rpi(old[0]), old_replicas=tuple(rpi(b) for b in old),
              new_replicas=tuple(rpi(b) for b in new))


def _metadata(num_brokers=4, mod=None):
    m = mod.metadata if mod is not None else None
    bi, pi, fb = ((m.BrokerInfo, m.PartitionInfo, m.FakeMetadataBackend) if m
                  else (BrokerInfo, PartitionInfo, FakeMetadataBackend))
    brokers = [bi(i, rack=str(i % 2), host=f"h{i}") for i in range(num_brokers)]
    parts = [pi("T", p, leader=p % num_brokers,
                replicas=(p % num_brokers, (p + 1) % num_brokers))
             for p in range(8)]
    return fb(brokers, parts)


def run_to_end(ex, proposals, timeout=JOIN_S * 4):
    """``execute_proposals`` with a bounded join in place of ``wait=True``."""
    ex.execute_proposals(proposals, wait=False)
    ex._thread.join(timeout=timeout)
    assert not ex._thread.is_alive()


def _stop(ex):
    ex.user_triggered_stop_execution()
    if ex._thread is not None:
        ex._thread.join(timeout=JOIN_S)
        assert not ex._thread.is_alive()


# ------------------------------------------- the JAX executor tests, ported


def test_planner_task_types():
    planner = ExecutionTaskPlanner()
    tasks = planner.add_proposals([
        proposal("T", 0, [0, 1], [2, 1]),       # replica move
        proposal("T", 1, [0, 1], [1, 0]),       # pure leadership
    ])
    types = sorted((t.task_type for t in tasks), key=lambda t: t.value)
    assert types == [TaskType.INTER_BROKER_REPLICA_ACTION, TaskType.LEADER_ACTION]


def test_planner_respects_per_broker_caps():
    planner = ExecutionTaskPlanner()
    planner.add_proposals([
        proposal("T", 0, [0, 1], [2, 1]),
        proposal("T", 1, [0, 1], [3, 1]),
        proposal("T", 2, [0, 1], [2, 1]),
    ])
    batch = planner.inter_broker_tasks({b: 1 for b in range(4)}, {})
    assert len(batch) == 1
    assert len(planner.remaining_inter_broker_tasks) == 2


def test_strategies_order():
    small = ExecutionTask(proposal("T", 0, [0], [1], size=10),
                          TaskType.INTER_BROKER_REPLICA_ACTION)
    large = ExecutionTask(proposal("T", 1, [0], [1], size=1000),
                          TaskType.INTER_BROKER_REPLICA_ACTION)
    assert PrioritizeLargeReplicaMovementStrategy().order([small, large])[0] is large
    assert PrioritizeSmallReplicaMovementStrategy().order([large, small])[0] is small
    assert PostponeUrpReplicaMovementStrategy({("T", 1)}).order([large, small])[0] is small
    with pytest.raises(ValueError, match="unknown replica movement strategy"):
        strategy_by_name("NoSuchStrategy")


def test_task_state_machine():
    t = ExecutionTask(proposal("T", 0, [0], [1]), TaskType.INTER_BROKER_REPLICA_ACTION)
    t.transition(ExecutionTaskState.IN_PROGRESS, 1.0)
    with pytest.raises(ValueError):
        t.transition(ExecutionTaskState.PENDING)
    t.transition(ExecutionTaskState.COMPLETED, 2.0)
    assert t.done and t.start_time_ms == 1.0 and t.end_time_ms == 2.0


def test_executor_end_to_end():
    md = _metadata()
    ex = Executor(FakeClusterBackend(md, polls_to_finish=2),
                  ExecutorConfig(progress_check_interval_s=0.001))
    run_to_end(ex, [
        proposal("T", 0, [0, 1], [2, 1]),
        proposal("T", 1, [1, 2], [3, 2]),
        proposal("T", 2, [2, 3], [3, 2]),       # leadership only
    ])
    assert ex.state is ExecutorState.NO_TASK_IN_PROGRESS
    by_tp = {(p.topic, p.partition): p for p in md.fetch().partitions}
    assert by_tp[("T", 0)].replicas == (2, 1)
    assert by_tp[("T", 1)].replicas == (3, 2)
    assert by_tp[("T", 2)].leader == 3
    summary = ex.tracker.summary()
    assert summary["inter_broker_replica"]["completed"] == 2
    assert summary["leadership"]["completed"] == 1
    assert ex.tracker.finished_data_movement_mb > 0


def test_executor_rejects_concurrent_execution():
    ex = Executor(FakeClusterBackend(_metadata(), polls_to_finish=50),
                  ExecutorConfig(progress_check_interval_s=0.01))
    ex.execute_proposals([proposal("T", 0, [0, 1], [2, 1])], wait=False)
    try:
        with pytest.raises(OngoingExecutionError):
            ex.execute_proposals([proposal("T", 1, [1, 2], [3, 2])])
    finally:
        _stop(ex)
    assert ex.state is ExecutorState.NO_TASK_IN_PROGRESS


def test_executor_refuses_external_reassignment():
    backend = FakeClusterBackend(_metadata(), polls_to_finish=10)
    backend.execute_replica_reassignments([ExecutionTask(
        proposal("T", 7, [0], [1]), TaskType.INTER_BROKER_REPLICA_ACTION)])
    with pytest.raises(OngoingExecutionError):
        Executor(backend).execute_proposals([proposal("T", 0, [0, 1], [2, 1])])


def test_executor_stop_marks_pending_dead():
    ex = Executor(FakeClusterBackend(_metadata(), polls_to_finish=1000),
                  ExecutorConfig(progress_check_interval_s=0.001,
                                 concurrent_partition_movements_per_broker=1))
    ex.execute_proposals([proposal("T", i, [0, 1], [2 + (i % 2), 1]) for i in range(4)],
                         wait=False)
    time.sleep(0.05)
    _stop(ex)
    s = ex.tracker.summary()["inter_broker_replica"]
    assert s.get("aborted", 0) + s.get("dead", 0) >= 1


def test_generating_proposals_guard():
    ex = Executor(FakeClusterBackend(_metadata()))
    ex.set_generating_proposals_for_execution(True)
    with pytest.raises(OngoingExecutionError):
        ex.set_generating_proposals_for_execution(True)
    ex.set_generating_proposals_for_execution(False)


def test_throttles_set_and_cleared():
    backend = FakeClusterBackend(_metadata(), polls_to_finish=1)
    ex = Executor(backend, ExecutorConfig(progress_check_interval_s=0.001,
                                          replication_throttle_bytes_per_s=1_000_000))
    seen = {}
    orig = backend.set_throttles

    def spy(rate, partitions, brokers=(), proposals=()):
        seen.update(rate=rate, partitions=list(partitions), brokers=list(brokers))
        orig(rate, partitions, brokers, proposals)

    backend.set_throttles = spy
    run_to_end(ex, [proposal("T", 0, [0, 1], [2, 1])])
    assert seen == {"rate": 1_000_000, "partitions": [("T", 0)], "brokers": [0, 1, 2]}
    assert backend.throttle_rate is None


def _action_gauge_values(reg):
    return {name: rec.get("value") for name, rec in reg.snapshot().items()
            if name.startswith(("Executor.replica-action-", "Executor.leadership-action-"))}


def test_action_gauges_zero_after_completed_execution():
    ex = Executor(FakeClusterBackend(_metadata(), polls_to_finish=2),
                  ExecutorConfig(progress_check_interval_s=0.001))
    run_to_end(ex, [proposal("T", 0, [0, 1], [2, 1]),
                    proposal("T", 2, [2, 3], [3, 2])])
    vals = _action_gauge_values(registry())
    assert len(vals) == 10 and all(v == 0 for v in vals.values()), vals


def test_action_gauges_zero_after_aborted_execution():
    ex = Executor(FakeClusterBackend(_metadata(), polls_to_finish=1000),
                  ExecutorConfig(progress_check_interval_s=0.001,
                                 concurrent_partition_movements_per_broker=1))
    ex.execute_proposals([proposal("T", i, [0, 1], [2 + (i % 2), 1]) for i in range(4)],
                         wait=False)
    time.sleep(0.05)
    _stop(ex)
    s = ex.tracker.summary()["inter_broker_replica"]
    assert s.get("aborted", 0) + s.get("dead", 0) >= 1
    assert all(v == 0 for v in _action_gauge_values(registry()).values())


# ------------------------------------------- the JAX journal tests, ported


def _tasks(n=3):
    return list(ExecutionTaskPlanner().add_proposals(
        [proposal("T", p, [0, 1], [2, 1]) for p in range(n)]))


def test_journal_crash_replay_and_torn_line(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = ExecutionJournal(path)
    t0, t1, t2 = _tasks(3)
    j.begin_batch([t0, t1, t2])
    j.record_transition(t0, ExecutionTaskState.IN_PROGRESS)
    j.record_transition(t0, ExecutionTaskState.COMPLETED)
    j.record_transition(t1, ExecutionTaskState.IN_PROGRESS)
    j.close()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"event": "transi')
    replay = ExecutionJournal(path).replay()
    assert replay is not None and not replay.complete and len(replay.tasks) == 3
    states = {t.execution_id: t.last_state for t in replay.tasks.values()}
    assert states == {t0.execution_id: "completed", t1.execution_id: "in_progress",
                      t2.execution_id: "pending"}
    assert {t.execution_id for t in replay.orphans()} == {t1.execution_id, t2.execution_id}
    assert ExecutionJournal(path).lag() == 2


def test_journal_clean_batch_has_no_lag(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = ExecutionJournal(path)
    (t0,) = _tasks(1)
    j.begin_batch([t0])
    j.record_transition(t0, ExecutionTaskState.IN_PROGRESS)
    j.record_transition(t0, ExecutionTaskState.COMPLETED)
    j.end_batch({"completed": 1, "dead": 0, "aborted": 0})
    replay = ExecutionJournal(path).replay()
    assert replay.complete and replay.outcome == {"completed": 1, "dead": 0, "aborted": 0}
    assert ExecutionJournal(path).lag() == 0


def test_journal_written_during_normal_execution(tmp_path):
    ex = Executor(FakeClusterBackend(_metadata(), polls_to_finish=1),
                  ExecutorConfig(progress_check_interval_s=0.001))
    path = str(tmp_path / "journal.jsonl")
    ex.set_journal(ExecutionJournal(path))
    run_to_end(ex, [proposal("T", 0, [0, 1], [2, 1])])
    replay = ExecutionJournal(path).replay()
    assert replay.complete and all(t.terminal for t in replay.tasks.values())
    assert ExecutionJournal(path).lag() == 0


def test_executor_recover_from_journal_reconciles(tmp_path):
    cluster = FakeClusterBackend(_metadata(), polls_to_finish=500)
    path = str(tmp_path / "journal.jsonl")
    t0, t1, t2 = _tasks(3)
    j = ExecutionJournal(path)
    j.begin_batch([t0, t1, t2])
    j.record_transition(t0, ExecutionTaskState.IN_PROGRESS)
    j.record_transition(t1, ExecutionTaskState.IN_PROGRESS)
    j.close()
    cluster.execute_replica_reassignments([t0])
    ex = Executor(cluster, ExecutorConfig(progress_check_interval_s=0.001))
    ex.set_journal(ExecutionJournal(path))
    summary = ex.recover_from_journal(adoption_timeout_s=0.05)
    assert (summary["status"], summary["journaledTasks"], summary["rolledBack"],
            summary["completed"], summary["stillInFlight"]) == ("reconciled", 3, 1, 1, 1)
    assert ex.state_summary()["journalRecovery"]["status"] == "reconciled"
    assert not os.path.exists(path)


def test_executor_recovery_keeps_journal_when_backend_down(tmp_path):
    class _DeadBackend:
        def in_progress_reassignments(self):
            raise BackendTransportError("peer down")

    path = str(tmp_path / "journal.jsonl")
    (t0,) = _tasks(1)
    j = ExecutionJournal(path)
    j.begin_batch([t0])
    j.record_transition(t0, ExecutionTaskState.IN_PROGRESS)
    j.close()
    ex = Executor(_DeadBackend(), ExecutorConfig())
    ex.set_journal(ExecutionJournal(path))
    assert ex.recover_from_journal(adoption_timeout_s=0.05)["status"] == "backend-unavailable"
    assert os.path.exists(path)


# -------------------------------------- both packages on the same inputs


def _pkg(root):
    names = dict(actions="common.actions", metrics="common.metrics",
                 backend="executor.backend", executor="executor.executor",
                 journal="executor.journal", planner="executor.planner",
                 strategies="executor.strategies", tasks="executor.tasks",
                 metadata="monitor.metadata")
    return SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                              for k, v in names.items()})


PKGS = {"jax": "cruise_control_tpu", "torch": "cruise_control_tpu_torch"}


def _seeded_proposals(mod, seed, num_brokers, n, rf=3):
    """n proposals over ``num_brokers`` brokers: replica moves, pure
    leadership swaps and both at once, sizes drawn with ties (so the
    strategies' tie-breaks decide), all from one numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(n):
        old = [int(b) for b in rng.choice(num_brokers, size=rf, replace=False)]
        kind = rng.integers(3)
        new = list(old)
        if kind != 1:  # replace one or two replicas
            spare = [b for b in range(num_brokers) if b not in old]
            for i in rng.choice(rf, size=int(rng.integers(1, 3)), replace=False):
                new[int(i)] = spare.pop(int(rng.integers(len(spare))))
        if kind != 0:  # a new leader from the new list
            j = int(rng.integers(1, rf))
            new[0], new[j] = new[j], new[0]
        size = float(rng.choice([10.0, 100.0, 1000.0]))
        out.append(proposal(f"t{p % 3}", p, old, new, size=size, mod=mod))
    return out


def _cluster(mod, num_brokers, proposals):
    m = mod.metadata
    brokers = [m.BrokerInfo(i, rack=str(i % 3), host=f"h{i}") for i in range(num_brokers)]
    parts = [m.PartitionInfo(p.topic_partition.topic, p.topic_partition.partition,
                             leader=p.old_leader.broker_id,
                             replicas=tuple(r.broker_id for r in p.old_replicas))
             for p in proposals]
    return m.FakeMetadataBackend(brokers, parts)


def _normalized_journal(path):
    """The journal's records without timestamps and batch ids, each task id
    replaced by its place in the batch_start's task list."""
    recs = [json.loads(line) for line in open(path, encoding="utf-8")]
    rank = {t["tid"]: i for i, t in enumerate(recs[0]["tasks"])}
    out = []
    for r in recs:
        r = {k: v for k, v in r.items() if k not in ("tsMs", "batchId")}
        if "tasks" in r:
            r["tasks"] = [dict(t, tid=rank[t["tid"]]) for t in r["tasks"]]
        if "tid" in r:
            r["tid"] = rank[r["tid"]]
        out.append(r)
    return out


def _run(root, seed, tmp_path, num_brokers=8, n=40, strategy=None, cap=2, polls=2,
         throttle=1_000_000, max_moves=1250):
    mod = _pkg(PKGS[root])
    proposals = _seeded_proposals(mod, seed, num_brokers, n)
    md = _cluster(mod, num_brokers, proposals)
    backend = mod.backend.FakeClusterBackend(md, polls_to_finish=polls)
    log = []
    for fn in ("execute_replica_reassignments", "execute_preferred_leader_election"):
        orig = getattr(backend, fn)

        def spy(tasks, _orig=orig, _fn=fn):
            log.append((_fn, [(t.proposal.topic_partition.topic,
                               t.proposal.topic_partition.partition) for t in tasks]))
            _orig(tasks)
        setattr(backend, fn, spy)
    throttles = []
    orig_set = backend.set_throttles

    def set_spy(rate, partitions, brokers=(), proposals=()):
        throttles.append((rate, list(partitions), list(brokers)))
        orig_set(rate, partitions, brokers, proposals)
    backend.set_throttles = set_spy
    reg = mod.metrics.registry()
    counters = ("Executor.execution-started", "Executor.execution-stopped",
                "Executor.backend-errors")
    before = {c: reg.counter(c).count for c in counters}
    strat = mod.strategies.strategy_by_name(strategy, urp={("t1", 3), ("t2", 5)}) \
        if strategy else None
    ex = mod.executor.Executor(backend, mod.executor.ExecutorConfig(
        progress_check_interval_s=0.0005, concurrent_partition_movements_per_broker=cap,
        replication_throttle_bytes_per_s=throttle, max_num_cluster_movements=max_moves),
        strategy=strat)
    path = str(tmp_path / f"{root}.jsonl")
    ex.set_journal(mod.journal.ExecutionJournal(path))
    ex.execute_proposals(proposals, wait=False)
    ex._thread.join(timeout=JOIN_S * 4)
    assert not ex._thread.is_alive()
    snap = reg.snapshot()
    tasks = sorted((t.task_type.value, t.proposal.topic_partition.partition, t.state.value)
                   for tt in mod.tasks.TaskType for st in mod.tasks.ExecutionTaskState
                   for t in ex.tracker.tasks_in(tt, st))
    return dict(
        batches=log, tasks=tasks, summary=ex.tracker.summary(),
        moved_mb=ex.tracker.finished_data_movement_mb,
        state=ex.state_summary(), throttles=throttles,
        throttle_after=(backend.throttle_rate, backend.throttled_partitions),
        gauges={k: v.get("value") for k, v in snap.items() if k.startswith("Executor.")
                and v["type"] == "gauge"},
        counters={c: reg.counter(c).count - before[c] for c in counters},
        metadata=sorted((p.topic, p.partition, p.leader, p.replicas)
                        for p in md.fetch().partitions),
        journal=_normalized_journal(path))


@pytest.mark.parametrize("seed,strategy,cap,polls,max_moves", [
    (0, None, 2, 2, 1250),
    (1, "PrioritizeLargeReplicaMovementStrategy", 1, 1, 1250),
    (2, "PrioritizeSmallReplicaMovementStrategy", 3, 3, 1250),
    (3, "com.linkedin.kafka.cruisecontrol.executor.strategy."
        "PostponeUrpReplicaMovementStrategy", 2, 1, 1250),
    (4, None, 5, 2, 25),
])
def test_execution_equals_jax(tmp_path, seed, strategy, cap, polls, max_moves):
    """Task states, every submitted batch in order, throttles, sensors,
    final metadata and the journal: equal in both packages."""
    got = {root: _run(root, seed, tmp_path, strategy=strategy, cap=cap, polls=polls,
                      max_moves=max_moves) for root in PKGS}
    jax_run, port = got["jax"], got["torch"]
    assert port["tasks"] and all(s == "completed" for _, _, s in port["tasks"])
    for key in ("batches", "tasks", "summary", "moved_mb", "state", "throttles",
                "throttle_after", "gauges", "counters", "metadata", "journal"):
        assert port[key] == jax_run[key], key
    assert port["counters"]["Executor.execution-started"] == 1


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("strategy", ["BaseReplicaMovementStrategy",
                                      "PrioritizeLargeReplicaMovementStrategy",
                                      "PrioritizeSmallReplicaMovementStrategy",
                                      "PostponeUrpReplicaMovementStrategy"])
def test_strategy_order_equals_jax(seed, strategy):
    """The planner's inter-broker queue and per-broker batches under each
    strategy, on seeded proposal sets with size ties: the same partitions in
    the same order in both packages."""
    orders = {}
    for root in PKGS:
        mod = _pkg(PKGS[root])
        proposals = _seeded_proposals(mod, 100 + seed, 10, 60)
        planner = mod.planner.ExecutionTaskPlanner(
            mod.strategies.strategy_by_name(strategy, urp={("t0", 3), ("t1", 7)}))
        planner.add_proposals(proposals)
        queue = [t.proposal.topic_partition.partition
                 for t in planner.remaining_inter_broker_tasks]
        batches = []
        while planner.remaining_inter_broker_tasks:
            batch = planner.inter_broker_tasks({b: 2 for b in range(10)}, {}, max_total=7)
            batches.append([t.proposal.topic_partition.partition for t in batch])
        leaders = [t.proposal.topic_partition.partition for t in planner.leadership_tasks(1000)]
        orders[root] = (queue, batches, leaders)
    assert orders["torch"] == orders["jax"]
    assert orders["torch"][1]


def _recovery(root, tmp_path, script):
    """Write a journal by ``script`` (which returns the tasks still moving on
    the cluster), tear its tail, then recover."""
    mod = _pkg(PKGS[root])
    cluster = mod.backend.FakeClusterBackend(_metadata(mod=mod), polls_to_finish=script["polls"])
    path = str(tmp_path / f"{root}-recover.jsonl")
    tasks = list(mod.planner.ExecutionTaskPlanner().add_proposals(
        [proposal("T", p, [0, 1], [2, 1], mod=mod) for p in range(5)]))
    j = mod.journal.ExecutionJournal(path)
    j.begin_batch(tasks)
    S = mod.tasks.ExecutionTaskState
    for i, to in script["transitions"]:
        j.record_transition(tasks[i], getattr(S, to))
    if script.get("end"):
        j.end_batch({"completed": 5, "dead": 0, "aborted": 0})
    j.close()
    if script.get("torn"):
        with open(path, "a", encoding="utf-8") as f:
            f.write(script["torn"])
    cluster.execute_replica_reassignments([tasks[i] for i in script["moving"]])
    ex = mod.executor.Executor(cluster, mod.executor.ExecutorConfig(
        progress_check_interval_s=0.001))
    ex.set_journal(mod.journal.ExecutionJournal(path))
    summary = ex.recover_from_journal(adoption_timeout_s=script["adopt_s"])
    summary = summary and {k: v for k, v in summary.items() if k != "batchId"}
    return summary, os.path.exists(path), ex.state_summary().get("journalRecovery", {}).get(
        "status")


@pytest.mark.parametrize("script", [
    # torn tail, one task moving and draining in the window
    dict(polls=2, adopt_s=1.0, transitions=[(0, "IN_PROGRESS"), (1, "IN_PROGRESS"),
                                            (1, "COMPLETED"), (2, "IN_PROGRESS")],
         moving=[0], torn='{"event": "transi'),
    # partial: two in flight, one never drains inside the window
    dict(polls=500, adopt_s=0.05, transitions=[(0, "IN_PROGRESS"), (3, "IN_PROGRESS")],
         moving=[0]),
    # nothing submitted: all rolled back
    dict(polls=2, adopt_s=0.05, transitions=[], moving=[]),
    # a cleanly ended batch with a torn line after it
    dict(polls=2, adopt_s=0.05, transitions=[(i, s) for i in range(5)
                                             for s in ("IN_PROGRESS", "COMPLETED")],
         moving=[], end=True, torn="{"),
    # only a torn batch_start: no journal to replay
    dict(polls=2, adopt_s=0.05, transitions=[], moving=[], torn=None, only_torn=True),
], ids=["torn-drains", "partial-in-flight", "rolled-back", "clean-end", "torn-start"])
def test_recover_from_journal_equals_jax(tmp_path, script):
    if script.get("only_torn"):
        outcomes = {}
        for root in PKGS:
            mod = _pkg(PKGS[root])
            path = str(tmp_path / f"{root}-torn.jsonl")
            with open(path, "w", encoding="utf-8") as f:
                f.write('{"event": "batch_start", "tasks": [{"tid"')
            ex = mod.executor.Executor(mod.backend.FakeClusterBackend(_metadata(mod=mod)))
            ex.set_journal(mod.journal.ExecutionJournal(path))
            outcomes[root] = (ex.recover_from_journal(), os.path.exists(path))
        assert outcomes["torch"] == outcomes["jax"] == (None, True)
        return
    got = {root: _recovery(root, tmp_path, script) for root in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["journaledTasks"] == 5
