"""Metamorphic invariant harness over
:mod:`cruise_control_tpu_torch.testing.verifier` (the JAX package's
``fuzzsvc/invariants.py``, on the port's modules).

Absolute postconditions ("zero hard-goal violations") are wrong for an
adversarial corpus — a scenario with two dead racks may be unsatisfiable
by construction.  Every check here is therefore *relational*: the solve
must never make things worse (hard goals, soft-goal stats), its output
must be executable and conservative (proposals, loads), and independent
execution strategies must agree (mesh vs one rank, chunked vs unchunked
lanes).  The last two are the safety net for solver rewrites: any kernel
change that breaks parity fails EVERY scenario kind that carries the
invariant, not just a hand-picked unit test.

Each invariant is a function ``(Materialized) -> List[str]`` returning
failure details (empty = holds); the registry keys are the names used in
:data:`cruise_control_tpu_torch.fuzzsvc.scenario.Scenario.invariants`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.budget import SolveBudget
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.analyzer.relax import RelaxationConfig
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.fuzzsvc.scenario import Scenario
from cruise_control_tpu_torch.model import ops
from cruise_control_tpu_torch.testing.verifier import verify_placement


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclass
class InvariantResult:
    name: str
    ok: bool
    detail: str = ""
    elapsed_s: float = 0.0

    def __str__(self) -> str:
        tag = "ok" if self.ok else "FAIL"
        return f"{self.name}: {tag}" + (f" — {self.detail}" if self.detail else "")


@dataclass
class Materialized:
    """One scenario's frozen snapshot on ``device`` plus the lazily-shared
    base solve.

    Every invariant needs the same ``optimizations()`` result; computing it
    once per scenario (instead of once per invariant) is what keeps an
    8-scenario smoke inside the tier-1 timeout.  ``relaxation`` is the
    relaxed solve's parameters (``solver.relaxation.*``), whose tolerance
    ``relaxation_sound`` holds the relaxed result to."""

    scenario: Scenario
    state: object = None
    placement: object = None
    meta: object = None
    _base: object = field(default=None, repr=False)
    device: object = "cuda"
    relaxation: RelaxationConfig = field(default_factory=RelaxationConfig)

    def __post_init__(self):
        if self.state is None:
            self.state, self.placement, self.meta = self.scenario.materialize(self.device)

    @property
    def base(self):
        if self._base is None:
            opt = GoalOptimizer(goal_names=list(self.scenario.goal_names))
            self._base = opt.optimizations(self.state, self.placement, self.meta)
        return self._base

    def goal_context(self, placement):
        gctx = build_context(self.state, self.placement, self.meta,
                             BalancingConstraint(), OptimizationOptions())
        return gctx, compute_aggregates(gctx, placement)

    def shadow(self, result) -> "Materialized":
        """The same snapshot with ``result`` standing in for the base solve."""
        return Materialized(self.scenario, state=self.state, placement=self.placement,
                            meta=self.meta, _base=result, device=self.device,
                            relaxation=self.relaxation)


# --------------------------------------------------------------------------
# base invariants (every scenario kind)
# --------------------------------------------------------------------------

def hard_goals_never_worsen(m: Materialized) -> List[str]:
    """Per hard goal, the violated-broker count after the solve is <= the
    count before it (metamorphic — the scenario may be unsatisfiable, but
    a balancer must never manufacture NEW hard violations)."""
    out: List[str] = []
    final = m.base.final_placement
    gctx, agg0 = m.goal_context(m.placement)
    _, agg1 = m.goal_context(final)
    for name in m.scenario.goal_names:
        goal = goal_by_name(name)
        if not goal.is_hard:
            continue
        before = int(goal.violated_brokers(gctx, m.placement, agg0).sum())
        after = int(goal.violated_brokers(gctx, final, agg1).sum())
        if after > before:
            out.append(f"{name}: violated brokers {before} -> {after}")
    return out


def soft_goals_no_regression(m: Materialized) -> List[str]:
    """The verifier's REGRESSION comparator over the base solve's per-goal
    stats: no goal that actually ran may end with a worse metric."""
    fails = verify_placement(
        m.state, m.placement, m.meta, m.base.final_placement,
        goal_names=(), verifications=("REGRESSION",),
        goal_infos=m.base.goal_infos)
    return [str(f) for f in fails if f.check == "REGRESSION"]


def proposals_executable(m: Materialized) -> List[str]:
    """Every emitted proposal must be executable against the model: old
    replicas match the starting placement, new replicas are distinct known
    alive brokers (on alive disks), and the new leader is in the new set."""
    out: List[str] = []
    n = m.meta.num_replicas
    part = _np(m.state.partition)[:n]
    b0 = _np(m.placement.broker)[:n]
    l0 = _np(m.placement.is_leader)[:n]
    alive = _np(m.state.alive)
    disk_alive = _np(m.state.disk_alive)
    broker_ids = set(m.meta.broker_ids)
    bindex = m.meta.broker_index

    # (topic name, partition number) -> partition row id.
    pid_of = {(m.meta.topics[t], pn): pid
              for pid, (t, pn) in enumerate(m.meta.partitions)}

    for prop in m.base.proposals:
        tp = prop.topic_partition
        pid = pid_of.get((tp.topic, tp.partition))
        if pid is None:
            out.append(f"{tp}: unknown partition")
            continue
        rows = np.nonzero(part == pid)[0]
        have_old = {int(b) for b in b0[rows]}
        said_old = {r.broker_id for r in prop.old_replicas}
        if have_old != said_old:
            out.append(f"{tp}: old replicas {sorted(said_old)} != "
                       f"model placement {sorted(have_old)}")
        leader_rows = rows[l0[rows]]
        if leader_rows.size != 1 or int(b0[leader_rows[0]]) != prop.old_leader.broker_id:
            out.append(f"{tp}: old leader {prop.old_leader.broker_id} "
                       "does not match model leadership")
        new = [r.broker_id for r in prop.new_replicas]
        if len(set(new)) != len(new):
            out.append(f"{tp}: duplicate brokers in new replicas {new}")
        for r in prop.new_replicas:
            if r.broker_id not in broker_ids:
                out.append(f"{tp}: new replica on unknown broker {r.broker_id}")
                continue
            bi = bindex[r.broker_id]
            if not alive[bi]:
                out.append(f"{tp}: new replica on dead broker {r.broker_id}")
            if r.logdir is not None and not disk_alive[bi, r.logdir]:
                out.append(f"{tp}: new replica on dead disk "
                           f"{r.broker_id}.{r.logdir}")
        if prop.new_leader.broker_id not in set(new):
            out.append(f"{tp}: new leader outside the new replica set")
    return out


def load_conservation(m: Materialized) -> List[str]:
    """Applying the proposals moves load, never creates or destroys it:
    exactly one leader per partition, replication-invariant resource
    totals (disk, nw-in) conserved, and the verifier's LOAD_CONSISTENCY
    recompute agrees with the device aggregation."""
    out: List[str] = []
    final = m.base.final_placement
    n = m.meta.num_replicas
    part = _np(m.state.partition)[:n]
    leaders = np.bincount(part[_np(final.is_leader)[:n]],
                          minlength=len(m.meta.partitions))
    bad = np.nonzero(leaders != 1)[0]
    if bad.size:
        out.append(f"{bad.size} partitions without exactly one leader "
                   f"(first: p{int(bad[0])} has {int(leaders[bad[0]])})")
    # Disk / NW_IN are identical for leaders and followers, so their
    # cluster totals must survive any placement + leadership shuffle.
    before = _np(ops.broker_load(m.state, m.placement).sum(dim=0))
    after = _np(ops.broker_load(m.state, final).sum(dim=0))
    for res in (Resource.DISK, Resource.NW_IN):
        if not np.isclose(before[res], after[res], rtol=1e-4, atol=1e-3):
            out.append(f"{res.name} total changed "
                       f"{before[res]:.6g} -> {after[res]:.6g}")
    out.extend(str(f) for f in verify_placement(
        m.state, m.placement, m.meta, final, verifications=()))
    return out


def resident_delta_equivalence(m: Materialized) -> List[str]:
    """Metamorphic check of the resident-model delta path: after rounds of
    random journalled mutations (loads, leadership, broker liveness,
    replica create/delete), the tensors produced by applying the collected
    deltas must be BITWISE equal to a fresh full freeze of the same builder.
    Any dtype/rounding/ordering divergence between the two paths would let
    solver answers depend on how the model reached the device, which the
    steady-state resident cache must never allow."""
    from cruise_control_tpu_torch.model.builder import builder_from_snapshot
    from cruise_control_tpu_torch.model.state import apply_deltas

    pad_r, pad_b = m.scenario.pad_replicas_to, m.scenario.pad_brokers_to
    cm = builder_from_snapshot(m.state, m.placement, m.meta)
    cm.enable_delta_tracking()
    state, placement, _ = cm.freeze(pad_replicas_to=pad_r, pad_brokers_to=pad_b,
                                    device=m.device)
    rng = np.random.default_rng(m.scenario.seed ^ 0x5EED)
    out: List[str] = []
    applied = 0
    for _ in range(3):
        parts = list(cm.partitions().keys())
        broker_ids = [b.broker_id for b in cm.brokers()]
        for _ in range(8):
            t, p = parts[int(rng.integers(len(parts)))]
            rs = cm.partition(t, p)
            if not rs:
                continue
            op = int(rng.integers(0, 4))
            if op == 0:
                for r in list(rs):
                    cm.set_replica_load(t, p, r.broker_id,
                                        rng.uniform(0.5, 40.0, size=4))
            elif op == 1 and len(rs) >= 2:
                leader = next((r for r in rs if r.is_leader), None)
                follower = next((r for r in rs if not r.is_leader), None)
                if leader is not None and follower is not None:
                    cm.relocate_leadership(t, p, leader.broker_id,
                                           follower.broker_id)
            elif op == 2:
                b = cm.broker(broker_ids[int(rng.integers(len(broker_ids)))])
                cm.set_broker_state(b.broker_id, alive=not b.alive)
            elif len(rs) >= 2 and int(rng.integers(2)):
                cm.delete_replica(t, p, rs[-1].broker_id)
            else:
                held = {r.broker_id for r in rs}
                free = [b for b in broker_ids if b not in held]
                if free:
                    cm.create_replica(t, p, broker_id=free[0], index=len(rs),
                                      is_leader=False)
                    cm.set_replica_load(t, p, free[0],
                                        rng.uniform(0.5, 40.0, size=4))
        delta = cm.collect_delta()
        if delta is None:
            # Inexpressible edit / overflow: the service would full-freeze
            # here, which is trivially equivalent — re-anchor and continue.
            state, placement, _ = cm.freeze(pad_replicas_to=pad_r, pad_brokers_to=pad_b,
                                            device=m.device)
            continue
        state, placement = apply_deltas(state, placement, delta)
        applied += 1
    want_s, want_p, _ = cm.freeze(pad_replicas_to=pad_r, pad_brokers_to=pad_b,
                                  device=m.device)
    for name in ("leader_load", "follower_load", "partition", "topic", "pos",
                 "orig_broker", "offline", "valid", "capacity", "alive",
                 "new_broker", "broker_valid", "disk_capacity", "disk_alive"):
        a, b = getattr(state, name), getattr(want_s, name)
        if a.dtype != b.dtype or a.shape != b.shape or not bool((a == b).all()):
            out.append(f"state.{name}: delta path != fresh freeze")
    for name in ("broker", "disk", "is_leader"):
        if not bool((getattr(placement, name) == getattr(want_p, name)).all()):
            out.append(f"placement.{name}: delta path != fresh freeze")
    if applied == 0:
        out.append("no delta was ever applied (mutation stream degenerate)")
    return out


def convergence_curve_coherent(m: Materialized) -> List[str]:
    """The trace.solver.rounds telemetry is honest on this scenario:
    re-solving with the round recorder on must yield, per goal, a curve
    whose length equals the reported round count, whose summed applied
    column equals ``moves_applied``, and — for hard goals — whose violated
    count never increases across rounds (the solver only accepts
    non-worsening batches).  Any solver rewrite that desyncs the recorded
    buffer from the loop it instruments fails here on every scenario kind."""
    from cruise_control_tpu_torch.analyzer import solver as solver_mod
    from cruise_control_tpu_torch.obsvc.convergence import (
        ROUND_COL_APPLIED, ROUND_COL_VIOLATED)

    prev = solver_mod.round_recording_enabled()
    solver_mod.set_round_recording(True)
    try:
        res = GoalOptimizer(goal_names=list(m.scenario.goal_names)
                            ).optimizations(m.state, m.placement, m.meta)
    finally:
        solver_mod.set_round_recording(prev)
    out: List[str] = []
    for info in res.goal_infos:
        curve = info.round_curve
        if curve is None:
            out.append(f"{info.goal_name}: recorder on but no curve")
            continue
        arr = np.asarray(curve)
        if len(arr) != info.rounds:
            out.append(f"{info.goal_name}: curve length {len(arr)} != "
                       f"reported rounds {info.rounds}")
        applied = int(arr[:, ROUND_COL_APPLIED].sum()) if len(arr) else 0
        if applied != info.moves_applied:
            out.append(f"{info.goal_name}: summed per-round applied "
                       f"{applied} != moves_applied {info.moves_applied}")
        if goal_by_name(info.goal_name).is_hard and len(arr) >= 2:
            viol = arr[:, ROUND_COL_VIOLATED]
            if np.any(np.diff(viol) > 0):
                out.append(f"{info.goal_name}: violated-broker count "
                           f"increased mid-solve: {viol.tolist()}")
    return out


def memory_ledger_balanced(m: Materialized) -> List[str]:
    """The device-memory ledger's books close over a full resident-model
    lifecycle on this scenario: a pinned freeze posts live bytes, a
    journalled mutation takes the delta path without moving the total (the
    port's apply writes copies and posts their alloc and the replaced
    tensors' free, where the JAX package posts one donation),
    release/invalidate drain pins and bytes back to zero, no post ever
    drives a subsystem negative (imbalance counter), and the tracked total
    stays within tolerance of the card's allocated bytes (on the CPU the
    ledger reads none, and its drift is None).  Runs against a
    scenario-private ledger so fuzz processes with ``memory.enabled=false``
    still exercise the accounting."""
    from cruise_control_tpu_torch.model.builder import builder_from_snapshot
    from cruise_control_tpu_torch.model.resident import ResidentModelService
    from cruise_control_tpu_torch.obsvc.memory import (
        SUBSYS_RESIDENT, DeviceMemoryLedger, memory_ledger, set_memory_ledger)

    prev = memory_ledger()
    ledger = DeviceMemoryLedger()
    ledger.configure(enabled=True, analysis_mode="off")
    set_memory_ledger(ledger)
    imb0 = ledger.imbalance_count
    out: List[str] = []
    try:
        svc = ResidentModelService(enabled=True, device=m.device)
        cm = builder_from_snapshot(m.state, m.placement, m.meta)
        pad = (m.scenario.pad_replicas_to, m.scenario.pad_brokers_to)
        svc.snapshot(cm, lambda r, b: pad, pin=True)
        frozen = ledger.live_bytes(SUBSYS_RESIDENT)
        if frozen <= 0:
            out.append("pinned full freeze posted no resident live bytes")
        if ledger.pins(SUBSYS_RESIDENT) != 1:
            out.append(f"pin count after pinned snapshot: "
                       f"{ledger.pins(SUBSYS_RESIDENT)} != 1")
        svc.release()
        # One journalled load edit → the next snapshot rides the delta path:
        # a net-zero alloc/free pair, not a byte movement.
        (t, p), _ = next(iter(cm.partitions().items()))
        rs = cm.partition(t, p)
        if rs:
            cm.set_replica_load(t, p, rs[0].broker_id,
                                np.full(4, 7.0, dtype=np.float64))
        ev0 = ledger.events()
        svc.snapshot(cm, lambda r, b: pad)
        ev1 = ledger.events()
        if ledger.live_bytes(SUBSYS_RESIDENT) != frozen:
            out.append(f"delta apply moved resident bytes: {frozen} -> "
                       f"{ledger.live_bytes(SUBSYS_RESIDENT)}")
        svc.invalidate("fuzz memory_ledger_balanced")
        if ledger.live_bytes() != 0:
            out.append(f"live bytes after invalidate: {ledger.live_bytes()}")
        ev = ledger.events()
        if ev.get("alloc", 0) != ev.get("free", 0):
            out.append(f"alloc/free events unbalanced: {ev}")
        if ev.get("pin", 0) != ev.get("release", 0):
            out.append(f"pin/release events unbalanced: {ev}")
        if rs and not all(ev1.get(k, 0) > ev0.get(k, 0) for k in ("alloc", "free")):
            out.append("delta apply posted no alloc/free pair for its copies")
        if ledger.imbalance_count != imb0:
            out.append(f"{ledger.imbalance_count - imb0} post imbalances "
                       "(a free exceeded tracked bytes or a release had "
                       "no pin)")
        out.extend(ledger.verify_balanced())
    finally:
        set_memory_ledger(prev)
    return out


# --------------------------------------------------------------------------
# kind-specific invariants
# --------------------------------------------------------------------------

def stranded_cleared(m: Materialized) -> List[str]:
    """Dead-broker / dead-disk scenarios: the solve must evacuate every
    offline replica (the verifier's DEAD_BROKERS postcondition)."""
    fails = verify_placement(
        m.state, m.placement, m.meta, m.base.final_placement,
        verifications=("DEAD_BROKERS",))
    return [str(f) for f in fails if f.check == "DEAD_BROKERS"]


def mesh_parity(m: Materialized) -> List[str]:
    """solver(mesh) == solver(one rank) on this scenario (same
    violated-broker outcomes per goal; near-identical final CV).  The mesh
    spans every rank of the default process group; with one rank there is
    nothing to compare.  Every rank must run it together."""
    import torch.distributed as dist

    from cruise_control_tpu_torch.parallel import make_solver_mesh
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    if n_dev < 2 or m.scenario.pad_replicas_to % n_dev:
        return []  # one rank (or indivisible pad): nothing to compare
    sharded = GoalOptimizer(goal_names=list(m.scenario.goal_names),
                            mesh=make_solver_mesh(n_dev)).optimizations(
        m.state, m.placement, m.meta)
    out: List[str] = []
    for b, s in zip(m.base.goal_infos, sharded.goal_infos):
        if s.violated_brokers_after != b.violated_brokers_after:
            out.append(f"{b.goal_name}: violated_after mesh="
                       f"{s.violated_brokers_after} single={b.violated_brokers_after}")
    cv_base = m.base.stats_after.cv()
    cv_shard = sharded.stats_after.cv()
    if not np.allclose(cv_shard, cv_base, rtol=0.05, atol=5e-3):
        out.append(f"final CV diverged: mesh={cv_shard} single={cv_base}")
    return out


def chunked_parity(m: Materialized) -> List[str]:
    """chunked == unchunked what-if lane solves on this scenario's
    remove/add sets (exact equality: lanes are independent, so lane routing
    must be invisible)."""
    from cruise_control_tpu_torch.compilesvc import (
        CompileService, ShapeBucketPolicy, compile_service, set_compile_service)
    sets = m.scenario.whatif_remove or m.scenario.whatif_add
    if not sets:
        return []
    # Two goals keep the per-variant cost bounded; parity over a subset of
    # the stack is still parity of the lane-routing machinery.
    goals = list(m.scenario.goal_names[:2])
    batch = ("batch_remove_scenarios" if m.scenario.whatif_remove
             else "batch_add_scenarios")
    prev = compile_service()
    try:
        set_compile_service(CompileService(policy=ShapeBucketPolicy(max_lane_bucket=2)))
        chunked = getattr(GoalOptimizer(goal_names=goals), batch)(
            m.state, m.placement, m.meta, sets, num_candidates=64)
        set_compile_service(CompileService(chunking_enabled=False))
        plain = getattr(GoalOptimizer(goal_names=goals), batch)(
            m.state, m.placement, m.meta, sets, num_candidates=64)
    finally:
        set_compile_service(prev)
    out: List[str] = []
    for name in ("violated_after", "moves", "stranded_after"):
        a, b = np.asarray(getattr(chunked, name)), np.asarray(getattr(plain, name))
        if not np.array_equal(a, b):
            out.append(f"{batch}.{name}: chunked != unchunked")
    for s in range(len(sets)):
        a, b = chunked.placement_for(s), plain.placement_for(s)
        if not (torch.equal(a.broker, b.broker) and torch.equal(a.is_leader, b.is_leader)):
            out.append(f"lane {s}: final placement diverged")
    return out


class _SegmentCountdown(SolveBudget):
    """A budget that self-cancels after N ``stop_reason`` probes.

    Deadlines are wall-clock and therefore irreproducible in a fuzzer; a
    countdown preempts at an exact, seed-chosen segment/goal boundary so a
    failing scenario replays to the same partial placement every time."""

    def __init__(self, segments: int):
        super().__init__(segmented=True)
        self._segments_left = int(segments)

    def stop_reason(self) -> Optional[str]:
        reason = super().stop_reason()
        if reason is not None:
            return reason
        self._segments_left -= 1
        if self._segments_left <= 0:
            self.cancel("fuzz-preempt")
            return self.cancel_reason
        return None


def partial_solve_safe(m: Materialized) -> List[str]:
    """Preempt the solve at a random segment boundary: the partial
    placement must still satisfy every safety property the full solve
    guarantees — no new hard-goal violations, conserved loads, and
    executable proposals.  The anytime contract is exactly that stopping
    early degrades *quality*, never *safety*."""
    rng = np.random.default_rng(m.scenario.seed ^ 0xCA11)
    budget = _SegmentCountdown(int(rng.integers(1, 7)))
    res = GoalOptimizer(goal_names=list(m.scenario.goal_names)
                        ).optimizations(m.state, m.placement, m.meta,
                                        budget=budget)
    out: List[str] = []
    if budget.cancelled() and not res.partial:
        out.append("budget cancelled mid-solve but result not tagged partial")
    if res.partial and not any(i.preempted for i in res.goal_infos):
        out.append("partial result but no goal reports preempted")
    shadow = m.shadow(res)
    for check in (hard_goals_never_worsen, load_conservation,
                  proposals_executable):
        out.extend(f"[partial] {d}" for d in check(shadow))
    return out


def relaxation_sound(m: Materialized) -> List[str]:
    """Convex-relaxation fast path soundness: re-solve the scenario with the
    relaxation on (``m.relaxation``, the ``solver.relaxation.*`` keys).  The
    relax+round+repair result must pass the same safety net as any solve
    (hard goals never worsen, load conservation, executable proposals) and
    each goal's final soft metric must land within
    ``solver.relaxation.tolerance`` of pure greedy's — the fast path is
    allowed to trade exact tie-breaking for speed, never balance quality
    beyond the configured slack."""
    res = GoalOptimizer(goal_names=list(m.scenario.goal_names),
                        relaxation=m.relaxation).optimizations(m.state, m.placement, m.meta)
    out: List[str] = []
    shadow = m.shadow(res)
    for check in (hard_goals_never_worsen, load_conservation,
                  proposals_executable):
        out.extend(f"[relax] {d}" for d in check(shadow))
    tol = m.relaxation.tolerance
    base_by_name = {i.goal_name: i for i in m.base.goal_infos}
    for info in res.goal_infos:
        b = base_by_name.get(info.goal_name)
        if b is None:
            continue
        slack = tol * max(abs(b.metric_before), abs(b.metric_after)) + 1e-6
        if info.metric_after > b.metric_after + slack:
            out.append(f"{info.goal_name}: relaxed metric "
                       f"{info.metric_after:.6g} trails greedy "
                       f"{b.metric_after:.6g} beyond tolerance {tol}")
    return out


def provenance_complete(m: Materialized) -> List[str]:
    """Execution-observatory provenance is total on this scenario: with the
    flight recorder on, every proposal the optimizer emits resolves to
    exactly one provenance record whose path is a known pipeline stage
    (relax/rounding/repair/greedy), naming a goal the solve actually ran,
    and the path histogram sums to the proposal count — no move can reach
    the executor without a decision lineage."""
    from cruise_control_tpu_torch.obsvc.execution import (
        PATHS, execution, path_histogram)

    rec = execution()
    prev = rec.enabled
    rec.configure(enabled=True)
    try:
        res = GoalOptimizer(goal_names=list(m.scenario.goal_names)
                            ).optimizations(m.state, m.placement, m.meta)
    finally:
        rec.configure(enabled=prev)
    out: List[str] = []
    solved = {i.goal_name for i in res.goal_infos}
    for p in res.proposals:
        prov = getattr(p, "provenance", None)
        if not prov:
            out.append(f"{p.topic_partition}: move without provenance")
            continue
        if prov.get("path") not in PATHS:
            out.append(f"{p.topic_partition}: unknown provenance path "
                       f"{prov.get('path')!r}")
        if prov.get("goal") not in solved:
            out.append(f"{p.topic_partition}: provenance goal "
                       f"{prov.get('goal')!r} was never solved")
    hist = path_histogram(res.proposals)
    if sum(hist.values()) != len(res.proposals):
        out.append(f"path histogram {hist} sums to {sum(hist.values())} "
                   f"!= {len(res.proposals)} proposals")
    if hist.get("unknown"):
        out.append(f"{hist['unknown']} moves fell into the 'unknown' "
                   "provenance bucket")
    return out


def fingerprint_coherent(m: Materialized) -> List[str]:
    """Model-fidelity accounting is honest on this scenario: a fingerprint
    condensed from a synthetic aggregation (windows/gaps derived from the
    scenario seed) must agree with an independent per-entity recount of the
    aggregator's extrapolation output, and with the fidelity recorder live
    every proposal the optimizer emits carries exactly one fingerprint
    whose generation matches the model the solve actually read — no move
    can reach the executor without a data-quality lineage."""
    from cruise_control_tpu_torch.monitor.aggregator import (
        AggregationOptions, MetricSampleAggregator)
    from cruise_control_tpu_torch.monitor.metric_def import COMMON_METRIC_DEF
    from cruise_control_tpu_torch.obsvc.fidelity import (
        EXTRAPOLATION_KINDS, ModelFidelityRecorder, fidelity)

    out: List[str] = []
    rng = np.random.default_rng(m.scenario.seed ^ 0xF1D0)
    window_ms, n_windows = 1_000, 6
    agg = MetricSampleAggregator(COMMON_METRIC_DEF,
                                 num_windows=n_windows, window_ms=window_ms,
                                 min_samples_per_window=2,
                                 max_allowed_extrapolations_per_entity=4)
    n_metrics = COMMON_METRIC_DEF.size
    entities = [("t", p) for p in range(8)]
    for w in range(n_windows + 1):
        for e in entities:
            # Seeded gap pattern: each entity-window gets 0..3 samples, so
            # the corpus exercises every extrapolation kind over time.
            for _ in range(int(rng.integers(0, 4))):
                agg.add_sample(e, w * window_ms + 10,
                               rng.uniform(1.0, 9.0, size=n_metrics))
    try:
        result = agg.aggregate(0, (n_windows + 1) * window_ms,
                               AggregationOptions(min_valid_windows=1))
    except Exception as exc:  # noqa: BLE001 — degenerate corpus, not a bug
        return [f"synthetic aggregation raised {type(exc).__name__}: {exc}"]
    comp = result.completeness

    # Independent recount from the per-entity extrapolation maps (valid
    # entities only — exactly what values_and_extrapolations holds).
    recount = {k: 0 for k in EXTRAPOLATION_KINDS}
    for ve in result.values_and_extrapolations.values():
        for kind in ve.extrapolations.values():
            if kind.name in recount:
                recount[kind.name] += 1
    counted = {"AVG_AVAILABLE": comp.num_windows_avg_available,
               "AVG_ADJACENT": comp.num_windows_avg_adjacent,
               "FORECAST": comp.num_windows_forecast}
    if recount != counted:
        out.append(f"completeness by-kind counts {counted} != independent "
                   f"recount {recount}")
    want_windows = (len(result.values_and_extrapolations)
                    * len(comp.valid_windows))
    if comp.num_entity_windows != want_windows:
        out.append(f"num_entity_windows {comp.num_entity_windows} != "
                   f"valid entities x windows {want_windows}")

    rec = ModelFidelityRecorder(enabled=True)
    fp = rec.record_fingerprint(comp, window_ms=window_ms)
    if fp is None:
        return out + ["record_fingerprint returned None while enabled"]
    if fp["validWindows"] != len(comp.valid_windows):
        out.append(f"fingerprint validWindows {fp['validWindows']} != "
                   f"{len(comp.valid_windows)}")
    if abs(fp["validPartitionRatio"] - comp.valid_entity_ratio) > 1e-6:
        out.append(f"fingerprint ratio {fp['validPartitionRatio']} != "
                   f"completeness {comp.valid_entity_ratio}")
    denom = max(comp.num_entity_windows, 1)
    for kind in EXTRAPOLATION_KINDS:
        want = recount[kind] / denom
        got = fp["extrapolatedFraction"][kind]
        if abs(got - want) > 1e-6:
            out.append(f"extrapolatedFraction[{kind}] {got} != recounted "
                       f"{want:.6f}")
    if fp["generation"] != agg.generation:
        out.append(f"fingerprint generation {fp['generation']} != aggregator "
                   f"generation {agg.generation}")

    # Solve with the recorder live: every proposal carries exactly the
    # fingerprint of the model generation the solve read.  One goal from
    # the shared smoke stack is enough — stamping happens at the result
    # level, so goal count adds cost, not coverage (the distribution goal
    # is the one that reliably emits moves on fuzzed skew).
    live = fidelity()
    prev_enabled, prev_fp = live.enabled, live._fingerprint
    live.configure(enabled=True)
    live._fingerprint = fp
    try:
        stamp_goals = [g for g in m.scenario.goal_names
                       if g == "ReplicaDistributionGoal"] \
            or list(m.scenario.goal_names)[:1]
        res = GoalOptimizer(goal_names=stamp_goals
                            ).optimizations(m.state, m.placement, m.meta)
    finally:
        live.configure(enabled=prev_enabled)
        live._fingerprint = prev_fp
    if res.fingerprint is None:
        out.append("result carries no fingerprint with the recorder live")
    elif res.fingerprint["generation"] != fp["generation"]:
        out.append(f"result fingerprint generation "
                   f"{res.fingerprint['generation']} != {fp['generation']}")
    for p in res.proposals:
        pfp = getattr(p, "fingerprint", None)
        if pfp is None:
            out.append(f"{p.topic_partition}: move without a fingerprint")
        elif pfp["generation"] != fp["generation"]:
            out.append(f"{p.topic_partition}: fingerprint generation "
                       f"{pfp['generation']} != {fp['generation']}")
    return out


INVARIANTS: Dict[str, Callable[[Materialized], List[str]]] = {
    "hard_goals_never_worsen": hard_goals_never_worsen,
    "soft_goals_no_regression": soft_goals_no_regression,
    "proposals_executable": proposals_executable,
    "load_conservation": load_conservation,
    "resident_delta_equivalence": resident_delta_equivalence,
    "convergence_curve_coherent": convergence_curve_coherent,
    "partial_solve_safe": partial_solve_safe,
    "relaxation_sound": relaxation_sound,
    "memory_ledger_balanced": memory_ledger_balanced,
    "provenance_complete": provenance_complete,
    "fingerprint_coherent": fingerprint_coherent,
    "stranded_cleared": stranded_cleared,
    "mesh_parity": mesh_parity,
    "chunked_parity": chunked_parity,
}


def run_invariants(scenario: Scenario,
                   which: Optional[Sequence[str]] = None,
                   materialized: Optional[Materialized] = None,
                   device="cuda") -> List[InvariantResult]:
    """Run the scenario's invariant set (or ``which``) and collect results;
    an invariant that raises is itself a failure, not a crash of the run."""
    m = materialized or Materialized(scenario, device=device)
    results: List[InvariantResult] = []
    for name in (which or scenario.invariants):
        fn = INVARIANTS.get(name)
        t0 = time.monotonic()
        if fn is None:
            results.append(InvariantResult(name, False, "unknown invariant"))
            continue
        try:
            details = fn(m)
        except Exception as exc:  # noqa: BLE001 — report, keep fuzzing
            details = [f"raised {type(exc).__name__}: {exc}"]
        results.append(InvariantResult(
            name, ok=not details, detail="; ".join(details),
            elapsed_s=time.monotonic() - t0))
    return results
