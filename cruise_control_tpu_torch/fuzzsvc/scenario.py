"""Seed-deterministic adversarial scenario generator (the JAX package's
``fuzzsvc/scenario.py``, copied as it is but for the device and the replay
command).

Composes :mod:`cruise_control_tpu_torch.testing.random_cluster` (never forks it)
into the taxonomy the ROADMAP's fuzzer item names: heterogeneous racks and
capacity tiers, exponential partition-size skew, dead brokers and dead
disks, maintenance windows, and mid-flight broker add/remove what-ifs.
Everything about a scenario derives from ``(seed, kind)`` through one
``np.random.default_rng(seed)`` stream, so a one-line replay command
reproduces any failure bit-for-bit; the JSON round-trip exists for the
shrinker, whose reduced scenarios no longer match any seed.

Shape discipline: every smoke-profile scenario pads to the SAME
``(pad_replicas_to, pad_brokers_to)`` targets and runs the SAME goal stack,
so eight scenarios share one dispatch family per goal (compilesvc's bucket
idea applied to the fuzzer's own workload).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch.testing import random_cluster as rc

# Kinds double as the taxonomy in docs/FUZZING.md — keep the two in sync.
SCENARIO_KINDS: Tuple[str, ...] = (
    "uniform_baseline",
    "exp_skew",
    "hetero_racks",
    "dead_brokers",
    "dead_disks",
    "maintenance_window",
    "broker_add",
    "broker_remove",
)

# One fixed stack for the whole smoke corpus: capacity + structure + one
# distribution goal — small enough to compile fast, wide enough that every
# scenario kind has a goal that reacts to it.
SMOKE_GOALS: Tuple[str, ...] = (
    "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
    "ReplicaDistributionGoal",
)

BASE_INVARIANTS: Tuple[str, ...] = (
    "hard_goals_never_worsen", "soft_goals_no_regression",
    "proposals_executable", "load_conservation",
    "resident_delta_equivalence", "convergence_curve_coherent",
    "partial_solve_safe", "relaxation_sound", "memory_ledger_balanced",
    "provenance_complete", "fingerprint_coherent",
)

# Shared padded shapes for the smoke profile (see module docstring).
SMOKE_PAD_REPLICAS = 1024
SMOKE_PAD_BROKERS = 16


@dataclass
class StormEvent:
    """One chaos injection inside a storm cycle."""

    kind: str            # fail_broker | fail_disk | stuck_broker |
    #                      maintenance | stop_mid_flight
    at_cycle: int = 0
    broker: int = -1
    disk: int = 0
    plan: str = ""       # maintenance plan name when kind == "maintenance"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StormEvent":
        return cls(**d)


@dataclass
class Scenario:
    """A fully-specified fuzz case: cluster properties + goal stack +
    what-if lanes + storm events + the invariants that must hold."""

    name: str
    kind: str
    seed: int
    props: rc.ClusterProperties
    goal_names: List[str] = field(default_factory=lambda: list(SMOKE_GOALS))
    invariants: Tuple[str, ...] = BASE_INVARIANTS
    whatif_remove: List[List[int]] = field(default_factory=list)
    whatif_add: List[List[int]] = field(default_factory=list)
    events: List[StormEvent] = field(default_factory=list)
    pad_replicas_to: int = SMOKE_PAD_REPLICAS
    pad_brokers_to: int = SMOKE_PAD_BROKERS

    # ------------------------------------------------------------ material
    def materialize(self, device="cuda"):
        """(state, placement, meta) — the frozen SoA snapshot on ``device``."""
        return rc.generate(self.props, pad_replicas_to=self.pad_replicas_to,
                           pad_brokers_to=self.pad_brokers_to, device=device)

    # ---------------------------------------------------------------- json
    def to_json(self) -> str:
        props = dataclasses.asdict(self.props)
        props["distribution"] = self.props.distribution.name
        return json.dumps({
            "name": self.name, "kind": self.kind, "seed": self.seed,
            "props": props, "goal_names": list(self.goal_names),
            "invariants": list(self.invariants),
            "whatif_remove": self.whatif_remove,
            "whatif_add": self.whatif_add,
            "events": [e.to_dict() for e in self.events],
            "pad_replicas_to": self.pad_replicas_to,
            "pad_brokers_to": self.pad_brokers_to,
        }, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "Scenario":
        d = json.loads(raw)
        props = dict(d["props"])
        props["distribution"] = rc.Distribution[props["distribution"]]
        if props.get("dead_broker_ids") is not None:
            props["dead_broker_ids"] = tuple(props["dead_broker_ids"])
        if props.get("dead_disk_ids") is not None:
            props["dead_disk_ids"] = tuple(
                (int(b), int(k)) for b, k in props["dead_disk_ids"])
        return cls(
            name=d["name"], kind=d["kind"], seed=int(d["seed"]),
            props=rc.ClusterProperties(**props),
            goal_names=list(d["goal_names"]),
            invariants=tuple(d["invariants"]),
            whatif_remove=[list(map(int, s)) for s in d["whatif_remove"]],
            whatif_add=[list(map(int, s)) for s in d["whatif_add"]],
            events=[StormEvent.from_dict(e) for e in d["events"]],
            pad_replicas_to=int(d["pad_replicas_to"]),
            pad_brokers_to=int(d["pad_brokers_to"]),
        )

    def replay_command(self, corpus_path: Optional[str] = None,
                       device: str = "cuda") -> str:
        """The one-liner that reproduces this scenario on ``device``."""
        head = f"python -m cruise_control_tpu_torch.fuzzsvc --device {device}"
        if corpus_path:
            return f"{head} --replay {corpus_path}"
        return f"{head} --seed {self.seed} --kind {self.kind}"


def generate_scenario(seed: int, kind: Optional[str] = None) -> Scenario:
    """Deterministic scenario from ``(seed, kind)``; ``kind=None`` lets the
    seed pick one, so a bare ``--seed N`` replay is still complete."""
    rng = np.random.default_rng(seed)
    # Draw the kind from the stream even when given, so the rest of the
    # stream is identical either way and --seed/--kind replays agree.
    drawn = SCENARIO_KINDS[int(rng.integers(0, len(SCENARIO_KINDS)))]
    kind = kind or drawn
    if kind not in SCENARIO_KINDS:
        raise ValueError(f"unknown scenario kind {kind!r}; "
                         f"expected one of {SCENARIO_KINDS}")

    num_brokers = 12
    props = rc.ClusterProperties(
        num_brokers=num_brokers,
        num_racks=4,
        num_topics=int(rng.integers(18, 28)),
        num_replicas=int(rng.integers(420, 500)),
        min_replication=3, max_replication=3,
        mean_cpu=0.02,
        num_disks=1,
        distribution=rc.Distribution.UNIFORM,
        seed=seed,
    )
    invariants = list(BASE_INVARIANTS)
    whatif_remove: List[List[int]] = []
    whatif_add: List[List[int]] = []
    events: List[StormEvent] = []

    if kind == "uniform_baseline":
        invariants.append("mesh_parity")
    elif kind == "exp_skew":
        props = dataclasses.replace(
            props, distribution=rc.Distribution.EXPONENTIAL)
        invariants.append("mesh_parity")
    elif kind == "hetero_racks":
        props = dataclasses.replace(
            props, rack_skew=float(1.0 + 2.0 * rng.random()),
            capacity_tiers=3)
    elif kind == "dead_brokers":
        dead = rng.choice(num_brokers, 2, replace=False)
        props = dataclasses.replace(
            props, dead_broker_ids=tuple(int(b) for b in sorted(dead)))
        invariants.append("stranded_cleared")
    elif kind == "dead_disks":
        props = dataclasses.replace(props, num_disks=3)
        bad = rng.choice(num_brokers, 2, replace=False)
        props = dataclasses.replace(
            props, dead_disk_ids=tuple(
                (int(b), int(rng.integers(0, 3))) for b in sorted(bad)))
        invariants.append("stranded_cleared")
    elif kind == "maintenance_window":
        target = int(rng.integers(0, num_brokers))
        events.append(StormEvent(kind="maintenance", plan="remove_broker",
                                 broker=target))
    elif kind == "broker_add":
        # The last brokers are provisioned-but-down expansion candidates;
        # each what-if lane revives a subset.
        cand = [num_brokers - 3, num_brokers - 2, num_brokers - 1]
        props = dataclasses.replace(props, dead_broker_ids=tuple(cand))
        whatif_add = [[cand[0]], [cand[1]], [cand[1], cand[2]]]
        invariants.append("chunked_parity")
    elif kind == "broker_remove":
        picks = rng.choice(num_brokers, 4, replace=False)
        whatif_remove = [[int(picks[0])], [int(picks[1])],
                         [int(picks[2]), int(picks[3])]]
        invariants.append("chunked_parity")

    return Scenario(
        name=f"{kind}-s{seed}", kind=kind, seed=seed, props=props,
        invariants=tuple(invariants), whatif_remove=whatif_remove,
        whatif_add=whatif_add, events=events,
    )


def shrink_steps(s: Scenario) -> Iterator[Tuple[str, Scenario]]:
    """Greedy-shrinker candidates, most-aggressive first: each yields a
    strictly simpler copy (fewer topics/replicas/racks, fewer faults,
    fewer events/lanes/goals).  The runner keeps any candidate that still
    fails and restarts from it."""
    p = s.props

    def with_props(label: str, **changes) -> Tuple[str, Scenario]:
        return label, dataclasses.replace(
            s, name=f"{s.name}~{label}",
            props=dataclasses.replace(p, **changes))

    if p.num_topics > 4:
        yield with_props("halve-topics", num_topics=max(4, p.num_topics // 2))
    if p.num_replicas > 60:
        yield with_props("halve-replicas",
                         num_replicas=max(60, p.num_replicas // 2))
    if p.num_racks > 2:
        yield with_props("halve-racks", num_racks=max(2, p.num_racks // 2))
    if p.rack_skew > 0.0:
        yield with_props("drop-rack-skew", rack_skew=0.0)
    if p.capacity_tiers > 1:
        yield with_props("drop-tiers", capacity_tiers=1)
    if p.distribution is not rc.Distribution.UNIFORM:
        yield with_props("uniform-dist",
                         distribution=rc.Distribution.UNIFORM)
    if p.dead_broker_ids:
        for i, b in enumerate(p.dead_broker_ids):
            rest = tuple(x for x in p.dead_broker_ids if x != b) or None
            yield with_props(f"drop-dead-broker-{b}", dead_broker_ids=rest)
    if p.dead_disk_ids:
        for b, k in p.dead_disk_ids:
            rest = tuple(x for x in p.dead_disk_ids if x != (b, k)) or None
            yield with_props(f"drop-dead-disk-{b}.{k}", dead_disk_ids=rest)
    for i in range(len(s.events)):
        ev = s.events[i]
        yield (f"drop-event-{i}-{ev.kind}", dataclasses.replace(
            s, name=f"{s.name}~drop-event-{i}",
            events=s.events[:i] + s.events[i + 1:]))
    for i in range(len(s.whatif_remove)):
        yield (f"drop-whatif-remove-{i}", dataclasses.replace(
            s, name=f"{s.name}~drop-whatif-remove-{i}",
            whatif_remove=s.whatif_remove[:i] + s.whatif_remove[i + 1:]))
    for i in range(len(s.whatif_add)):
        yield (f"drop-whatif-add-{i}", dataclasses.replace(
            s, name=f"{s.name}~drop-whatif-add-{i}",
            whatif_add=s.whatif_add[:i] + s.whatif_add[i + 1:]))
    if len(s.goal_names) > 2:
        yield ("drop-last-goal", dataclasses.replace(
            s, name=f"{s.name}~drop-last-goal",
            goal_names=s.goal_names[:-1]))
