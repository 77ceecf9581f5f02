"""Fuzz campaign runner: corpus management, budgets, shrinking, replay (the
JAX package's ``fuzzsvc/runner.py``, on the port's modules).

``python -m cruise_control_tpu_torch.fuzzsvc`` drives seed-deterministic campaigns
on ``--device`` (``cuda`` by default):
each scenario runs its invariant set (and optionally a chaos storm); a
failure saves the scenario JSON into the corpus, greedily shrinks it to a
minimal still-failing form, and prints a one-line replay command.  The
``Fuzz.*`` counters land on the shared metrics registry so nightly soak
runs show up on ``/metrics`` like every other subsystem.
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from cruise_control_tpu_torch.analyzer.relax import RelaxationConfig
from cruise_control_tpu_torch.common.metrics import registry
from cruise_control_tpu_torch.fuzzsvc.invariants import (
    InvariantResult,
    Materialized,
    run_invariants,
)
from cruise_control_tpu_torch.fuzzsvc.scenario import (
    SCENARIO_KINDS,
    Scenario,
    generate_scenario,
    shrink_steps,
)
from cruise_control_tpu_torch.fuzzsvc.storm import StormReport, run_storm


def fuzz_sensors() -> dict:
    """Register (idempotently) and return the Fuzz.* counters.  Called from
    ``main.build_app`` too, so the sensors exist on ``/metrics`` from boot,
    as in the JAX package."""
    reg = registry()
    return {
        "scenarios": reg.counter("Fuzz.scenarios-run"),
        "failures": reg.counter("Fuzz.scenario-failures"),
        "invariant_failures": reg.counter("Fuzz.invariant-failures"),
        "storm_cycles": reg.counter("Fuzz.storm-cycles"),
        "shrink_steps": reg.counter("Fuzz.shrink-steps"),
    }


@dataclass
class FuzzConfig:
    num_scenarios: int = 8
    base_seed: int = 100
    budget_s: float = 120.0          # per-scenario soft budget (reported)
    corpus_dir: str = ".fuzz-corpus"
    storm_cycles: int = 1            # 0 disables the chaos storm
    shrink_max_steps: int = 8
    kinds: Sequence[str] = ()        # empty = every kind round-robin
    device: str = "cuda"
    # The relaxed solve relaxation_sound runs, and its tolerance.
    relaxation: RelaxationConfig = field(default_factory=RelaxationConfig)

    @classmethod
    def from_cc_config(cls, config) -> "FuzzConfig":
        def _get(key, default):
            try:
                v = config.get(key)
            except Exception:   # noqa: BLE001 — missing key -> default
                return default
            return default if v is None else v

        return cls(
            num_scenarios=int(_get("fuzz.num.scenarios", 8)),
            base_seed=int(_get("fuzz.seed.base", 100)),
            budget_s=float(_get("fuzz.scenario.budget.s", 120.0)),
            corpus_dir=str(_get("fuzz.corpus.dir", ".fuzz-corpus")),
            storm_cycles=int(_get("fuzz.storm.cycles", 1)),
            shrink_max_steps=int(_get("fuzz.shrink.max.steps", 8)),
            relaxation=RelaxationConfig(
                iterations=int(_get("solver.relaxation.iterations", 48)),
                candidates=int(_get("solver.relaxation.candidates", 4096)),
                waves=int(_get("solver.relaxation.waves", 4)),
                tolerance=float(_get("solver.relaxation.tolerance", 0.05))),
        )


@dataclass
class ScenarioOutcome:
    scenario: Scenario
    invariants: List[InvariantResult] = field(default_factory=list)
    storm: Optional[StormReport] = None
    elapsed_s: float = 0.0
    over_budget: bool = False

    @property
    def failures(self) -> List[str]:
        out = [str(r) for r in self.invariants if not r.ok]
        if self.storm is not None:
            out.extend(f"storm: {p}" for p in self.storm.problems)
        return out

    @property
    def ok(self) -> bool:
        return not self.failures


@dataclass
class FuzzReport:
    outcomes: List[ScenarioOutcome] = field(default_factory=list)
    replay_lines: List[str] = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return all(o.ok for o in self.outcomes)


def run_one(scenario: Scenario, storm_cycles: int = 1,
            budget_s: float = 0.0,
            which: Optional[Sequence[str]] = None,
            device="cuda",
            relaxation: Optional[RelaxationConfig] = None) -> ScenarioOutcome:
    """One scenario end to end on ``device``: materialize, invariants,
    optional storm."""
    sensors = fuzz_sensors()
    t0 = time.monotonic()
    out = ScenarioOutcome(scenario=scenario)
    try:
        m = Materialized(scenario, device=device,
                         relaxation=relaxation or RelaxationConfig())
        out.invariants = run_invariants(scenario, which=which, materialized=m)
    except Exception as exc:  # noqa: BLE001 — a crashing scenario is a finding
        out.invariants = [InvariantResult(
            "materialize", False, f"raised {type(exc).__name__}: {exc}")]
    if storm_cycles > 0:
        out.storm = run_storm(scenario, cycles=storm_cycles, device=device)
        sensors["storm_cycles"].inc(out.storm.cycles_run)
    out.elapsed_s = time.monotonic() - t0
    out.over_budget = bool(budget_s) and out.elapsed_s > budget_s
    sensors["scenarios"].inc()
    sensors["invariant_failures"].inc(
        sum(1 for r in out.invariants if not r.ok))
    if not out.ok:
        sensors["failures"].inc()
    return out


def shrink(scenario: Scenario, still_fails: Callable[[Scenario], bool],
           max_steps: int = 8) -> tuple:
    """Greedy descent: take the first candidate that still fails, restart
    from it; stop when no candidate fails or the step budget runs out."""
    sensors = fuzz_sensors()
    current, trail = scenario, []
    for _ in range(max_steps):
        for label, cand in shrink_steps(current):
            sensors["shrink_steps"].inc()
            if still_fails(cand):
                current, trail = cand, trail + [label]
                break
        else:
            break
    return current, trail


def _save_corpus(corpus_dir: str, scenario: Scenario,
                 suffix: str = "") -> str:
    d = Path(corpus_dir) / "failing"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{scenario.name}{suffix}.json"
    path.write_text(scenario.to_json())
    return str(path)


def run_fuzz(cfg: FuzzConfig, log=print) -> FuzzReport:
    report = FuzzReport()
    t0 = time.monotonic()
    kinds = list(cfg.kinds) or list(SCENARIO_KINDS)
    for i in range(cfg.num_scenarios):
        seed = cfg.base_seed + i
        scenario = generate_scenario(seed, kind=kinds[i % len(kinds)])
        out = run_one(scenario, storm_cycles=cfg.storm_cycles,
                      budget_s=cfg.budget_s, device=cfg.device,
                      relaxation=cfg.relaxation)
        report.outcomes.append(out)
        status = "ok" if out.ok else "FAIL"
        log(f"[fuzz] {scenario.name}: {status} ({out.elapsed_s:.1f}s"
            + (", over budget" if out.over_budget else "") + ")")
        if out.ok:
            continue
        for f in out.failures:
            log(f"[fuzz]   {f}")
        path = _save_corpus(cfg.corpus_dir, scenario)

        def still_fails(cand: Scenario) -> bool:
            # Invariants only during shrinking: the storm's wall-clock would
            # dominate the descent, and storm-only failures replay directly.
            return not run_one(cand, storm_cycles=0, device=cfg.device,
                               relaxation=cfg.relaxation).ok

        storm_only = all(r.ok for r in out.invariants)
        shrunk, trail = (scenario, []) if storm_only else shrink(
            scenario, still_fails, max_steps=cfg.shrink_max_steps)
        if trail:
            spath = _save_corpus(cfg.corpus_dir, shrunk, suffix=".min")
            log(f"[fuzz]   shrunk via {' > '.join(trail)} -> {spath}")
            report.replay_lines.append(shrunk.replay_command(spath, cfg.device))
        report.replay_lines.append(scenario.replay_command(path, cfg.device))
        report.replay_lines.append(scenario.replay_command(device=cfg.device))
    report.elapsed_s = time.monotonic() - t0
    for line in report.replay_lines:
        log(f"[fuzz] replay: {line}")
    log(f"[fuzz] {len(report.outcomes)} scenarios, "
        f"{sum(not o.ok for o in report.outcomes)} failing, "
        f"{report.elapsed_s:.1f}s")
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cruise_control_tpu_torch.fuzzsvc",
        description="Property-based scenario fuzzer + chaos storm suite.")
    ap.add_argument("--num", type=int, default=8,
                    help="number of scenarios (seeds base..base+num-1)")
    ap.add_argument("--base-seed", type=int, default=100)
    ap.add_argument("--seed", type=int, default=None,
                    help="run exactly one scenario from this seed")
    ap.add_argument("--kind", choices=SCENARIO_KINDS, default=None)
    ap.add_argument("--replay", metavar="JSON",
                    help="re-run a saved corpus scenario")
    ap.add_argument("--storm-cycles", type=int, default=1)
    ap.add_argument("--budget-s", type=float, default=120.0)
    ap.add_argument("--corpus-dir", default=".fuzz-corpus")
    ap.add_argument("--shrink-max-steps", type=int, default=8)
    ap.add_argument("--list-kinds", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where every solve runs: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.list_kinds:
        print("\n".join(SCENARIO_KINDS))
        return 0
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("--device cuda: no CUDA device is visible; pass --device cpu "
                  "to run every solve on the CPU", file=sys.stderr)
            return 2

    if args.replay or args.seed is not None:
        if args.replay:
            scenario = Scenario.from_json(Path(args.replay).read_text())
        else:
            scenario = generate_scenario(args.seed, kind=args.kind)
        out = run_one(scenario, storm_cycles=args.storm_cycles,
                      budget_s=args.budget_s, device=args.device)
        for r in out.invariants:
            print(f"[fuzz] {scenario.name} {r}")
        if out.storm is not None:
            for p in out.storm.problems:
                print(f"[fuzz] {scenario.name} storm: {p}")
        print(f"[fuzz] {scenario.name}: "
              + ("ok" if out.ok else "FAIL") + f" ({out.elapsed_s:.1f}s)")
        return 0 if out.ok else 1

    cfg = FuzzConfig(num_scenarios=args.num, base_seed=args.base_seed,
                     budget_s=args.budget_s, corpus_dir=args.corpus_dir,
                     storm_cycles=args.storm_cycles,
                     shrink_max_steps=args.shrink_max_steps,
                     kinds=(args.kind,) if args.kind else (),
                     device=args.device)
    report = run_fuzz(cfg)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
