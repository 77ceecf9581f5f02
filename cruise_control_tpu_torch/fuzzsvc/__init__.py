"""fuzzsvc: property-based scenario fuzzer + chaos rebalance suite (the JAX
package's ``fuzzsvc``, on the port's modules).

The scenario taxonomy, invariant list, replay workflow and corpus layout are
the JAX package's (its ``docs/FUZZING.md``); replays run
``python -m cruise_control_tpu_torch.fuzzsvc --device cpu|cuda``.
"""

from cruise_control_tpu_torch.fuzzsvc.invariants import (
    INVARIANTS,
    InvariantResult,
    Materialized,
    run_invariants,
)
from cruise_control_tpu_torch.fuzzsvc.runner import (
    FuzzConfig,
    FuzzReport,
    ScenarioOutcome,
    fuzz_sensors,
    main,
    run_fuzz,
    run_one,
    shrink,
)
from cruise_control_tpu_torch.fuzzsvc.scenario import (
    SCENARIO_KINDS,
    Scenario,
    StormEvent,
    generate_scenario,
    shrink_steps,
)
from cruise_control_tpu_torch.fuzzsvc.storm import (
    InProcessSimBackend,
    StormReport,
    audit_coherence,
    build_storm_stack,
    run_storm,
)

__all__ = [
    "INVARIANTS", "InvariantResult", "Materialized", "run_invariants",
    "FuzzConfig", "FuzzReport", "ScenarioOutcome", "fuzz_sensors", "main",
    "run_fuzz", "run_one", "shrink",
    "SCENARIO_KINDS", "Scenario", "StormEvent", "generate_scenario",
    "shrink_steps",
    "InProcessSimBackend", "StormReport", "audit_coherence",
    "build_storm_stack", "run_storm",
]
