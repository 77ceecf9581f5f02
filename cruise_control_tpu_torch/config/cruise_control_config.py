"""The framework's config surface (the JAX package's
``config/cruise_control_config.py``).

Reference: ``config/KafkaCruiseControlConfig.java`` over the per-subsystem
constants classes — ``AnalyzerConfig`` (611), ``MonitorConfig`` (559),
``ExecutorConfig`` (614), ``AnomalyDetectorConfig`` (417),
``WebServerConfig`` (495).  Key names match the reference property names so a
reference ``cruisecontrol.properties`` file parses directly; goal lists
accept fully-qualified Java class names (the registry strips packages).

Every key keeps the JAX package's name, type, default and validator, the
keys of its compile service and memory ledger included, so one properties
file parses the same in both packages, and the port reads every key.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.registry import (
    DEFAULT_ANOMALY_DETECTION_GOALS,
    DEFAULT_GOALS,
    DEFAULT_HARD_GOALS,
    DEFAULT_INTRA_BROKER_GOALS,
    SUPPORTED_GOALS,
)
from cruise_control_tpu_torch.common.exceptions import ConfigError
from cruise_control_tpu_torch.config.config_def import (
    ConfigDef,
    ConfigType,
    in_validator,
    load_properties,
    range_validator,
)
from cruise_control_tpu_torch.executor.executor import ExecutorConfig


def _analyzer_def() -> ConfigDef:
    d = ConfigDef()
    d.define("default.goals", ConfigType.LIST, ",".join(DEFAULT_GOALS),
             doc="goal priority list used when a request names no goals")
    d.define("goals", ConfigType.LIST, ",".join(SUPPORTED_GOALS),
             doc="all goals the instance supports")
    d.define("hard.goals", ConfigType.LIST, ",".join(DEFAULT_HARD_GOALS))
    d.define("intra.broker.goals", ConfigType.LIST,
             ",".join(DEFAULT_INTRA_BROKER_GOALS))
    d.define("cpu.balance.threshold", ConfigType.DOUBLE, 1.1,
             range_validator(1.0))
    d.define("network.inbound.balance.threshold", ConfigType.DOUBLE, 1.1,
             range_validator(1.0))
    d.define("network.outbound.balance.threshold", ConfigType.DOUBLE, 1.1,
             range_validator(1.0))
    d.define("disk.balance.threshold", ConfigType.DOUBLE, 1.1, range_validator(1.0))
    d.define("cpu.capacity.threshold", ConfigType.DOUBLE, 0.7,
             range_validator(0.0, 1.0))
    d.define("network.inbound.capacity.threshold", ConfigType.DOUBLE, 0.8,
             range_validator(0.0, 1.0))
    d.define("network.outbound.capacity.threshold", ConfigType.DOUBLE, 0.8,
             range_validator(0.0, 1.0))
    d.define("disk.capacity.threshold", ConfigType.DOUBLE, 0.8,
             range_validator(0.0, 1.0))
    d.define("cpu.low.utilization.threshold", ConfigType.DOUBLE, 0.0)
    d.define("network.inbound.low.utilization.threshold", ConfigType.DOUBLE, 0.0)
    d.define("network.outbound.low.utilization.threshold", ConfigType.DOUBLE, 0.0)
    d.define("disk.low.utilization.threshold", ConfigType.DOUBLE, 0.0)
    d.define("max.replicas.per.broker", ConfigType.LONG, 10_000,
             range_validator(1))
    d.define("replica.count.balance.threshold", ConfigType.DOUBLE, 1.1)
    d.define("leader.replica.count.balance.threshold", ConfigType.DOUBLE, 1.1)
    d.define("topic.replica.count.balance.threshold", ConfigType.DOUBLE, 3.0)
    d.define("topic.names.with.min.leaders.per.broker", ConfigType.LIST, "")
    d.define("min.topic.leaders.per.broker", ConfigType.INT, 1)
    # Also the background-precompute cadence (GoalOptimizer.java:107-135):
    # the facade's precompute daemon refreshes the generation-keyed proposal
    # cache at this interval.
    d.define("proposal.expiration.ms", ConfigType.LONG, 60_000)
    d.define("goal.violation.distribution.threshold.multiplier",
             ConfigType.DOUBLE, 1.0)
    d.define("num.proposal.precompute.threads", ConfigType.INT, 1,
             doc="accepted for reference compatibility; the batched solver "
                 "precomputes with one daemon (a solve is one device "
                 "dispatch, so a thread pool adds nothing)")
    return d


def _monitor_def() -> ConfigDef:
    d = ConfigDef()
    d.define("num.partition.metrics.windows", ConfigType.INT, 5)
    d.define("partition.metrics.window.ms", ConfigType.LONG, 300_000)
    d.define("num.broker.metrics.windows", ConfigType.INT, 20)
    d.define("broker.metrics.window.ms", ConfigType.LONG, 300_000)
    d.define("min.samples.per.partition.metrics.window", ConfigType.INT, 1)
    d.define("metric.sampling.interval.ms", ConfigType.LONG, 120_000)
    d.define("monitor.state.update.interval.ms", ConfigType.LONG, 30_000,
             doc="accepted for reference compatibility; monitor state here "
                 "is computed on read (with a short-lived cache), not on a "
                 "refresh timer")
    d.define("broker.capacity.config.resolver.class", ConfigType.CLASS, "")
    d.define("capacity.config.file", ConfigType.STRING, "")
    d.define("sample.store.class", ConfigType.CLASS, "")
    d.define("sample.store.dir", ConfigType.STRING, "")
    d.define("metric.sampler.class", ConfigType.CLASS, "")
    # "synthetic" (default) | "reporter" (metrics-reporter pipeline through
    # the transport) | "prometheus" — demo-mode sampler selection.
    d.define("metric.sampler.mode", ConfigType.STRING, "synthetic")
    # Network face of the metrics bus (the role the Kafka listener plays for
    # __CruiseControlMetrics): 0 disables; any other port serves the
    # reporter-mode transport over TCP so external broker agents can publish
    # with reporter.SocketTransport.
    d.define("metrics.transport.listen.port", ConfigType.INT, 0,
             doc="TCP port serving the metrics-bus transport; 0 = in-process "
                 "only.  Requires metric.sampler.mode=reporter (and no "
                 "metric.sampler.class override) — otherwise the port is "
                 "ignored with a warning")
    d.define("metrics.transport.listen.address", ConfigType.STRING, "127.0.0.1",
             doc="bind address for the metrics-bus listener.  Binding beyond "
                 "loopback (0.0.0.0 for remote broker agents) should set "
                 "metrics.transport.auth.secret.file (and ideally TLS) — a "
                 "plaintext unauthenticated bus lets anyone who can reach "
                 "the port forge metrics or read workload data")
    d.define("metrics.transport.auth.secret.file", ConfigType.STRING, "",
             doc="file holding the shared secret every bus peer must present "
                 "as its first frame ({'op':'auth','token':...}); empty = "
                 "unauthenticated (loopback/demo only).  Reporter agents "
                 "pass the same secret to reporter.SocketTransport")
    d.define("metrics.transport.ssl.certfile", ConfigType.STRING, "",
             doc="PEM cert chain enabling TLS on the metrics-bus listener "
                 "(same config shape as webserver.ssl.*); empty = plaintext")
    d.define("metrics.transport.ssl.keyfile", ConfigType.STRING, "",
             doc="PEM private key for metrics.transport.ssl.certfile "
                 "(empty when the cert file bundles the key)")
    d.define("num.metric.fetchers", ConfigType.INT, 4)
    d.define("prometheus.server.endpoint", ConfigType.STRING, "")
    d.define("min.valid.partition.ratio", ConfigType.DOUBLE, 0.95,
             range_validator(0.0, 1.0))
    d.define("metadata.max.age.ms", ConfigType.LONG, 5_000)
    return d


def _executor_def() -> ConfigDef:
    d = ConfigDef()
    d.define("num.concurrent.partition.movements.per.broker", ConfigType.INT, 5)
    d.define("num.concurrent.intra.broker.partition.movements", ConfigType.INT, 2)
    d.define("num.concurrent.leader.movements", ConfigType.INT, 1000)
    d.define("max.num.cluster.movements", ConfigType.INT, 1250)
    d.define("execution.progress.check.interval.ms", ConfigType.LONG, 10_000)
    d.define("default.replication.throttle", ConfigType.LONG, None)
    d.define("task.execution.alerting.threshold.ms", ConfigType.LONG, 90_000)
    d.define("auto.adjust.concurrency", ConfigType.BOOLEAN, False)
    # Cluster-facing admin driver selection (the reference's executor always
    # speaks ZK/AdminClient; here the seam is the ClusterAdminBackend
    # protocol): a class override, or a host:port of a peer speaking the
    # admin protocol (broker_simulator --listen, or any real driver shim).
    d.define("executor.admin.backend.class", ConfigType.CLASS, "",
             doc="ClusterAdminBackend implementation; beats the address key")
    d.define("executor.admin.backend.address", ConfigType.STRING, "",
             doc="host:port of an admin-protocol peer (SocketClusterBackend);"
                 " empty = in-process fake (demo)")
    d.define("executor.admin.backend.auth.secret.file", ConfigType.STRING, "",
             doc="file holding the shared secret presented to the admin peer "
                 "as the connection's first frame (broker_simulator "
                 "--auth-token-file); empty = unauthenticated (demo only)")
    d.define("executor.admin.backend.ssl.enable", ConfigType.BOOLEAN, False,
             doc="wrap the admin connection in TLS; pair with the cafile key "
                 "to verify the peer (alone it encrypts without verifying)")
    d.define("executor.admin.backend.ssl.cafile", ConfigType.STRING, "",
             doc="PEM CA (typically the peer's self-signed cert) pinning the "
                 "admin peer's identity; implies ssl.enable")
    return d


def _anomaly_def() -> ConfigDef:
    d = ConfigDef()
    d.define("anomaly.detection.goals", ConfigType.LIST,
             ",".join(DEFAULT_ANOMALY_DETECTION_GOALS))
    d.define("anomaly.detection.interval.ms", ConfigType.LONG, 300_000)
    d.define("self.healing.enabled", ConfigType.BOOLEAN, False)
    d.define("broker.failure.alert.threshold.ms", ConfigType.LONG, 900_000)
    d.define("broker.failure.self.healing.threshold.ms", ConfigType.LONG, 1_800_000)
    d.define("anomaly.notifier.class", ConfigType.CLASS, "")
    # Webhook alerting (SlackSelfHealingNotifier analog): set a URL to route
    # anomaly alerts to a JSON webhook (Slack/Teams/generic receiver).
    d.define("anomaly.notifier.webhook.url", ConfigType.STRING, "")
    d.define("anomaly.notifier.webhook.channel", ConfigType.STRING, "")
    d.define("topic.anomaly.target.replication.factor", ConfigType.INT, None)
    # Maintenance-plan stream (MaintenanceEventTopicReader analog): plans
    # arrive over a partitioned-log Transport instead of in-process submit().
    # Exactly one of address (TCP TransportServer peer) or dir (FileTransport
    # directory) enables the reader.
    d.define("maintenance.event.transport.address", ConfigType.STRING, "",
             doc="host:port of a TransportServer carrying maintenance plans "
                 "(reporter.SocketTransport consumer); empty = disabled")
    d.define("maintenance.event.transport.dir", ConfigType.STRING, "",
             doc="FileTransport directory carrying maintenance plans; "
                 "empty = disabled.  Ignored when the address key is set")
    d.define("maintenance.event.transport.auth.secret.file", ConfigType.STRING,
             "",
             doc="file holding the shared secret presented to the maintenance "
                 "bus (required when the TransportServer it points at is "
                 "secured); empty = unauthenticated")
    d.define("maintenance.event.transport.ssl.enable", ConfigType.BOOLEAN,
             False,
             doc="wrap the maintenance bus connection in TLS; pair with the "
                 "cafile key to verify the peer")
    d.define("maintenance.event.transport.ssl.cafile", ConfigType.STRING, "",
             doc="PEM CA pinning the maintenance bus peer's identity; "
                 "implies ssl.enable")
    d.define("maintenance.plan.expiration.ms", ConfigType.LONG, 900_000,
             doc="validity period of a maintenance plan; older plans read "
                 "from the stream are discarded "
                 "(MaintenanceEventTopicReader.java expiration semantics)")
    d.define("maintenance.event.offsets.path", ConfigType.STRING, "",
             doc="JSON file persisting the reader's committed offsets "
                 "(restart resumes instead of replaying); empty = "
                 "<transport.dir>/consumer-offsets.json when dir mode, else "
                 "uncommitted")
    d.define("anomaly.model.min.valid.partition.ratio", ConfigType.DOUBLE,
             0.0, range_validator(0.0, 1.0),
             doc="staleness gate: self-healing fixes are IGNORED (audit "
                 "reason stale_model) while the current model fingerprint's "
                 "valid-partition ratio is below this; 0.0 disables the "
                 "ratio check")
    d.define("anomaly.model.max.age.ms", ConfigType.LONG, 0,
             range_validator(0),
             doc="staleness gate: self-healing fixes are IGNORED (audit "
                 "reason stale_model) while the current model fingerprint's "
                 "newest valid window is older than this; 0 disables the "
                 "age check")
    return d


def _compile_def() -> ConfigDef:
    """compilesvc keys (no reference analog — the reference JVM has no device
    code to manage)."""
    d = ConfigDef()
    d.define("compile.warmup.enabled", ConfigType.BOOLEAN, True,
             doc="start the background warmup daemon on facade start_up; it "
                 "runs real dryrun solves at the canonical shape buckets so "
                 "the first operator request starts warm")
    d.define("compile.warmup.lanes", ConfigType.LIST, "4",
             doc="what-if lane-width LADDER the warmup daemon runs (comma "
                 "list, e.g. \"4,16\"); every width gets its own warm task so "
                 "chunked wide batches find each block width warm")
    d.define("compile.lane.chunking.enabled", ConfigType.BOOLEAN, True,
             doc="route wide what-if batches through lane widths already "
                 "run (e.g. 64 lanes as 4x16 blocks) instead of one "
                 "full-width block")
    d.define("compile.max.lane.bucket", ConfigType.INT, 16, range_validator(1),
             doc="widest fresh lane block; wider batches are chunked "
                 "through this width (must be on the lane ladder)")
    d.define("compile.replica.pad.floor", ConfigType.INT, 64,
             range_validator(1),
             doc="smallest replica-axis shape bucket (geometric growth above)")
    d.define("compile.broker.pad.floor", ConfigType.INT, 8, range_validator(1),
             doc="smallest broker-axis shape bucket")
    d.define("compile.bucket.growth", ConfigType.DOUBLE, 2.0,
             range_validator(1.001),
             doc="geometric growth factor between consecutive shape buckets")
    d.define("compile.persistent.cache.enabled", ConfigType.BOOLEAN, False,
             doc="build and load the aggregate kernel's library under "
                 "versioned keys (torch and CUDA versions, machine "
                 "fingerprint, goal stack, bucket) so restarts skip nvcc.  "
                 "Default off (the library is then built in ops/_build/); "
                 "nothing is compiled for the CPU, where it stays off")
    d.define("compile.persistent.cache.path", ConfigType.STRING, "",
             doc="cache root; empty = ~/.cache/cruise_control_tpu_torch/"
                 "compile_cache")
    d.define("compile.persistent.cache.max.bytes", ConfigType.LONG,
             4 * 1024 * 1024 * 1024, range_validator(1),
             doc="per-entry-directory size cap; oldest libraries evicted "
                 "first")
    d.define("compile.persistent.cache.cpu.probe", ConfigType.BOOLEAN, True,
             doc="the JAX package's XLA:CPU loader probe; the port compiles "
                 "nothing for the CPU, so it reads no probe and a CPU "
                 "activation stays off either way")
    return d


def _model_def() -> ConfigDef:
    """Resident-model keys (no reference analog — the reference JVM rebuilds
    its ClusterModel object graph per request; this port keeps the frozen
    tensors on-device and scatter-applies monitor deltas)."""
    d = ConfigDef()
    d.define("model.resident.enabled", ConfigType.BOOLEAN, True,
             doc="keep the frozen (state, placement) tensors device-resident "
                 "across requests and apply LoadMonitor changes as sparse "
                 "scatter deltas; disable to re-freeze the full model every "
                 "request (the pre-resident behavior)")
    d.define("model.resident.max.delta.slots", ConfigType.INT, 8192,
             range_validator(1),
             doc="largest touched-row count a delta may carry; bigger edits "
                 "fall back to a full freeze")
    d.define("model.resident.max.delta.chain", ConfigType.INT, 512,
             range_validator(1),
             doc="consecutive delta applies allowed since the last full "
                 "freeze; the next snapshot past this re-freezes (bounds "
                 "numeric drift and caps replay length)")
    return d


def _trace_def() -> ConfigDef:
    """obsvc keys (no reference analog — the reference JVM leans on flat
    Dropwizard sensors; span tracing is this port's solve-time instrument)."""
    d = ConfigDef()
    d.define("trace.enabled", ConfigType.BOOLEAN, False,
             doc="propagate a span tree through every HTTP request, "
                 "precompute tick and executor batch (GET /trace); adds "
                 "block_until_ready fences around solver dispatches, so "
                 "leave off unless attributing time")
    d.define("trace.ring.size", ConfigType.INT, 32, range_validator(1),
             doc="how many recent root traces GET /trace retains")
    d.define("trace.audit.log.size", ConfigType.INT, 256, range_validator(1),
             doc="bounded length of the self-healing audit log surfaced in "
                 "the AnomalyDetectorState substate of GET /state")
    d.define("trace.profile.dir", ConfigType.STRING, "",
             doc="root directory for POST /profile captures, one "
                 "profile-<epoch_ms>/trace.json Chrome trace (torch.profiler) "
                 "each; empty = <tmpdir>/cruise_control_tpu_torch_profiles")
    d.define("trace.solver.rounds", ConfigType.BOOLEAN, False,
             doc="record per-round solver convergence curves (applied moves, "
                 "violated/stranded counts, goal metric, resync/stall flags) "
                 "in a preallocated device buffer, one row a round, copied "
                 "to the host once at each goal's end and surfaced via GET "
                 "/solver_stats.  Off, the solve does no recording work")
    d.define("trace.solver.ring.size", ConfigType.INT, 64, range_validator(1),
             doc="bounded flight-recorder ring of recent per-solve "
                 "convergence records kept for GET /solver_stats")
    d.define("obs.history.enabled", ConfigType.BOOLEAN, True,
             doc="run the sensor-history sampler thread: periodic "
                 "MetricRegistry snapshots into bounded per-sensor "
                 "time-series rings (GET /metrics/history)")
    d.define("obs.history.interval.ms", ConfigType.LONG, 10_000,
             range_validator(100),
             doc="sampling cadence of the sensor-history recorder")
    d.define("obs.history.ring.size", ConfigType.INT, 360, range_validator(1),
             doc="samples retained per sensor (360 x 10 s default = 1 h)")
    d.define("slo.enabled", ConfigType.BOOLEAN, False,
             doc="evaluate the latency/solve objectives below over the "
                 "sensor-history rings and emit SloViolationAnomaly through "
                 "the detector -> notifier -> audit path")
    d.define("slo.endpoint.latency.p99.ms", ConfigType.DOUBLE, 5_000.0,
             range_validator(0.001),
             doc="per-endpoint objective: p99 of each servlet endpoint's "
                 "successful-request-execution-timer must stay below this")
    d.define("slo.solve.rounds.max", ConfigType.INT, 96, range_validator(1),
             doc="per-solve objective: a goal's convergence rounds must stay "
                 "below this (hitting the solver's own round cap means the "
                 "loop never converged)")
    d.define("slo.solve.time.ms", ConfigType.DOUBLE, 30_000.0,
             range_validator(0.001),
             doc="per-solve objective: p99 of the proposal-computation timer")
    d.define("slo.error.budget", ConfigType.DOUBLE, 0.1,
             range_validator(0.0001, 1.0),
             doc="fraction of history samples allowed to breach an objective "
                 "before the burn rate reads 1.0")
    d.define("slo.burn.window.short.s", ConfigType.DOUBLE, 300.0,
             range_validator(1.0),
             doc="short burn-rate window (both windows must burn to alert)")
    d.define("slo.burn.window.long.s", ConfigType.DOUBLE, 3_600.0,
             range_validator(1.0), doc="long burn-rate window")
    d.define("slo.burn.rate.threshold", ConfigType.DOUBLE, 1.0,
             range_validator(0.0001),
             doc="burn rate (violating fraction / error budget) at or above "
                 "which a window counts as burning")
    d.define("slo.memory.utilization.max", ConfigType.DOUBLE, 0.9,
             range_validator(0.0001, 1.0),
             doc="memory-headroom objective: the device-buffer ledger's "
                 "tracked utilization (Memory.device-utilization, live bytes "
                 "/ device budget) must stay below this fraction")
    d.define("slo.execution.seconds.per.move.max", ConfigType.DOUBLE, 60.0,
             range_validator(0.001),
             doc="execution-throughput objective: the executor flight "
                 "recorder's EWMA seconds-per-move "
                 "(Executor.seconds-per-move) must stay below this; the "
                 "gauge reads 0.0 between batches so idle never burns")
    d.define("execution.observatory.enabled", ConfigType.BOOLEAN, True,
             doc="run the execution flight recorder: move provenance "
                 "threaded from the optimizer into executor tasks and the "
                 "journal, per-broker inflight accounting, EWMA "
                 "move-completion throughput and batch ETA "
                 "(GET /execution_progress, Executor.* throughput sensors). "
                 "Host-side only: the solve is the same with the "
                 "observatory off")
    d.define("execution.history.ring.size", ConfigType.INT, 64,
             range_validator(1),
             doc="bounded ring of recent execution-batch summaries the "
                 "flight recorder retains for /execution_progress")
    d.define("execution.throughput.ewma.alpha", ConfigType.DOUBLE, 0.3,
             range_validator(0.0001, 1.0),
             doc="EWMA smoothing factor for the seconds-per-move estimator "
                 "(higher = reacts faster to the latest completion)")
    d.define("monitor.fidelity.enabled", ConfigType.BOOLEAN, True,
             doc="run the model-fidelity observatory: a ModelFingerprint "
                 "(generation, window age, valid-partition ratio, "
                 "extrapolated fraction by kind, dead brokers) recorded at "
                 "every model freeze / resident delta-apply and stamped "
                 "onto optimizer results and proposals, plus the ingest "
                 "telemetry ring behind GET /model_quality.  Host-side "
                 "only: the solve is the same with the observatory off")
    d.define("monitor.fidelity.ring.size", ConfigType.INT, 64,
             range_validator(1),
             doc="bounded rings of recent fingerprints, window-close "
                 "quality entries and liveness flaps the fidelity recorder "
                 "retains for /model_quality")
    d.define("slo.model.age.max.ms", ConfigType.DOUBLE, 1_800_000.0,
             range_validator(0.001),
             doc="model-freshness objective: the current fingerprint's age "
                 "(Monitor.fingerprint-age-ms, now minus its newest valid "
                 "window's end) must stay below this; the gauge reads 0.0 "
                 "before the first fingerprint so cold boot never burns")
    d.define("slo.model.valid.partition.ratio.min", ConfigType.DOUBLE, 0.8,
             range_validator(0.0001, 1.0),
             doc="model-validity objective: the fingerprint's valid-"
                 "partition ratio must stay at or above this (evaluated on "
                 "the inverted Monitor.invalid-partition-ratio gauge, which "
                 "reads 0.0 before the first fingerprint, so 'bad' is "
                 "above threshold and idle never burns)")
    return d


def _memory_def() -> ConfigDef:
    """Device-memory observatory keys (no reference analog — the reference
    JVM delegates memory pressure to the garbage collector; on an
    accelerator, HBM occupancy is a first-class scheduling input)."""
    d = ConfigDef()
    d.define("memory.enabled", ConfigType.BOOLEAN, True,
             doc="run the device-buffer ledger (per-subsystem live-bytes "
                 "accounting, GET /memory, Memory.* sensors) and the "
                 "per-family cost ledger.  Host-side only: the same device "
                 "work runs with the ledger on or off")
    d.define("memory.headroom.fraction", ConfigType.DOUBLE, 0.9,
             range_validator(0.0001, 1.0),
             doc="lane-dispatch guard ceiling: a what-if batch whose "
                 "projected peak bytes exceed this fraction of the device "
                 "budget is re-chunked onto narrower lane widths, or refused "
                 "(degraded-style tagging) when no ladder width fits")
    d.define("memory.device.budget.bytes", ConfigType.LONG, 0,
             range_validator(0),
             doc="device memory budget the headroom guard divides by; "
                 "0 = the card's total memory (torch.cuda.mem_get_info); the "
                 "CPU reports none, leaving the guard inert unless this "
                 "override is set")
    d.define("memory.analysis.mode", ConfigType.STRING, "lowered",
             in_validator("off", "lowered", "full"),
             doc="cost-row depth on each family's first run at a bucket: "
                 "'off' disables rows; 'lowered' (default) records argument "
                 "and output bytes; 'full' also brackets that run on the card "
                 "with torch.cuda's peak-memory counters for temporary bytes "
                 "and the peak")
    return d


def _fuzz_def() -> ConfigDef:
    """fuzzsvc keys (no reference analog — the reference's randomized
    OptimizationVerifier corpora live in its JUnit parameters; here the
    fuzz campaign is an operable service entrypoint)."""
    d = ConfigDef()
    d.define("fuzz.num.scenarios", ConfigType.INT, 8, range_validator(1),
             doc="scenarios per campaign (seeds fuzz.seed.base..+N-1)")
    d.define("fuzz.seed.base", ConfigType.INT, 100,
             doc="first scenario seed; every failure replays from "
                 "(seed, kind) alone")
    d.define("fuzz.scenario.budget.s", ConfigType.DOUBLE, 120.0,
             range_validator(0.001),
             doc="per-scenario soft wall-clock budget; overruns are "
                 "reported, not killed (a stuck solve IS a finding)")
    d.define("fuzz.corpus.dir", ConfigType.STRING, ".fuzz-corpus",
             doc="failing scenarios (and their shrunk .min forms) are "
                 "saved here as replayable JSON")
    d.define("fuzz.storm.cycles", ConfigType.INT, 1, range_validator(0),
             doc="chaos-storm inject→detect→heal cycles per scenario; "
                 "0 disables the storm")
    d.define("fuzz.shrink.max.steps", ConfigType.INT, 8, range_validator(0),
             doc="greedy-shrinker descent bound on a failing scenario")
    return d


def _resilience_def() -> ConfigDef:
    """resilience keys (retry budgets, admin-backend circuit breaker, crash
    journal, /health).  No single reference analog — the reference leans on
    the JVM AdminClient's internal retries; here the transport is ours, so
    the failure policy is operator-visible config."""
    d = ConfigDef()
    d.define("resilience.retry.max.attempts", ConfigType.INT, 4,
             range_validator(1),
             doc="attempts per admin-backend call before the retry budget "
                 "is exhausted")
    d.define("resilience.retry.base.delay.ms", ConfigType.LONG, 100,
             range_validator(1),
             doc="first-retry backoff; later retries multiply by 2 with "
                 "±50% jitter")
    d.define("resilience.retry.max.delay.ms", ConfigType.LONG, 5_000,
             range_validator(1), doc="backoff ceiling per sleep")
    d.define("resilience.retry.deadline.ms", ConfigType.LONG, 30_000,
             range_validator(1),
             doc="wall-clock budget across all attempts of one logical call")
    d.define("resilience.circuit.failure.threshold", ConfigType.INT, 5,
             range_validator(1),
             doc="consecutive backend failures that open the circuit")
    d.define("resilience.circuit.reset.timeout.ms", ConfigType.LONG, 10_000,
             range_validator(1),
             doc="open-circuit hold before a half-open probe is allowed")
    d.define("resilience.backend.reconnect.enabled", ConfigType.BOOLEAN, True,
             doc="wrap the socket admin backend in the reconnecting/"
                 "circuit-breaking transport")
    d.define("resilience.journal.path", ConfigType.STRING, "",
             doc="crash-safe execution journal file; empty disables "
                 "journaling (and startup reconciliation)")
    d.define("resilience.journal.adoption.timeout.ms", ConfigType.LONG,
             30_000, range_validator(1),
             doc="startup budget for waiting on re-adopted in-flight "
                 "reassignments before declaring them still-in-flight")
    d.define("resilience.health.retry.after.s", ConfigType.INT, 30,
             range_validator(1),
             doc="Retry-After header value on 503s while unhealthy")
    return d


def _solver_def() -> ConfigDef:
    """Deadline / preemption keys (no reference analog — the reference JVM
    can interrupt its proposal thread; here preemption is a budget the
    solver checks at goal and segment boundaries)."""
    d = ConfigDef()
    d.define("solver.default.deadline.ms", ConfigType.LONG, None,
             doc="default wall-clock budget for every goal-based operation's "
                 "solve; on expiry the solve stops at its next segment "
                 "boundary and returns the best placement found so far, "
                 "tagged partial.  A request's ?deadline_ms= overrides it; "
                 "empty/0 = unbudgeted (the same results as a build without "
                 "deadlines)")
    d.define("solver.segment.rounds", ConfigType.INT, 8, range_validator(1),
             doc="convergence rounds per segmented-solve dispatch when a "
                 "deadline is set; smaller = tighter deadline adherence, "
                 "more budget checks.  Never affects budget-less solves")
    d.define("solver.shutdown.grace.ms", ConfigType.LONG, 5_000,
             range_validator(0),
             doc="facade.shutdown grace-drain: cancel in-flight solves and "
                 "wait up to this long for them to unwind through their "
                 "next segment boundary before tearing components down")
    d.define("slo.preempt.enabled", ConfigType.BOOLEAN, False,
             doc="escalate the solve-time SLO objective from emit-anomaly "
                 "to actively preempting the offending in-flight solve "
                 "(the anomaly becomes fixable and the fix cancels every "
                 "active solve budget with reason slo-preempt).  Requires "
                 "slo.enabled and self-healing for SLO_VIOLATION")
    d.define("solver.relaxation.enabled", ConfigType.BOOLEAN, False,
             doc="convex-relaxation fast path for relax-eligible "
                 "distribution goals (analyzer/relax.py): fractional "
                 "mirror-descent solve + transport-style rounding, with the "
                 "greedy kernel demoted to a warm-started integer repair "
                 "pass.  Ineligible goals — and everything when off — take "
                 "the greedy path bit-for-bit.  Budgeted/deadline solves "
                 "always stay on the greedy path")
    d.define("solver.relaxation.iterations", ConfigType.INT, 48,
             range_validator(1),
             doc="mirror-descent iterations for the fractional solve")
    d.define("solver.relaxation.candidates", ConfigType.INT, 4096,
             range_validator(1),
             doc="top-K movable replicas given fractional mass per goal "
                 "(clamped to the replica pad; compile-time tile width, "
                 "same role as the greedy candidate width)")
    d.define("solver.relaxation.waves", ConfigType.INT, 4, range_validator(1),
             doc="rounding waves: each wave commits at most one accepted "
                 "move per partition/src/dst/host group, vetoed "
                 "destinations retry their runner-up next wave")
    d.define("solver.relaxation.tolerance", ConfigType.DOUBLE, 0.05,
             range_validator(0),
             doc="relative soft-goal balancedness slack the relax+repair "
                 "result may trail pure greedy by before the fuzz "
                 "relaxation_sound invariant flags it")
    return d


def _webserver_def() -> ConfigDef:
    d = ConfigDef()
    d.define("webserver.http.port", ConfigType.INT, 9090)
    d.define("webserver.http.address", ConfigType.STRING, "127.0.0.1")
    d.define("webserver.api.urlprefix", ConfigType.STRING, "/kafkacruisecontrol/*")
    # Static frontend (reference WebServerConfig:81-90 + setupWebUi): empty
    # diskpath disables serving (the frontend bundle ships separately).
    d.define("webserver.ui.diskpath", ConfigType.STRING, "",
             doc="directory with the built web frontend; empty = no UI")
    d.define("webserver.ui.urlprefix", ConfigType.STRING, "/*",
             doc="URL path the frontend is served from")
    d.define("webserver.request.maxBlockTimeMs", ConfigType.LONG, 10_000,
             doc="accepted for reference compatibility; every mutating "
                 "request is async-202 from the start, so there is no "
                 "sync-to-async conversion timer")
    d.define("webserver.session.maxExpiryTimeMs", ConfigType.LONG, 21_600_000,
             doc="accepted for reference compatibility; task affinity rides "
                 "the User-Task-ID header, not servlet sessions")
    # Security (reference WebServerConfig.WEBSERVER_SECURITY_*):
    d.define("webserver.security.enable", ConfigType.BOOLEAN, False)
    # "basic" | "jwt" | "trusted_proxy"
    d.define("webserver.security.provider", ConfigType.STRING, "basic")
    d.define("webserver.auth.credentials.file", ConfigType.STRING, "")
    d.define("webserver.auth.jwt.secret", ConfigType.STRING, "")
    d.define("webserver.auth.trusted.proxy.ips", ConfigType.STRING, "")
    d.define("webserver.auth.trusted.proxy.user.header", ConfigType.STRING,
             "X-Forwarded-User")
    # SPNEGO (reference servlet/security/spnego/*): the GSS ticket validator
    # is a plugin — Kerberos libraries are deployment-specific.
    d.define("webserver.auth.spnego.validator.class", ConfigType.CLASS, None,
             doc="callable/class returning the authenticated principal for a "
                 "GSS token; replaces the reference's JAAS+keytab wiring "
                 "(spnego.keytab.file / spnego.principal)")
    # TLS listener (reference WebServerConfig WEBSERVER_SSL_* +
    # KafkaCruiseControlApp.java:100-120).  INTENTIONAL DEVIATION: the
    # reference configures a JKS/PKCS12 keystore (webserver.ssl.keystore.
    # location/.password/.type, webserver.ssl.key.password); Python's ssl
    # module loads PEM, so the keys here name a PEM chain + key instead.
    # main.py points reference-keystore users at the rename.
    d.define("webserver.ssl.enable", ConfigType.BOOLEAN, False)
    d.define("webserver.ssl.certfile", ConfigType.STRING, "",
             doc="PEM cert chain; replaces the reference's "
                 "`webserver.ssl.keystore.location` (JKS/PKCS12 keystores "
                 "are JVM-specific — export to PEM)")
    d.define("webserver.ssl.keyfile", ConfigType.STRING, "",
             doc="PEM private key (reference: inside the keystore)")
    d.define("webserver.ssl.keyfile.password", ConfigType.STRING, "",
             doc="replaces the reference's `webserver.ssl.key.password`")
    d.define("max.active.user.tasks", ConfigType.INT, 25)
    d.define("completed.user.task.retention.time.ms", ConfigType.LONG, 86_400_000)
    d.define("two.step.verification.enabled", ConfigType.BOOLEAN, False)
    d.define("servlet.user.task.timeout.ms", ConfigType.LONG, None,
             doc="wall-clock cap on async 202 user tasks: past it the "
                 "task's cancellation token fires (reason timeout), the "
                 "solve stops at its next budget checkpoint, and the task "
                 "lands in the TIMED_OUT terminal state in /user_tasks; "
                 "empty/0 = unbounded (pre-cap behavior)")
    return d


def _port_def() -> ConfigDef:
    d = (_analyzer_def().merge(_monitor_def())
         .merge(_executor_def()).merge(_anomaly_def())
         .merge(_compile_def()).merge(_model_def())
         .merge(_trace_def()).merge(_memory_def())
         .merge(_fuzz_def()).merge(_resilience_def())
         .merge(_solver_def()).merge(_webserver_def()))
    return d


class CruiseControlConfig:
    """Parsed config over the merged per-subsystem definitions."""

    def __init__(self, props: Optional[Dict[str, Any]] = None):
        self.definition = _port_def()
        props = dict(props or {})
        known = self.definition.keys()
        self.originals = props
        self.values = self.definition.parse(
            {k: v for k, v in props.items() if k in known})
        self._validate_goal_names()

    @classmethod
    def from_properties_file(cls, path: str) -> "CruiseControlConfig":
        return cls(load_properties(path))

    def _validate_goal_names(self) -> None:
        from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name
        for key in ("default.goals", "goals", "hard.goals",
                    "anomaly.detection.goals", "intra.broker.goals"):
            for name in self.values.get(key) or []:
                try:
                    goal_by_name(name)
                except ValueError as e:
                    raise ConfigError(f"{key}: {e}") from None

    def __getitem__(self, key: str) -> Any:
        return self.values[key]

    def get(self, key: str, default=None) -> Any:
        return self.values.get(key, default)

    # ----------------------------------------------------- derived objects

    def goal_names(self, key: str = "default.goals") -> List[str]:
        return [g.rsplit(".", 1)[-1] for g in self.values[key]]

    def balancing_constraint(self) -> BalancingConstraint:
        v = self.values
        return BalancingConstraint(
            balance_threshold=np.array(
                [v["cpu.balance.threshold"],
                 v["network.inbound.balance.threshold"],
                 v["network.outbound.balance.threshold"],
                 v["disk.balance.threshold"]], dtype=np.float32),
            capacity_threshold=np.array(
                [v["cpu.capacity.threshold"],
                 v["network.inbound.capacity.threshold"],
                 v["network.outbound.capacity.threshold"],
                 v["disk.capacity.threshold"]], dtype=np.float32),
            low_utilization_threshold=np.array(
                [v["cpu.low.utilization.threshold"],
                 v["network.inbound.low.utilization.threshold"],
                 v["network.outbound.low.utilization.threshold"],
                 v["disk.low.utilization.threshold"]], dtype=np.float32),
            max_replicas_per_broker=int(v["max.replicas.per.broker"]),
            replica_balance_threshold=v["replica.count.balance.threshold"],
            leader_replica_balance_threshold=
                v["leader.replica.count.balance.threshold"],
            topic_replica_balance_threshold=
                v["topic.replica.count.balance.threshold"],
            min_topic_leaders_per_broker=v["min.topic.leaders.per.broker"],
            min_leader_topic_names=tuple(
                v["topic.names.with.min.leaders.per.broker"] or ()),
            goal_violation_distribution_threshold_multiplier=
                v["goal.violation.distribution.threshold.multiplier"],
        )

    def executor_config(self) -> ExecutorConfig:
        v = self.values
        return ExecutorConfig(
            concurrent_partition_movements_per_broker=
                v["num.concurrent.partition.movements.per.broker"],
            concurrent_intra_broker_partition_movements=
                v["num.concurrent.intra.broker.partition.movements"],
            concurrent_leader_movements=v["num.concurrent.leader.movements"],
            max_num_cluster_movements=v["max.num.cluster.movements"],
            progress_check_interval_s=
                v["execution.progress.check.interval.ms"] / 1000.0,
            replication_throttle_bytes_per_s=v["default.replication.throttle"],
            task_execution_alert_timeout_s=
                v["task.execution.alerting.threshold.ms"] / 1000.0,
            auto_adjust_concurrency=v["auto.adjust.concurrency"],
        )
