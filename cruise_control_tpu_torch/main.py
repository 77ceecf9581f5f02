"""Application bootstrap (the JAX package's ``main.py``).

Reference: ``KafkaCruiseControlMain.java:26-41`` / ``KafkaCruiseControlApp``
— parse config, wire the component stack, start the HTTP server.  The
cluster-facing seams (metadata backend, metric sampler, admin backend) are
chosen by config; ``--demo`` wires the in-process fake cluster so the full
service runs standalone (the role of the reference's embedded-broker harness).

Every solve runs on ``--device`` (``cuda`` by default).  With ``cuda`` and no
visible card the process exits non-zero: it never carries on on the CPU.

``metric.sampler.mode`` picks the ingestion edge as in the JAX package:
``synthetic`` (the default), ``reporter`` (one reporter agent per broker
publishing over the metrics bus to the consuming sampler; with
``sample.store.dir`` the bus and the sample store are segment-file logs that
a restart replays) or ``prometheus``.  ``metrics.transport.listen.port``
serves the bus over TCP, and ``maintenance.event.transport.*`` feeds
maintenance plans to the detector.  ``compile.*`` installs the process-wide
compile service (warmup daemon, lane chunking, the persistent kernel-build
cache) and ``memory.*`` the memory ledger, before anything solves.  The
``Fuzz.*`` counters exist from boot, as in the JAX package.

    python -m cruise_control_tpu_torch.main --demo [--device cpu] [--port N]
        [--config cruisecontrol.properties]
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time
from typing import Optional, Tuple

import torch

from cruise_control_tpu_torch.common.exceptions import ConfigError
from cruise_control_tpu_torch.config.cruise_control_config import CruiseControlConfig
from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
from cruise_control_tpu_torch.executor.backend import FakeClusterBackend
from cruise_control_tpu_torch.executor.executor import Executor
from cruise_control_tpu_torch.facade import CruiseControl
from cruise_control_tpu_torch.monitor.capacity import BrokerCapacityConfigFileResolver
from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
from cruise_control_tpu_torch.monitor.metadata import (
    BrokerInfo,
    FakeMetadataBackend,
    MetadataClient,
    PartitionInfo,
)
from cruise_control_tpu_torch.monitor.sample_store import (
    FileSampleStore,
    LogSampleStore,
    NoopSampleStore,
)
from cruise_control_tpu_torch.monitor.sampler import SyntheticWorkloadSampler
from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner
from cruise_control_tpu_torch.servlet.server import CruiseControlApp

# The listening line's prefix (``main`` prints it once the server is up).
LISTENING = "cruise-control-tpu-torch listening on"
LOG = logging.getLogger(__name__)


def demo_metadata(num_brokers: int = 6, num_partitions: int = 48,
                  rf: int = 2) -> FakeMetadataBackend:
    brokers = [BrokerInfo(i, rack=str(i % 3), host=f"host{i}")
               for i in range(num_brokers)]
    parts = [PartitionInfo("demo-topic", p, leader=p % num_brokers,
                           replicas=tuple((p + i) % num_brokers for i in range(rf)),
                           in_sync=tuple((p + i) % num_brokers for i in range(rf)))
             for p in range(num_partitions)]
    return FakeMetadataBackend(brokers, parts)


def build_app(config: CruiseControlConfig, port: Optional[int] = None,
              device="cuda", metadata_backend: Optional[FakeMetadataBackend] = None,
              monitor: Optional[Tuple[LoadMonitor, LoadMonitorTaskRunner]] = None
              ) -> CruiseControlApp:
    """Wire the full stack against the in-process demo cluster (the role of
    the reference's embedded-broker harness); real deployments substitute
    the metadata/admin/sampler seams.  Every solve runs on ``device``.

    ``metadata_backend`` takes the demo cluster's place (``demo_metadata()``
    by default; reporter mode's agents read it too), and ``monitor``, a load
    monitor and its task runner that already read it, the monitor, sampler,
    sample store and metrics bus the config would build; every other part is
    wired from ``config`` as without them."""
    from cruise_control_tpu_torch import resilience
    from cruise_control_tpu_torch.compilesvc import configure as configure_compile
    from cruise_control_tpu_torch.config.config_def import get_configured_instance
    from cruise_control_tpu_torch.obsvc import configure as configure_obsvc

    # Install the process-wide compile service from compile.* keys before
    # anything can solve, and point the kernel's build at the persistent
    # cache's versioned entry for this toolchain (no-op unless
    # compile.persistent.cache.enabled, and off on the CPU).
    compile_svc = configure_compile(config)
    compile_svc.cache.activate(platform_name=torch.device(device).type)
    # Observability next: trace.* keys gate the span tracer, audit-log
    # bounds and profile dir before any request or daemon can create spans.
    configure_obsvc(config)
    res = resilience.configure(config)
    # Materialize the Fuzz.* counters at boot: fuzz campaigns share this
    # registry, and a scrape sees them before the first campaign.
    from cruise_control_tpu_torch.fuzzsvc.runner import fuzz_sensors
    fuzz_sensors()
    mode = config.get("metric.sampler.mode", "synthetic")
    sampler_cls = str(config.originals.get("metric.sampler.class", "") or "")
    store_cls = str(config.originals.get("sample.store.class", "") or "")
    store_dir = config.get("sample.store.dir")

    # Reflective plugin overrides (AbstractConfig.getConfiguredInstance):
    # an explicit *.class key is consulted first, so the mode-derived
    # default is never built just to be discarded.  A plugin whose
    # constructor declares a ``config`` parameter receives the full config.
    def _plugin(path, **kwargs):
        return get_configured_instance(path, config=config, **kwargs)

    backend = metadata_backend if metadata_backend is not None else demo_metadata()
    if monitor is not None:
        load_monitor, task_runner = monitor
    else:
        load_monitor, task_runner = _monitor(config, backend, _plugin, mode, sampler_cls,
                                            store_cls, store_dir)

    admin_cls = str(config.originals.get("executor.admin.backend.class", "") or "")
    admin_addr = config["executor.admin.backend.address"]
    if admin_cls:
        admin_backend = _plugin(admin_cls)
    elif admin_addr:
        admin_backend = _socket_admin_backend(config, admin_addr, res)
    else:
        admin_backend = FakeClusterBackend(backend)
    executor = Executor(admin_backend, config.executor_config())
    if res.journal_path:
        from cruise_control_tpu_torch.executor.journal import ExecutionJournal
        executor.set_journal(ExecutionJournal(res.journal_path))

    notifier_kwargs = dict(
        self_healing_enabled=config["self.healing.enabled"],
        broker_failure_alert_threshold_ms=config["broker.failure.alert.threshold.ms"],
        broker_failure_self_healing_threshold_ms=
            config["broker.failure.self.healing.threshold.ms"])
    notifier_cls = str(config.originals.get("anomaly.notifier.class", "") or "")
    webhook_url = config.get("anomaly.notifier.webhook.url")
    if notifier_cls:
        notifier = _plugin(notifier_cls, **notifier_kwargs)
    elif webhook_url:
        from cruise_control_tpu_torch.detector.notifier import WebhookSelfHealingNotifier
        notifier = WebhookSelfHealingNotifier(
            webhook_url, channel=config.get("anomaly.notifier.webhook.channel", ""),
            **notifier_kwargs)
    else:
        notifier = SelfHealingNotifier(**notifier_kwargs)
    slo_detector = None
    if bool(config.get("slo.enabled")):
        # Burn-rate SLO anomalies over the sensor history rings; the detector
        # registers under the anomaly manager like every other detector.
        from cruise_control_tpu_torch.obsvc.slo import (
            SloViolationDetector,
            evaluator_from_config,
        )
        slo_detector = SloViolationDetector(evaluator_from_config(config))
    from cruise_control_tpu_torch.model.resident import ResidentModelService
    resident = ResidentModelService(
        enabled=bool(config["model.resident.enabled"]),
        max_delta_slots=int(config["model.resident.max.delta.slots"]),
        max_delta_chain=int(config["model.resident.max.delta.chain"]),
        device=device)
    default_deadline = config.get("solver.default.deadline.ms")
    cc = CruiseControl(
        load_monitor, executor, task_runner=task_runner,
        resident_service=resident,
        constraint=config.balancing_constraint(),
        default_goals=config.goal_names("default.goals"),
        notifier=notifier,
        self_healing_goals=config.goal_names("anomaly.detection.goals"),
        anomaly_detection_interval_s=config["anomaly.detection.interval.ms"] / 1000.0,
        proposal_precompute_interval_s=config["proposal.expiration.ms"] / 1000.0,
        default_completeness=_default_completeness(config),
        topic_anomaly_target_rf=(
            int(config["topic.anomaly.target.replication.factor"])
            if config.originals.get("topic.anomaly.target.replication.factor")
            else None),
        slo_detector=slo_detector,
        default_deadline_ms=float(default_deadline) if default_deadline else None,
        shutdown_grace_ms=float(config["solver.shutdown.grace.ms"]),
        slo_preempt_enabled=bool(config.get("slo.preempt.enabled")),
        device=device)
    _configure_solver(cc, config)
    if config["maintenance.event.transport.address"] or \
            config["maintenance.event.transport.dir"]:
        cc.maintenance_reader = _maintenance_reader(config, cc)
    ssl_on = config["webserver.ssl.enable"]
    if ssl_on and not config["webserver.ssl.certfile"]:
        hint = ""
        if any(k.startswith("webserver.ssl.keystore") for k in config.originals):
            hint = (" (found reference-style webserver.ssl.keystore.* keys: "
                    "this port serves TLS from PEM files — export the "
                    "keystore to PEM and set webserver.ssl.certfile/"
                    "webserver.ssl.keyfile; see docs/CONFIGURATION.md)")
        raise ConfigError(
            "webserver.ssl.enable=true requires webserver.ssl.certfile — "
            "refusing to silently serve the control plane over plain HTTP"
            + hint)
    return CruiseControlApp(
        cc,
        host=config["webserver.http.address"],
        port=port if port is not None else config["webserver.http.port"],
        two_step_verification=config["two.step.verification.enabled"],
        max_active_user_tasks=config["max.active.user.tasks"],
        security=_security_provider(config),
        ssl_certfile=config["webserver.ssl.certfile"] if ssl_on else None,
        ssl_keyfile=config["webserver.ssl.keyfile"] or None,
        ssl_keyfile_password=config["webserver.ssl.keyfile.password"] or None,
        ui_diskpath=config["webserver.ui.diskpath"] or None,
        ui_urlprefix=config["webserver.ui.urlprefix"],
        api_urlprefix=config["webserver.api.urlprefix"],
        user_task_retention_ms=config["completed.user.task.retention.time.ms"],
        user_task_timeout_ms=(
            float(config.get("servlet.user.task.timeout.ms"))
            if config.get("servlet.user.task.timeout.ms") else None))


def _monitor(config: CruiseControlConfig, backend, plugin, mode: str, sampler_cls: str,
             store_cls: str, store_dir) -> Tuple[LoadMonitor, LoadMonitorTaskRunner]:
    """The load monitor over ``backend`` and its task runner, with the
    capacity resolver, sampler, sample store, reporter agents and metrics bus
    listener the config names."""
    metadata_client = MetadataClient(backend, ttl_ms=config["metadata.max.age.ms"])
    capacity_file = config.get("capacity.config.file")
    resolver_name = str(config.originals.get(
        "broker.capacity.config.resolver.class", ""))
    if "Env" in resolver_name:
        from cruise_control_tpu_torch.monitor.capacity import BrokerEnvCapacityResolver
        resolver = BrokerEnvCapacityResolver()
    elif capacity_file:
        resolver = BrokerCapacityConfigFileResolver(capacity_file)
    else:
        resolver = None
    load_monitor = LoadMonitor(
        metadata_client,
        capacity_resolver=resolver,
        num_windows=config["num.partition.metrics.windows"],
        window_ms=config["partition.metrics.window.ms"],
        min_samples_per_window=config["min.samples.per.partition.metrics.window"],
        num_broker_windows=config["num.broker.metrics.windows"],
        broker_window_ms=config["broker.metrics.window.ms"],
    )
    if store_cls:
        store = plugin(store_cls)
    elif store_dir and mode == "reporter":
        # KafkaSampleStore shape: accepted samples ride the same
        # partitioned-log SPI the reporter publishes on, so a restart
        # replays them with the N-consumer reload.
        from cruise_control_tpu_torch.reporter import FileTransport
        store = LogSampleStore(
            FileTransport(os.path.join(store_dir, "partition-samples")),
            FileTransport(os.path.join(store_dir, "broker-samples")),
            num_loaders=config["num.metric.fetchers"])
    elif store_dir:
        store = FileSampleStore(store_dir)
    else:
        store = NoopSampleStore()
    reporters = []
    transport = None
    if sampler_cls:
        sampler = plugin(sampler_cls)
    elif mode == "reporter":
        sampler, transport, reporters = _reporter_pipeline(config, backend, store_dir)
    elif mode == "prometheus":
        from cruise_control_tpu_torch.monitor.prometheus import PrometheusMetricSampler
        sampler = PrometheusMetricSampler(endpoint=config["prometheus.server.endpoint"])
    else:
        sampler = SyntheticWorkloadSampler()
    task_runner = LoadMonitorTaskRunner(
        load_monitor, sampler, store,
        sampling_interval_ms=config["metric.sampling.interval.ms"])
    # The task runner starts and stops everything in its reporters list.
    task_runner.reporters = reporters
    bus_port = int(config["metrics.transport.listen.port"])
    if bus_port and transport is not None:
        task_runner.reporters = list(reporters) + [_bus_server(config, transport, bus_port)]
    elif bus_port:
        LOG.warning("metrics.transport.listen.port=%d ignored: it serves the "
                    "reporter-mode transport (metric.sampler.mode=reporter, no "
                    "metric.sampler.class override)", bus_port)
    return load_monitor, task_runner


def _reporter_pipeline(config: CruiseControlConfig, backend, store_dir):
    """Reporter mode's ingestion edge: per-broker reporter agents → the
    metrics bus → the fan-out consuming sampler.  With a store directory the
    bus is a segment-file log, and the consumer's committed offsets keep a
    restart from re-ingesting it.  Returns (sampler, bus, reporters)."""
    from cruise_control_tpu_torch.monitor.fetcher import ConsumingMetricSampler
    from cruise_control_tpu_torch.reporter import (DemoBrokerMetricsSource, FileTransport,
                                                   InProcessTransport, MetricsReporter)
    offsets_path = None
    if store_dir:
        transport = FileTransport(os.path.join(store_dir, "metrics"), num_partitions=8)
        offsets_path = os.path.join(store_dir, "metrics-consumer-offsets.json")
    else:
        transport = InProcessTransport(num_partitions=8)
    source = DemoBrokerMetricsSource(backend)
    interval = config["metric.sampling.interval.ms"]
    reporters = [MetricsReporter(b.broker_id, source, transport,
                                 reporting_interval_ms=interval / 2)
                 for b in backend.fetch().brokers]
    sampler = ConsumingMetricSampler(transport, num_fetchers=config["num.metric.fetchers"],
                                     offsets_path=offsets_path)
    return sampler, transport, reporters


def _bus_server(config: CruiseControlConfig, transport, port: int):
    """The metrics bus's network face: external broker agents publish to
    this listener with ``reporter.SocketTransport``; the consuming sampler
    reads the same log."""
    from cruise_control_tpu_torch.reporter import TransportServer
    from cruise_control_tpu_torch.utils.netsec import read_secret_file
    secret_file = config["metrics.transport.auth.secret.file"]
    secret = read_secret_file(secret_file, "metrics bus secret") if secret_file else None
    bind = config["metrics.transport.listen.address"]
    if bind not in ("127.0.0.1", "localhost", "::1") and not secret:
        LOG.warning("metrics bus bound to %s with NO authentication — any peer "
                    "that can reach the port can forge metrics or read workload "
                    "data; set metrics.transport.auth.secret.file (and TLS)", bind)
    return TransportServer(
        transport, host=bind, port=port, auth_secret=secret,
        ssl_certfile=config["metrics.transport.ssl.certfile"] or None,
        ssl_keyfile=config["metrics.transport.ssl.keyfile"] or None)


def _maintenance_reader(config: CruiseControlConfig, cc: CruiseControl):
    """Maintenance plans from the message bus (MaintenanceEventTopicReader
    analog): a TCP ``TransportServer`` peer or a ``FileTransport`` directory
    feeds the maintenance-event detector, with committed offsets."""
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType
    from cruise_control_tpu_torch.detector.maintenance_reader import MaintenanceEventReader
    from cruise_control_tpu_torch.reporter import FileTransport, SocketTransport
    from cruise_control_tpu_torch.utils.netsec import read_secret_file
    addr = config["maintenance.event.transport.address"]
    directory = config["maintenance.event.transport.dir"]
    if addr:
        secret_file = config["maintenance.event.transport.auth.secret.file"]
        secret = read_secret_file(secret_file, "maintenance bus secret") if secret_file else None
        transport = SocketTransport(
            addr, auth_secret=secret,
            ssl_enable=config["maintenance.event.transport.ssl.enable"],
            ssl_cafile=config["maintenance.event.transport.ssl.cafile"] or None)
    else:
        transport = FileTransport(directory, num_partitions=8)
    offsets_path = config["maintenance.event.offsets.path"] or (
        os.path.join(directory, "consumer-offsets.json") if directory else None)
    return MaintenanceEventReader(
        transport, cc.anomaly_detector.detectors[AnomalyType.MAINTENANCE_EVENT],
        offsets_path=offsets_path, expiration_ms=config["maintenance.plan.expiration.ms"])


def _socket_admin_backend(config: CruiseControlConfig, admin_addr: str, res):
    """``executor.admin.backend.address`` → the socket admin driver, behind
    the reconnecting wrapper and its published circuit breaker when
    ``resilience.reconnect.enabled``."""
    from cruise_control_tpu_torch import resilience
    from cruise_control_tpu_torch.executor.subprocess_backend import SocketClusterBackend
    from cruise_control_tpu_torch.utils.netsec import read_secret_file

    host, _, aport = admin_addr.rpartition(":")
    if not aport.isdigit():
        raise ConfigError("executor.admin.backend.address must be host:port "
                          f"(got {admin_addr!r})")
    secret_file = config["executor.admin.backend.auth.secret.file"]
    secret = read_secret_file(secret_file, "admin backend secret") if secret_file else None
    ahost, aport_i = host or "127.0.0.1", int(aport)
    ssl_en = config["executor.admin.backend.ssl.enable"]
    cafile = config["executor.admin.backend.ssl.cafile"] or None

    def factory():
        return SocketClusterBackend(ahost, aport_i, auth_secret=secret,
                                    ssl_enable=ssl_en, ssl_cafile=cafile)

    if not res.reconnect_enabled:
        return factory()
    # Transport hiccups rebuild the connection under the retry policy; the
    # breaker is published so /metrics and /health can read its state.
    circuit = res.circuit("backend")
    resilience.set_backend_circuit(circuit)
    return resilience.ReconnectingBackend(factory, policy=res.retry_policy(),
                                          circuit=circuit)


def _configure_solver(cc: CruiseControl, config: CruiseControlConfig) -> None:
    """``solver.segment.rounds`` and ``solver.relaxation.*`` onto the
    facade's optimizer; the optimizers a request's own goal list gets share
    its solver and relaxation (the JAX package sets both process-wide)."""
    from cruise_control_tpu_torch.analyzer.relax import RelaxationConfig, relax_sensors

    cc.optimizer.solver.segment_rounds = max(1, int(config["solver.segment.rounds"]))
    if bool(config["solver.relaxation.enabled"]):
        cc.optimizer.relaxation = RelaxationConfig(
            iterations=int(config["solver.relaxation.iterations"]),
            candidates=int(config["solver.relaxation.candidates"]),
            waves=int(config["solver.relaxation.waves"]),
            tolerance=float(config["solver.relaxation.tolerance"]))
    # The JAX package materializes the Solver.relax.* sensors at boot.
    relax_sensors()


def _default_completeness(config):
    """min.valid.partition.ratio → the baseline completeness gate every
    goal-based operation must clear (LoadMonitor.meetCompletenessRequirements
    compares it to the valid-entity ratio)."""
    ratio = float(config["min.valid.partition.ratio"])
    if ratio <= 0.0:
        return None
    from cruise_control_tpu_torch.monitor.load_monitor import ModelCompletenessRequirements
    return ModelCompletenessRequirements(min_monitored_partitions_percentage=ratio)


def _security_provider(config: CruiseControlConfig):
    """webserver.security.* → provider instance (None when disabled)."""
    if not config["webserver.security.enable"]:
        return None
    from cruise_control_tpu_torch.servlet import security as sec
    kind = config["webserver.security.provider"]
    if kind == "basic":
        return sec.BasicSecurityProvider(
            credentials_file=config["webserver.auth.credentials.file"] or None)
    if kind == "jwt":
        secret = config["webserver.auth.jwt.secret"]
        if not secret:
            raise ValueError("webserver.auth.jwt.secret required for jwt provider")
        return sec.JwtSecurityProvider(secret)
    if kind == "spnego":
        validator_path = config["webserver.auth.spnego.validator.class"]
        if not validator_path:
            raise ValueError(
                "webserver.auth.spnego.validator.class required for the "
                "spnego provider (a GSSAPI-backed ticket validator)")
        creds = config["webserver.auth.credentials.file"]
        if not creds:
            # The reference's SPNEGO provider authorizes via its user store;
            # without one, valid-ticket strangers would need a default role
            # the reference denies with 403.
            raise ValueError(
                "webserver.auth.credentials.file required for the spnego "
                "provider (the user store that maps principals to roles)")
        from cruise_control_tpu_torch.config.config_def import get_configured_instance
        validator = get_configured_instance(validator_path)
        return sec.SpnegoSecurityProvider(validator, credentials_file=creds,
                                          default_role=None)
    if kind == "trusted_proxy":
        ips = [s.strip() for s in
               config["webserver.auth.trusted.proxy.ips"].split(",") if s.strip()]
        if not ips:
            raise ValueError("webserver.auth.trusted.proxy.ips required for "
                             "the trusted_proxy provider")
        return sec.TrustedProxySecurityProvider(
            ips, user_header=config["webserver.auth.trusted.proxy.user.header"])
    raise ValueError(f"unknown webserver.security.provider {kind!r}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="cruise-control-tpu-torch")
    parser.add_argument("--config", help="properties file", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--demo", action="store_true",
                        help="run against the in-process fake cluster")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="torch device every solve runs on; cuda exits "
                             "non-zero when no card is visible")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not args.demo:
        # The in-process fake cluster is the only bundled cluster backend;
        # real-cluster deployments implement the MetadataBackend /
        # AdminBackend / MetricSampler seams and wire them in their own
        # bootstrap.  Refuse to silently serve the demo cluster.
        parser.error("only --demo mode ships a cluster backend; for a real "
                     "cluster, wire your MetadataBackend/AdminBackend/"
                     "MetricSampler implementations via the seams in "
                     "monitor/metadata.py, executor/backend.py and "
                     "monitor/sampler.py")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("--device cuda: no CUDA device is visible; pass --device cpu "
                  "to run every solve on the CPU", file=sys.stderr)
            return 2
    config = (CruiseControlConfig.from_properties_file(args.config)
              if args.config else CruiseControlConfig())
    app = build_app(config, port=args.port, device=args.device)
    app.cc.start_up()
    app.start()
    scheme = "https" if app.ssl_enabled else "http"
    print(f"{LISTENING} {scheme}://{config['webserver.http.address']}:{app.port}"
          f" (demo cluster, device {args.device})", flush=True)
    stop = [False]
    signal.signal(signal.SIGTERM, lambda *a: stop.__setitem__(0, True))
    signal.signal(signal.SIGINT, lambda *a: stop.__setitem__(0, True))
    try:
        while not stop[0]:
            time.sleep(0.5)
    finally:
        app.stop()
        app.cc.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
