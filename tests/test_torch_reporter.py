"""The port's ingestion edge (``reporter/``, ``monitor/fetcher.py``,
``monitor/prometheus.py`` and reporter mode in ``main.build_app``) against
the JAX package's.

Counterparts of ``tests/test_reporter.py``'s 17 tests, each run through both
packages on the same inputs: the serde's bytes, the reporter's records, the
assignor, the consuming and Prometheus samplers' samples, the file and
socket transports, committed offsets, auth, oversized frames, TLS and
pre-auth garbage.  The wire and the files are the bar, not only equal
samples: each package writes and the other reads (segment files, offsets
files, TCP frames both ways).  The demo source's jitter hashes a
``(topic, partition)`` tuple with Python's salted ``hash``, so the two
packages' records agree only within one process, which is why they run side
by side.  Services are driven with explicit clocks (``report_once(time_ms=)``
and ``run_sampling_once(now_ms)``); bounded waits appear only where a real
socket or thread is crossed.
"""

import importlib
import json
import os
import shutil
import socket
import subprocess
import threading
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = {"jax": "cruise_control_tpu", "torch": "cruise_control_tpu_torch"}
GOALS = "RackAwareGoal,ReplicaCapacityGoal,ReplicaDistributionGoal"


def _mods(root):
    names = dict(serde="reporter.serde", transport="reporter.transport",
                 agent="reporter.agent", reporter="reporter", fetcher="monitor.fetcher",
                 prometheus="monitor.prometheus", samples="monitor.samples",
                 metadata="monitor.metadata", md="monitor.metric_def",
                 main="main", config="config.cruise_control_config")
    out = {k: importlib.import_module(f"{root}.{v}") for k, v in names.items()}
    out["root"] = root
    return SimpleNamespace(**out)


@pytest.fixture(scope="module")
def both():
    return {name: _mods(root) for name, root in PKGS.items()}


def _backend(m, num_brokers=3, num_partitions=9, rf=2):
    md = m.metadata
    brokers = [md.BrokerInfo(i, rack=str(i % 2), host=f"host{i}") for i in range(num_brokers)]
    parts = [md.PartitionInfo("T1", p, leader=p % num_brokers,
                              replicas=tuple((p + i) % num_brokers for i in range(rf)),
                              in_sync=tuple((p + i) % num_brokers for i in range(rf)))
             for p in range(num_partitions)]
    return md.FakeMetadataBackend(brokers, parts)


def _report_all(m, backend, transport, time_ms):
    source = m.agent.DemoBrokerMetricsSource(backend)
    for b in backend.fetch().brokers:
        m.agent.MetricsReporter(b.broker_id, source, transport,
                                clock=lambda: time_ms).report_once()


def _log(transport):
    """Every record of every partition, in order."""
    out = []
    for p in range(transport.num_partitions):
        offset, recs = 0, []
        while True:
            got, offset = transport.poll(p, offset, max_records=100_000)
            if not got:
                break
            recs += got
        out.append(recs)
    return out


def _samples(result):
    """A SamplerResult as sorted plain dicts (fetch threads finish in any
    order, so the processor sees brokers in any order)."""
    return (sorted((s.to_dict() for s in result.partition_samples),
                   key=lambda d: (d["topic"], d["partition"], d["brokerId"])),
            sorted((s.to_dict() for s in result.broker_samples), key=lambda d: d["brokerId"]))


def _metric(m, t, draw):
    scope = m.samples.RawMetricScope
    return m.samples.CruiseControlMetric(
        raw_type=m.samples.RawMetricType[t.name], time_ms=float(draw["time"]),
        broker_id=int(draw["broker"]),
        topic=draw["topic"] if t.scope.value != scope.BROKER.value else None,
        partition=draw["partition"] if t.scope.value == scope.PARTITION.value else None,
        value=float(draw["value"]))


def _fields(m):
    return (m.raw_type.name, m.time_ms, m.broker_id, m.topic, m.partition, m.value)


# ------------------------------------------------- tests/test_reporter.py, ported

def test_serde_round_trip_all_types(both):
    """Every one of the 63 types, on seeded values: the port's bytes equal
    the JAX package's, and each package decodes the other's bytes to the
    same record."""
    j, t = both["jax"], both["torch"]
    rng = np.random.default_rng(9)
    for raw_type in j.samples.RawMetricType:
        for topic in ("T1", "topic-ü-∑", ""):
            draw = dict(time=int(rng.integers(0, 2**40)), broker=int(rng.integers(-5, 2**31 - 1)),
                        topic=topic, partition=int(rng.integers(-1, 2**31 - 1)),
                        value=float(rng.normal() * 10.0 ** rng.integers(-6, 12)))
            jm, tm = _metric(j, raw_type, draw), _metric(t, raw_type, draw)
            jb, tb = j.serde.serialize_metric(jm), t.serde.serialize_metric(tm)
            assert tb == jb, raw_type.name
            assert _fields(t.serde.deserialize_metric(jb)) == _fields(jm)
            assert _fields(j.serde.deserialize_metric(tb)) == _fields(tm)
            assert t.serde.deserialize_metric(tb) == tm
    assert t.serde.METRIC_VERSION == j.serde.METRIC_VERSION


def test_serde_rejects_newer_version_and_skips_unknown_type(both):
    j, t = both["jax"], both["torch"]
    m = t.samples.CruiseControlMetric(raw_type=t.samples.RawMetricType.ALL_TOPIC_BYTES_IN,
                                      time_ms=1.0, broker_id=0, value=1.0)
    buf = bytearray(t.serde.serialize_metric(m))
    newer = bytes([buf[0] + 1]) + bytes(buf[1:])
    for pkg in (j, t):
        with pytest.raises(pkg.serde.UnknownVersionError):
            pkg.serde.deserialize_metric(newer)
    unknown_type = bytes([buf[0], 200]) + bytes(buf[2:])
    assert t.serde.deserialize_metric(unknown_type) is None
    assert j.serde.deserialize_metric(unknown_type) is None


def test_raw_type_inventory_matches_reference(both):
    t, j = both["torch"], both["jax"]
    assert len(t.samples.RawMetricType) == len(j.samples.RawMetricType) == 63
    assert t.samples.RawMetricType.PARTITION_SIZE.wire_id == 4
    assert t.samples.RawMetricType.BROKER_LOG_FLUSH_TIME_MS_999TH.wire_id == 62
    for version in range(0, 7):
        assert [x.name for x in t.samples.broker_metric_types_for_version(version)] == \
            [x.name for x in j.samples.broker_metric_types_for_version(version)]
    v4 = t.samples.broker_metric_types_for_version(4)
    v5 = t.samples.broker_metric_types_for_version(5)
    assert len(v5) - len(v4) == 20   # the 20 percentile types arrive in v5


def test_raw_type_inventory_is_exhaustive_vs_reference_source(both):
    """The JAX package's counterpart parses the reference enum; here the
    JAX package's inventory is the reference: entry for entry (name, wire
    id, scope, supported-since version), in the same order."""
    def inventory(m):
        return [(x.name, x.scope.value, x.wire_id, x.supported_since)
                for x in m.samples.RawMetricType]
    assert inventory(both["torch"]) == inventory(both["jax"])
    for x in both["torch"].samples.RawMetricType:
        assert both["torch"].samples.raw_type_by_id(x.wire_id) is x


def test_reporter_emits_full_inventory(both):
    """The demo source's records, as bytes on the bus, equal the JAX
    package's record for record, and carry every broker-scope type."""
    logs = {}
    for name, m in both.items():
        transport = m.transport.InProcessTransport(num_partitions=4)
        rep = m.agent.MetricsReporter(0, m.agent.DemoBrokerMetricsSource(_backend(m)),
                                      transport, clock=lambda: 1000.0)
        assert rep.report_once() > 60
        assert rep.report_once(time_ms=2000.0) == rep.records_reported // 2
        logs[name] = _log(transport)
    assert logs["torch"] == logs["jax"]
    t = both["torch"]
    types = {t.serde.deserialize_metric(r).raw_type for r in logs["torch"][0]}
    assert {x for x in types if x.scope is t.samples.RawMetricScope.BROKER} == \
        {x for x in t.samples.RawMetricType if x.scope is t.samples.RawMetricScope.BROKER}


def test_partition_assignor_round_robin(both):
    assign = both["torch"].fetcher.DefaultMetricSamplerPartitionAssignor.assign
    assert assign(8, 3) == [[0, 3, 6], [1, 4, 7], [2, 5]]
    assert assign(2, 4) == [[0], [1], [], []]
    jassign = both["jax"].fetcher.DefaultMetricSamplerPartitionAssignor.assign
    for n in range(0, 12):
        for f in range(0, 6):
            assert assign(n, f) == jassign(n, f)


def test_consuming_sampler_end_to_end(both):
    got = {}
    for name, m in both.items():
        backend = _backend(m)
        transport = m.transport.InProcessTransport(num_partitions=4)
        _report_all(m, backend, transport, 5_000.0)
        sampler = m.fetcher.ConsumingMetricSampler(transport, num_fetchers=3)
        result = sampler.get_samples(backend.fetch(), 0.0, 10_000.0)
        assert len(result.broker_samples) == 3
        assert len(result.partition_samples) == 9
        ps = result.partition_samples[0]
        assert ps.metrics[m.md.DISK_USAGE] > 0
        assert ps.metrics[m.md.LEADER_BYTES_IN] > 0
        # Offsets advanced: a second poll round returns nothing new.
        assert not sampler.get_samples(backend.fetch(), 0.0, 10_000.0).partition_samples
        sampler.close()
        got[name] = _samples(result)
    assert got["torch"] == got["jax"]


def test_file_transport_round_trip(both, tmp_path):
    """The same records give the same segment files, byte for byte; each
    package's sampler reads the other's directory to the same samples."""
    dirs = {}
    for name, m in both.items():
        dirs[name] = str(tmp_path / name)
        _report_all(m, _backend(m), m.transport.FileTransport(dirs[name], num_partitions=2),
                    5_000.0)
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["torch"])) == ["metrics-0.log", "metrics-1.log"]
    for f in names:
        with open(os.path.join(dirs["jax"], f), "rb") as a, \
                open(os.path.join(dirs["torch"], f), "rb") as b:
            assert a.read() == b.read()
    got = {}
    for name, other in (("torch", "jax"), ("jax", "torch")):
        m = both[name]
        transport = m.transport.FileTransport(dirs[other], num_partitions=2)
        assert transport.record_count(0) + transport.record_count(1) == \
            sum(map(len, _log(both[other].transport.FileTransport(dirs[other], 2))))
        sampler = m.fetcher.ConsumingMetricSampler(transport, num_fetchers=2)
        result = sampler.get_samples(_backend(m).fetch(), 0.0, 10_000.0)
        sampler.close()
        assert len(result.broker_samples) == 3
        assert len(result.partition_samples) == 9
        got[name] = _samples(result)
    assert got["torch"] == got["jax"]


def test_consumer_offsets_survive_restart(both, tmp_path):
    """Committed consumer positions: a sampler of either package, restarted
    over the same durable bus and offsets file that the other package's
    sampler committed, does not re-ingest history, only what came after."""
    j, t = both["jax"], both["torch"]
    bus = str(tmp_path / "bus")
    offsets = str(tmp_path / "offsets.json")
    _report_all(j, _backend(j), j.transport.FileTransport(bus, num_partitions=2), 5_000.0)
    s1 = j.fetcher.ConsumingMetricSampler(j.transport.FileTransport(bus, 2), num_fetchers=2,
                                          offsets_path=offsets)
    assert len(s1.get_samples(_backend(j).fetch(), 0.0, 10_000.0).partition_samples) == 9
    s1.close()
    committed = json.load(open(offsets))

    # "Restart" in the port: the JAX package's history must not come back.
    s2 = t.fetcher.ConsumingMetricSampler(t.transport.FileTransport(bus, 2), num_fetchers=2,
                                          offsets_path=offsets)
    assert not s2.get_samples(_backend(t).fetch(), 0.0, 10_000.0).partition_samples
    assert json.load(open(offsets)) == committed
    # New records do, appended by the port.
    _report_all(t, _backend(t), t.transport.FileTransport(bus, 2), 15_000.0)
    assert len(s2.get_samples(_backend(t).fetch(), 10_000.0, 20_000.0)
               .partition_samples) == 9
    s2.close()
    # And back: the JAX package reads the port's commit and finds nothing new.
    s3 = j.fetcher.ConsumingMetricSampler(j.transport.FileTransport(bus, 2), num_fetchers=2,
                                          offsets_path=offsets)
    assert not s3.get_samples(_backend(j).fetch(), 0.0, 30_000.0).partition_samples
    s3.close()
    # The same positions, as JSON with the same keys.
    with open(offsets) as f:
        final = json.load(f)
    assert sorted(final) == ["0", "1"] and all(v > committed[k] for k, v in final.items())


def _query_fn(m, meta):
    def query_fn(promql, start_ms, end_ms):
        out = []
        if "topic, partition" in promql:              # partition-size query
            for p in meta.partitions:
                out.append(m.prometheus.PrometheusSeries(
                    labels={"instance": f"host{p.leader}:9092", "topic": p.topic,
                            "partition": str(p.partition)},
                    values=[(end_ms / 1000, 5000.0 + p.partition)]))
        elif "topic" in promql:                       # per-topic queries
            for b in meta.brokers:
                out.append(m.prometheus.PrometheusSeries(
                    labels={"instance": f"host{b.broker_id}:9092", "topic": "T1"},
                    values=[(end_ms / 1000, 900.0 + b.broker_id)]))
        else:                                         # broker-scope queries
            for b in meta.brokers:
                out.append(m.prometheus.PrometheusSeries(
                    labels={"instance": f"host{b.broker_id}:9092"},
                    values=[(end_ms / 1000, 0.4), (end_ms / 1000 + 60, 0.6)]))
            # A series from a foreign cluster must be skipped, not fatal.
            out.append(m.prometheus.PrometheusSeries(labels={"instance": "other:9092"},
                                                     values=[(end_ms / 1000, 1.0)]))
        return out
    return query_fn


def test_prometheus_sampler_with_fake_adapter(both):
    got = {}
    for name, m in both.items():
        meta = _backend(m).fetch()
        sampler = m.prometheus.PrometheusMetricSampler(query_fn=_query_fn(m, meta))
        result = sampler.get_samples(meta, 0.0, 120_000.0)
        assert len(result.broker_samples) == 3
        assert len(result.partition_samples) == 9
        bs = result.broker_samples[0]
        assert bs.metrics[m.md.BROKER_METRIC_DEF.metric_id("CPU_USAGE")] == pytest.approx(0.5)
        got[name] = _samples(result)
        with pytest.raises(ValueError):
            m.prometheus.PrometheusMetricSampler()
    assert got["torch"] == got["jax"]
    assert [(k.name, v) for k, v in both["torch"].prometheus.default_query_map().items()] == \
        [(k.name, v) for k, v in both["jax"].prometheus.default_query_map().items()]


def _build(m, props):
    # No warmup daemon: these tests are not about warmup.
    cfg = m.config.CruiseControlConfig(dict(props, **{"compile.warmup.enabled": "false"}))
    if m.root == PKGS["torch"]:
        return m.main.build_app(cfg, port=0, device="cpu")
    return m.main.build_app(cfg, port=0)


def _close(app):
    """An app built and never started."""
    app.user_tasks.shutdown()
    app.server.server_close()
    app.cc.shutdown()


@pytest.fixture
def jax_process_settings():
    """The JAX package's build_app sets the default solver's segment width
    and the relaxation switch process-wide; put both back afterwards."""
    from cruise_control_tpu.analyzer import relax as jrelax
    from cruise_control_tpu.analyzer import solver as jsolver
    rounds = (jsolver._SEGMENT_ROUNDS_DEFAULT, jsolver.default_solver().segment_rounds)
    relax = dict(jrelax._RELAXATION)
    yield
    jsolver.set_default_segment_rounds(rounds[0])
    jsolver.default_solver().segment_rounds = rounds[1]
    jrelax._RELAXATION.update(relax)


def _drive(app, windows, window_ms):
    """Reporting rounds and sampling ticks on an explicit clock: every
    reporter reports inside window ``w``, then the runner samples."""
    runner = app.cc.task_runner
    now = [0.0]
    runner._clock = lambda: now[0] / 1000.0
    runner.start()
    for w in range(windows):
        now[0] = w * window_ms + window_ms / 2
        for rep in runner.reporters:
            if hasattr(rep, "report_once"):
                rep.report_once(time_ms=now[0])
        runner.run_sampling_once(now[0])


def test_reporter_mode_service_pipeline(both, tmp_path, jax_process_settings):
    """Full path through the real bootstrap: reporter agents → transport →
    fan-out sampler → windows → model → solver.  Both packages' services get
    the same reporting rounds and ticks; their monitors freeze to the same
    arrays, and the port's service answers a proposal on the CPU."""
    from cruise_control_tpu_torch.model.state import state_to_numpy
    from test_torch_monitor import _jax_packed, _same_meta, assert_packed_equal
    props = {"metric.sampler.mode": "reporter", "num.metric.fetchers": 3,
             # Reporter and sampling threads never fire: the test's clock drives.
             "metric.sampling.interval.ms": 3_600_000, "partition.metrics.window.ms": 400,
             "broker.metrics.window.ms": 400, "num.partition.metrics.windows": 3,
             "num.broker.metrics.windows": 3, "min.samples.per.partition.metrics.window": 1,
             "default.goals": GOALS, "obs.history.enabled": "false"}
    frozen = {}
    for name, m in both.items():
        app = _build(m, props)
        try:
            runner = app.cc.task_runner
            assert type(runner.sampler).__name__ == "ConsumingMetricSampler"
            assert runner.sampler.num_fetchers == 3
            assert len(runner.reporters) == 6
            assert {r.interval_ms for r in runner.reporters} == {1_800_000}
            _drive(app, 5, 400)
            lm = app.cc.load_monitor
            assert lm.state().num_valid_windows >= 3
            st, pl, meta = lm.cluster_model(**({"device": "cpu"} if name == "torch" else {}))
            frozen[name] = (st, pl, meta)
            if name == "torch":
                result = app.cc.proposals()
                assert result.optimizer_result.stats_after is not None
                assert not {"RackAwareGoal", "ReplicaCapacityGoal"} & \
                    set(result.optimizer_result.violated_goals_after)
        finally:
            _close(app)
    (js, jp, jm), (ts, tp, tm) = frozen["jax"], frozen["torch"]
    assert_packed_equal(state_to_numpy(ts, tp), _jax_packed(js, jp))
    _same_meta(jm, tm)


def _server(m, **kwargs):
    server = m.transport.TransportServer(m.transport.InProcessTransport(num_partitions=4),
                                         **kwargs)
    server.start()
    return server


def test_socket_transport_pipeline(both):
    """The bus's network face: agents publish over TCP, the consuming
    sampler reads the same log over a second connection.  The port's server
    with the port's clients gives the JAX package's samples, and a JAX
    client reads the port's server to the same bytes."""
    t, j = both["torch"], both["jax"]
    server = _server(t)
    try:
        addr = f"127.0.0.1:{server.port}"
        publish = t.transport.SocketTransport(addr)
        assert publish.num_partitions == 4
        _report_all(t, _backend(t), publish, 5_000.0)
        consume = t.transport.SocketTransport(addr)
        sampler = t.fetcher.ConsumingMetricSampler(consume, num_fetchers=2)
        result = sampler.get_samples(_backend(t).fetch(), 0.0, 10_000.0)
        sampler.close()
        assert len(result.broker_samples) == 3
        assert len(result.partition_samples) == 9
        local = j.transport.InProcessTransport(num_partitions=4)
        _report_all(j, _backend(j), local, 5_000.0)
        jresult = j.fetcher.ConsumingMetricSampler(local, num_fetchers=2).get_samples(
            _backend(j).fetch(), 0.0, 10_000.0)
        assert _samples(result) == _samples(jresult)
        # Raw round trip: bytes survive the wire exactly, to either client.
        local2, _ = server.transport.poll(0, 0, 5)
        jclient = j.transport.SocketTransport(addr)
        assert jclient.poll(0, 0, 5)[0] == local2 == t.transport.SocketTransport(addr).poll(
            0, 0, 5)[0]
        assert _log(server.transport) == _log(local)
        for c in (publish, consume, jclient):
            c.close()
    finally:
        server.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_service_assembly_serves_metrics_bus(both):
    """metrics.transport.listen.port through the port's build_app: the
    service's bus is reachable over TCP, by the port's client and the JAX
    package's, and an external append lands in the log the consuming
    sampler reads."""
    t, j = both["torch"], both["jax"]
    # The listen port must be non-zero (0 turns the listener off), so probe
    # one; a port taken between probe and bind is retried.
    for attempt in range(3):
        port = _free_port()
        try:
            app = _build(t, {"metric.sampler.mode": "reporter",
                             "metric.sampling.interval.ms": 3_600_000,
                             "partition.metrics.window.ms": 500,
                             "num.partition.metrics.windows": 3,
                             "metrics.transport.listen.port": port,
                             "obs.history.enabled": "false"})
            break
        except OSError:
            if attempt == 2:
                raise
    try:
        bus = app.cc.task_runner.reporters[-1]
        assert type(bus).__name__ == "TransportServer" and bus.port == port
        app.cc.start_up()
        for client in (t.transport.SocketTransport(f"127.0.0.1:{port}"),
                       j.transport.SocketTransport(f"127.0.0.1:{port}")):
            assert client.num_partitions == 8
            _, end = client.poll(2, 0, 100000)
            client.append(2, b"external-record")
            recs, _ = client.poll(2, end, 100000)
            assert recs == [b"external-record"]
            client.close()
        assert app.cc.task_runner.sampler.transport.record_count(2) >= 2
    finally:
        app.cc.shutdown()
        app.user_tasks.shutdown()
        app.server.server_close()


def _frame(port, payload):
    """Send one raw line; (the first reply frame, whether the peer then
    closed the connection)."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(payload)
        f = s.makefile("rb")
        first = json.loads(f.readline())
        return first, f.readline() == b""


def test_transport_server_shared_secret_auth(both):
    """Authenticated metrics bus, across packages: with the right secret a
    client of either package appends and polls on the other's server; a
    wrong secret is refused and forges nothing; an op before auth gets the
    same error frame from both servers, then a disconnect."""
    replies = {}
    for name, other in (("torch", "jax"), ("jax", "torch")):
        server = both[name].transport.TransportServer(
            both[name].transport.InProcessTransport(num_partitions=2), auth_secret="bus-secret")
        server.start()
        try:
            addr = f"127.0.0.1:{server.port}"
            Client = both[other].transport.SocketTransport
            good = Client(addr, auth_secret="bus-secret")
            good.append(0, b"metric-record")
            assert good.poll(0, 0)[0] == [b"metric-record"]
            good.close()
            with pytest.raises((ConnectionError, OSError)):
                Client(addr, auth_secret="wrong").append(0, b"forged")
            # No secret at all: the first request frame is the refused one.
            with pytest.raises(RuntimeError, match="authentication required"):
                Client(addr).poll(0, 0)
            assert server.transport.record_count(0) == 1        # nothing forged
            replies[name] = _frame(server.port, b'{"op": "poll", "p": 0, "off": 0}\n')
        finally:
            server.stop()
    assert replies["torch"] == replies["jax"]
    assert replies["torch"][0]["ok"] is False and "auth" in replies["torch"][0]["error"]
    assert replies["torch"][1], "the server kept an unauthenticated peer"


def test_transport_server_oversized_frame_rejected(both, monkeypatch):
    """Frames past MAX_FRAME_BYTES get one error reply and a disconnect,
    the same from both servers."""
    replies = {}
    for name, m in both.items():
        assert m.transport.MAX_FRAME_BYTES == 4 * 1024 * 1024
        monkeypatch.setattr(m.transport, "MAX_FRAME_BYTES", 1024)
        server = _server(m)
        try:
            replies[name] = _frame(server.port, b'{"op": "append", "p": 0, "rec": "'
                                   + b"A" * 4096 + b'"}\n')
            assert server.transport.record_count(0) == 0
        finally:
            server.stop()
    assert replies["torch"] == replies["jax"]
    assert "MAX_FRAME" in replies["torch"][0]["error"] and replies["torch"][1]


@pytest.mark.skipif(shutil.which("openssl") is None, reason="openssl CLI not available")
def test_transport_server_tls(both, tmp_path):
    """TLS metrics bus, across packages: a CA-pinned authenticated client of
    either package round-trips records with the other's server; a plaintext
    client cannot."""
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                    "-keyout", str(key), "-out", str(cert), "-days", "1",
                    "-subj", "/CN=localhost"], check=True, capture_output=True)
    for name, other in (("torch", "jax"), ("jax", "torch")):
        server = both[name].transport.TransportServer(
            both[name].transport.InProcessTransport(num_partitions=2), auth_secret="bus-secret",
            ssl_certfile=str(cert), ssl_keyfile=str(key))
        server.start()
        try:
            addr = f"127.0.0.1:{server.port}"
            Client = both[other].transport.SocketTransport
            client = Client(addr, auth_secret="bus-secret", ssl_cafile=str(cert))
            client.append(1, b"over-tls")
            assert client.poll(1, 0)[0] == [b"over-tls"]
            assert client.num_partitions == 2
            client.close()
            plain = Client(addr, auth_secret="bus-secret", timeout_s=5.0)
            with pytest.raises((ConnectionError, OSError)):
                plain.append(0, b"plaintext")
            assert server.transport.record_count(0) == 0
        finally:
            server.stop()


def test_transport_server_preauth_garbage_disconnects(both):
    """Unparseable pre-auth frames disconnect, with the same reply from both
    servers: an unauthenticated peer may not pin a server thread."""
    replies = {}
    for name, m in both.items():
        server = _server(m, auth_secret="s")
        try:
            replies[name] = _frame(server.port, b"not json at all\n")
        finally:
            server.stop()
    assert replies["torch"] == replies["jax"]
    assert replies["torch"][0]["ok"] is False and "auth" in replies["torch"][0]["error"]
    assert replies["torch"][1], "the server kept a peer that sent garbage"


# ------------------------------------------------------------- cross-package wire

def test_request_frames_equal_jax(both):
    """The clients' request frames, as the server reads them, are the JAX
    package's byte for byte (auth, meta, append, poll)."""
    lines = {}
    for name, m in both.items():
        with socket.socket() as listener:
            listener.bind(("127.0.0.1", 0))
            listener.listen(1)
            client = m.transport.SocketTransport(f"127.0.0.1:{listener.getsockname()[1]}",
                                                 auth_secret="k")
            got = []

            def serve():
                conn, _ = listener.accept()
                with conn:
                    f = conn.makefile("rb")
                    replies = [{"ok": True}, {"ok": True, "num_partitions": 3}, {"ok": True},
                               {"ok": True, "next": 9, "recs": ["AAE="]}]
                    for reply in replies:
                        got.append(f.readline())
                        conn.sendall((json.dumps(reply) + "\n").encode())

            th = threading.Thread(target=serve, daemon=True)
            th.start()
            assert client.num_partitions == 3
            client.append(1, b"\x00\x01\xff")
            assert client.poll(2, 5, 7) == ([b"\x00\x01"], 9)
            client.close()
            th.join(10)
            assert not th.is_alive()
            lines[name] = got
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 4
