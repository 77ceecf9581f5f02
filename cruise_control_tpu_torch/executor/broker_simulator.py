"""Scripted broker simulator — the out-of-process stand-in cluster.

The analog of the reference's embedded-broker integration harness
(``cruise-control-metrics-reporter/src/test/.../CCKafkaIntegrationTestHarness
.java``): a separate PROCESS that speaks an admin protocol, so the executor's
cluster driver (``subprocess_backend.SubprocessClusterBackend``) is exercised
over a real process boundary — serialization, request/response framing, dead
-peer behavior — not an in-process object graph.

Protocol: one JSON object per line on stdin, one JSON reply per line on
stdout (``{"id": n, "op": ...}`` → ``{"id": n, "ok": true, ...}``).  The op
surface mirrors the slices of the Kafka admin API the reference's executor
drives: partition reassignments (``ExecutorUtils.scala:31-93``), logdir moves
(``ExecutorAdminUtils.java:33-124``), preferred-leader election
(``ExecutorUtils.scala:94-114``), and incremental config changes for
replication throttles (``ReplicationThrottleHelper.java:29-321`` — the same
``*.replication.throttled.rate``/``.replicas`` keys).

Replication progress is poll-driven and deterministic: each ``is_done`` query
for a movement decrements its countdown (``polls_to_finish`` ticks), and
movements touching a failed broker never progress — which is how tests
exercise the executor's dead-task timeout path.

Run standalone: ``python -m cruise_control_tpu_torch.executor.broker_simulator``.
Neither torch nor the executor is on this import path (the package's
``__init__`` resolves its names lazily): the process must start in
milliseconds.
"""

from __future__ import annotations

import json
import random
import sys
import time
from typing import Dict, List, Optional, Tuple

TP = Tuple[str, int]

# ReplicationThrottleHelper.java:38-45 — the exact dynamic-config keys.
LEADER_THROTTLED_RATE = "leader.replication.throttled.rate"
FOLLOWER_THROTTLED_RATE = "follower.replication.throttled.rate"
LEADER_THROTTLED_REPLICAS = "leader.replication.throttled.replicas"
FOLLOWER_THROTTLED_REPLICAS = "follower.replication.throttled.replicas"


class BrokerSimulator:
    """In-memory cluster state + admin op handlers (usable in-process by unit
    tests; the __main__ loop wraps it in stdio framing)."""

    def __init__(self, polls_to_finish: int = 2):
        self.polls_to_finish = polls_to_finish
        # (topic, partition) -> {"replicas": [b...], "leader": b,
        #                        "logdirs": {b: dir}}
        self.partitions: Dict[TP, Dict] = {}
        # In-flight movements: key -> {"ticks": n, "apply": {...}}
        self._reassign: Dict[TP, Dict] = {}
        self._logdir: Dict[Tuple[str, int, int], Dict] = {}
        self._election: Dict[TP, Dict] = {}
        self.failed_brokers: set = set()
        self.offline_logdirs: Dict[int, set] = {}
        self.broker_configs: Dict[int, Dict[str, str]] = {}
        self.topic_configs: Dict[str, Dict[str, str]] = {}
        # Audit trail for test assertions.
        self.config_log: List[Dict] = []
        self.max_inflight = 0
        self.max_inflight_per_broker: Dict[int, int] = {}
        # Transport-level fault injection (op_chaos / --chaos-* flags):
        # per-request probabilities of added latency, a swallowed reply
        # (client read times out), or a connection reset.  Seeded so chaos
        # runs replay.
        self.chaos: Dict[str, float] = {"delay_p": 0.0, "delay_ms": 0.0,
                                        "drop_p": 0.0, "reset_p": 0.0}
        self._chaos_rng = random.Random(0)

    # ------------------------------------------------------------- handlers

    def handle(self, req: Dict) -> Dict:
        op = req.get("op")
        fn = getattr(self, f"op_{op}", None)
        if fn is None:
            return {"ok": False, "error": f"unknown op {op!r}"}
        try:
            out = fn(req) or {}
        except Exception as e:  # noqa: BLE001 — report, don't die
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        out.setdefault("ok", True)
        return out

    def op_bootstrap(self, req):
        for p in req["partitions"]:
            key = (p["topic"], int(p["partition"]))
            self.partitions[key] = {
                "replicas": [int(b) for b in p["replicas"]],
                "leader": int(p.get("leader", p["replicas"][0])),
                "logdirs": {int(b): int(d) for b, d in
                            (p.get("logdirs") or {}).items()},
            }

    def op_describe_topics(self, req):
        return {"partitions": [
            {"topic": t, "partition": p, "replicas": st["replicas"],
             "leader": st["leader"],
             "logdirs": {str(b): d for b, d in st["logdirs"].items()}}
            for (t, p), st in sorted(self.partitions.items())]}

    # -- movements

    def _track_inflight(self) -> None:
        per_broker: Dict[int, int] = {}
        for key, mv in self._reassign.items():
            for b in mv["brokers"]:
                per_broker[b] = per_broker.get(b, 0) + 1
        self.max_inflight = max(self.max_inflight,
                                len(self._reassign) + len(self._logdir))
        for b, n in per_broker.items():
            self.max_inflight_per_broker[b] = max(
                self.max_inflight_per_broker.get(b, 0), n)

    def op_alter_partition_reassignments(self, req):
        for r in req["reassignments"]:
            key = (r["topic"], int(r["partition"]))
            if key not in self.partitions:
                raise KeyError(f"unknown partition {key}")
            target = [int(b) for b in r["replicas"]]
            cur = self.partitions[key]
            stuck = bool(self.failed_brokers.intersection(
                set(target) | set(cur["replicas"])))
            self._reassign[key] = {
                "ticks": -1 if stuck else self.polls_to_finish,
                "target": target,
                "logdirs": {int(b): int(d) for b, d in
                            (r.get("logdirs") or {}).items()},
                "brokers": sorted(set(target) | set(cur["replicas"])),
            }
        self._track_inflight()

    def op_alter_replica_log_dirs(self, req):
        for r in req["moves"]:
            key = (r["topic"], int(r["partition"]), int(r["broker"]))
            tp = key[:2]
            if tp not in self.partitions:
                raise KeyError(f"unknown partition {tp}")
            stuck = key[2] in self.failed_brokers
            self._logdir[key] = {
                "ticks": -1 if stuck else self.polls_to_finish,
                "target": int(r["logdir"]),
            }
        self._track_inflight()

    def op_elect_leaders(self, req):
        for r in req["partitions"]:
            key = (r["topic"], int(r["partition"]))
            if key not in self.partitions:
                raise KeyError(f"unknown partition {key}")
            # Preferred = explicit target when given, else first alive
            # replica in assignment order (ExecutorUtils.scala:94-114).
            self._election[key] = {"ticks": 1,
                                   "leader": r.get("leader")}

    def op_list_partition_reassignments(self, req):
        return {"reassignments": [
            {"topic": t, "partition": p} for t, p in sorted(self._reassign)]}

    def op_is_done(self, req):
        kind = req.get("kind", "reassign")
        key = (req["topic"], int(req["partition"]))
        if kind == "reassign":
            return {"done": self._advance(self._reassign, key,
                                          self._apply_reassign)}
        if kind == "logdir":
            k3 = (*key, int(req["broker"]))
            return {"done": self._advance(self._logdir, k3,
                                          self._apply_logdir)}
        if kind == "leader":
            return {"done": self._advance(self._election, key,
                                          self._apply_election)}
        raise ValueError(f"unknown kind {kind!r}")

    def _advance(self, table, key, apply_fn) -> bool:
        mv = table.get(key)
        if mv is None:
            return True
        if mv["ticks"] < 0:          # stuck on a failed broker
            return False
        mv["ticks"] -= 1
        if mv["ticks"] > 0:
            return False
        apply_fn(key, mv)
        del table[key]
        return True

    def _apply_reassign(self, key: TP, mv) -> None:
        st = self.partitions[key]
        st["replicas"] = list(mv["target"])
        for b, d in mv["logdirs"].items():
            st["logdirs"][b] = d
        for b in list(st["logdirs"]):
            if b not in mv["target"]:
                del st["logdirs"][b]
        # Kafka keeps the current leader unless it was removed.
        if st["leader"] not in st["replicas"]:
            st["leader"] = st["replicas"][0]

    def _apply_logdir(self, key, mv) -> None:
        t, p, b = key
        self.partitions[(t, p)]["logdirs"][b] = mv["target"]

    def _apply_election(self, key: TP, mv) -> None:
        st = self.partitions[key]
        want = mv.get("leader")
        if want is not None and int(want) in st["replicas"] \
                and int(want) not in self.failed_brokers:
            st["leader"] = int(want)
            return
        for b in st["replicas"]:
            if b not in self.failed_brokers:
                st["leader"] = b
                break

    # -- configs (throttles)

    def op_incremental_alter_configs(self, req):
        entity_type = req["entity_type"]
        entity = req["entity"]
        table = (self.broker_configs.setdefault(int(entity), {})
                 if entity_type == "broker"
                 else self.topic_configs.setdefault(str(entity), {}))
        for c in req["ops"]:
            if c.get("op", "set") == "delete":
                table.pop(c["name"], None)
            else:
                table[c["name"]] = str(c["value"])
            self.config_log.append({"entity_type": entity_type,
                                    "entity": entity, **c})

    def op_describe_configs(self, req):
        """Single entity (``entity``) or batched (``entities`` list — the
        Kafka AdminClient describeConfigs shape, one round trip for many)."""
        def lookup(entity):
            if req["entity_type"] == "broker":
                return dict(self.broker_configs.get(int(entity), {}))
            return dict(self.topic_configs.get(str(entity), {}))

        if "entities" in req:
            return {"configs_by_entity": {str(e): lookup(e)
                                          for e in req["entities"]}}
        return {"configs": lookup(req["entity"])}

    # -- fault injection / introspection (test-only surface)

    def op_fail_broker(self, req):
        self.failed_brokers.add(int(req["broker"]))
        for mv in self._reassign.values():
            if self.failed_brokers.intersection(mv["brokers"]):
                mv["ticks"] = -1

    def op_restore_broker(self, req):
        self.failed_brokers.discard(int(req["broker"]))

    def op_fail_logdir(self, req):
        """Fault injection: mark one broker logdir offline (the state the
        reference's DiskFailureDetector reads via describeLogDirs)."""
        self.offline_logdirs.setdefault(int(req["broker"]), set()).add(
            int(req["logdir"]))

    def op_restore_logdir(self, req):
        dirs = self.offline_logdirs.get(int(req["broker"]))
        if dirs:
            dirs.discard(int(req["logdir"]))

    def op_describe_log_dirs(self, req):
        return {"offline": {str(b): sorted(d)
                            for b, d in self.offline_logdirs.items() if d}}

    def op_stats(self, req):
        return {"max_inflight": self.max_inflight,
                "max_inflight_per_broker": {
                    str(b): n for b, n in self.max_inflight_per_broker.items()},
                "config_log": self.config_log}

    def op_chaos(self, req):
        """Set the fault-injection knobs over the wire (any subset); replies
        with the resulting configuration.  ``seed`` re-seeds the chaos RNG so
        a storm run is replayable from its seed alone."""
        for k in ("delay_p", "delay_ms", "drop_p", "reset_p"):
            if k in req:
                self.chaos[k] = float(req[k])
        if "seed" in req:
            self._chaos_rng = random.Random(int(req["seed"]))
        return {"chaos": dict(self.chaos)}

    def chaos_action(self, op: Optional[str]) -> Optional[str]:
        """Roll the chaos dice for one request: None (serve normally),
        "drop" (swallow the request, send no reply), or "reset" (close the
        connection mid-protocol).  Control-plane ops are immune so a test
        can always re-arm/disarm chaos and shut the simulator down."""
        if op in _CHAOS_IMMUNE:
            return None
        ch, rng = self.chaos, self._chaos_rng
        if ch["delay_p"] > 0 and rng.random() < ch["delay_p"]:
            time.sleep(ch["delay_ms"] / 1000.0)
        if ch["reset_p"] > 0 and rng.random() < ch["reset_p"]:
            return "reset"
        if ch["drop_p"] > 0 and rng.random() < ch["drop_p"]:
            return "drop"
        return None

    def op_ping(self, req):
        return {}

    def op_auth(self, req):
        # Re-auth on an already-authenticated (or auth-free) stream is a
        # no-op success, so a client configured with a token works against a
        # token-free peer too.
        return {}


# Ops exempt from fault injection: chaos must stay steerable, auth failures
# must be deterministic, and a shutdown/bootstrap must always land.
_CHAOS_IMMUNE = {"chaos", "auth", "shutdown", "bootstrap", None}


def _serve_stream(sim: "BrokerSimulator", lines, write) -> Optional[str]:
    """Drain one JSON-lines stream; returns "shutdown" when a shutdown op
    arrived, "reset" when chaos cut the connection, None on EOF."""
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            write(json.dumps({"ok": False, "error": f"bad json: {e}"}) + "\n")
            continue
        if req.get("op") == "shutdown":
            write(json.dumps({"id": req.get("id"), "ok": True}) + "\n")
            return "shutdown"
        action = sim.chaos_action(req.get("op"))
        if action == "reset":
            return "reset"
        if action == "drop":
            continue
        resp = sim.handle(req)
        resp["id"] = req.get("id")
        write(json.dumps(resp) + "\n")
    return None


def _serve_tcp(sim: "BrokerSimulator", port: int,
               auth_token: Optional[str] = None,
               ssl_cert: Optional[str] = None,
               ssl_key: Optional[str] = None,
               bind: str = "127.0.0.1") -> int:
    """Network-facing mode: the same JSON-lines admin protocol over a TCP
    socket (the shape of the reference's AdminClient->broker network edge —
    which inherits the cluster's SASL/SSL security).  Prints the bound port
    on stdout so a parent with port 0 can connect.

    Clients are served thread-per-connection — a real admin endpoint holds
    the service's long-lived driver connection AND operator tooling at once
    — with op handlers serialized by a lock, so cluster state stays
    consistent across concurrent clients.

    With ``auth_token`` set, each connection's first frame must be
    ``{"op": "auth", "token": <token>}``; anything else gets one error reply
    and a disconnect — an unauthenticated peer cannot move replicas or read
    cluster state.  ``ssl_cert``/``ssl_key`` wrap the listener in TLS,
    protecting the token and the admin stream in transit."""
    import errno
    import hmac
    import socket
    import threading

    srv = socket.create_server((bind, port))
    ssl_ctx = None
    if ssl_cert:
        from cruise_control_tpu_torch.utils.netsec import server_ssl_context
        ssl_ctx = server_ssl_context(ssl_cert, ssl_key)
    print(json.dumps({"listening": srv.getsockname()[1]}), flush=True)
    state_lock = threading.Lock()
    shutdown_evt = threading.Event()
    raw_handle = sim.handle

    def locked_handle(req):
        with state_lock:
            return raw_handle(req)

    sim.handle = locked_handle

    def serve_client(conn):
        with conn:
            conn.settimeout(None)   # the accept loop's poll timeout must
            if ssl_ctx is not None:  # never cut a blocking client read
                # Handshake in the per-connection thread (never the accept
                # loop), bounded so a silent peer can't pin its thread.
                try:
                    conn.settimeout(15.0)
                    conn = ssl_ctx.wrap_socket(conn, server_side=True)
                    conn.settimeout(None)
                except OSError:
                    return
            rfile = conn.makefile("r", encoding="utf-8")
            wfile = conn.makefile("w", encoding="utf-8")

            def write(s: str) -> None:
                wfile.write(s)
                wfile.flush()

            try:
                if auth_token is not None:
                    first = rfile.readline()
                    try:
                        req = json.loads(first)
                    except (ValueError, TypeError):
                        req = {}
                    if not isinstance(req, dict):
                        # Valid-but-non-object JSON ('5', '[]') must be an
                        # auth rejection, not an AttributeError that unwinds
                        # the handler.
                        req = {}
                    if req.get("op") != "auth" or not hmac.compare_digest(
                            str(req.get("token", "")), auth_token):
                        write(json.dumps(
                            {"id": req.get("id"), "ok": False,
                             "error": "authentication required"}) + "\n")
                        return
                    write(json.dumps(
                        {"id": req.get("id"), "ok": True}) + "\n")
                outcome = _serve_stream(sim, rfile, write)
                if outcome == "shutdown":
                    shutdown_evt.set()
                # "reset": fall through — closing the socket mid-protocol
                # IS the injected fault the client observes.
            except OSError:
                # Unclean client disconnect (reset mid-read, broken pipe on
                # reply) must not kill the listener — cluster state survives
                # across connections.
                pass

    try:
        srv.settimeout(0.5)
        while not shutdown_evt.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError as e:
                # TLS handshake failure from a bad client must not kill the
                # listener — but a listener whose own socket is gone (closed
                # fd, ENOTSOCK, EINVAL from shutdown) will fail every accept
                # forever; continuing would busy-spin at 2 Hz for the life of
                # the process.  Per-connection errors keep looping; fatal
                # listener errors end the serve loop.
                if e.errno in (errno.EBADF, errno.ENOTSOCK, errno.EINVAL):
                    print(json.dumps({"error": f"listener socket unusable: "
                                               f"{e}"}), file=sys.stderr,
                          flush=True)
                    return 1
                continue
            threading.Thread(target=serve_client, args=(conn,),
                             daemon=True).start()
        return 0
    finally:
        srv.close()


def main(argv: Optional[List[str]] = None) -> int:
    polls = 2
    args = list(sys.argv[1:] if argv is None else argv)
    if "--polls-to-finish" in args:
        polls = int(args[args.index("--polls-to-finish") + 1])
    sim = BrokerSimulator(polls_to_finish=polls)
    # Fault injection from the command line (same knobs as op_chaos), so a
    # chaos soak needs no control connection to arm the faults.
    for flag, key in (("--chaos-delay-p", "delay_p"),
                      ("--chaos-delay-ms", "delay_ms"),
                      ("--chaos-drop-p", "drop_p"),
                      ("--chaos-reset-p", "reset_p")):
        if flag in args:
            sim.chaos[key] = float(args[args.index(flag) + 1])
    if "--chaos-seed" in args:
        sim._chaos_rng = random.Random(
            int(args[args.index("--chaos-seed") + 1]))
    if "--listen" in args:
        token = None
        if "--auth-token-file" in args:
            # A file, not argv: command lines are world-readable (/proc).
            from cruise_control_tpu_torch.utils.netsec import read_secret_file
            token = read_secret_file(
                args[args.index("--auth-token-file") + 1], "admin auth token")
        cert = (args[args.index("--ssl-cert") + 1]
                if "--ssl-cert" in args else None)
        key = (args[args.index("--ssl-key") + 1]
               if "--ssl-key" in args else None)
        # Remote admin topologies (the reason the auth/TLS flags exist) need
        # a non-loopback bind; keep loopback the safe default.
        bind = (args[args.index("--bind") + 1]
                if "--bind" in args else "127.0.0.1")
        return _serve_tcp(sim, int(args[args.index("--listen") + 1]),
                          auth_token=token, ssl_cert=cert, ssl_key=key,
                          bind=bind)

    out = sys.stdout

    def write(s: str) -> None:
        out.write(s)
        out.flush()

    _serve_stream(sim, sys.stdin, write)
    return 0


if __name__ == "__main__":
    sys.exit(main())
