"""Out-of-process cluster admin driver.

The first real (non-fake) ``ClusterAdminBackend``: it drives a cluster that
lives in ANOTHER PROCESS over JSON-lines pipes — the same three admin seams
the reference's executor drives against Kafka:

- replica reassignments        (``ExecutorUtils.scala:31-93``)
- logdir moves                 (``ExecutorAdminUtils.java:33-124``)
- preferred-leader election    (``ExecutorUtils.scala:94-114``)
- replication throttles        (``ReplicationThrottleHelper.java:29-321`` —
  the same ``(leader|follower).replication.throttled.(rate|replicas)``
  dynamic-config keys, set before an execution and removed after, preserving
  any pre-existing values we did not write)

The peer is normally ``broker_simulator`` (spawned by :meth:`spawn`), but
anything speaking the protocol works.  Transport failures during progress
polling surface as "not finished" so the executor's task-alert timeout path
(``Executor.java:1457-1540`` dead-task handling) — not an exception in the
progress thread — decides the outcome; submission failures raise.
"""

from __future__ import annotations

import json
import select
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.executor.broker_simulator import (
    FOLLOWER_THROTTLED_RATE,
    FOLLOWER_THROTTLED_REPLICAS,
    LEADER_THROTTLED_RATE,
    LEADER_THROTTLED_REPLICAS,
)
from cruise_control_tpu_torch.executor.tasks import ExecutionTask, TaskType

TP = Tuple[str, int]


class BackendTransportError(RuntimeError):
    """The admin peer died or broke protocol."""


class BackendCircuitOpenError(BackendTransportError):
    """The admin-backend circuit breaker is open: the call was refused
    without touching the transport.  Raised by the reconnecting wrapper
    (``resilience/reconnect.py``); defined here, next to its base, so the
    executor can catch it without importing the resilience package (which
    imports this module)."""


class SubprocessClusterBackend:
    """ClusterAdminBackend over a child process speaking JSON lines."""

    def __init__(self, proc: subprocess.Popen, request_timeout_s: float = 10.0):
        self.proc = proc
        self.request_timeout_s = request_timeout_s
        self._lock = threading.Lock()
        self._next_id = 0
        if proc is not None:
            self._rstream = proc.stdout
            self._wstream = proc.stdin
        # Configs we set (entity_type, entity, name) and replica-list entries
        # we merged in — clear_throttles removes exactly these, never a
        # pre-existing operator-set throttle.
        self._set_throttle_keys: List[Tuple[str, object, str]] = []
        self._added_list_entries: List[Tuple[str, str, List[str]]] = []

    # ---------------------------------------------------------------- spawn

    @classmethod
    def spawn(cls, partitions: Sequence[Dict], polls_to_finish: int = 2,
              request_timeout_s: float = 10.0) -> "SubprocessClusterBackend":
        """Start a broker_simulator child and bootstrap it with
        ``partitions`` (dicts: topic/partition/replicas/leader/logdirs)."""
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "cruise_control_tpu_torch.executor.broker_simulator",
             "--polls-to-finish", str(polls_to_finish)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        backend = cls(proc, request_timeout_s=request_timeout_s)
        backend.request("bootstrap", partitions=list(partitions))
        return backend

    def close(self) -> None:
        try:
            self.request("shutdown")
        except BackendTransportError:
            pass
        if self.proc is not None:
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()

    # ------------------------------------------------------------ transport

    def request(self, op: str, **kwargs) -> Dict:
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            msg = json.dumps({"id": rid, "op": op, **kwargs})
            try:
                self._wstream.write(msg + "\n")
                self._wstream.flush()
            except (BrokenPipeError, OSError, ValueError) as e:
                # A write timeout (possible now that sockets carry one)
                # leaves an indeterminate partial frame on a possibly-live
                # peer — poison so the desync cannot corrupt later requests.
                self._poison(f"write failed: {e}")
                raise BackendTransportError(f"peer write failed: {e}") from e
            line = self._read_line()
            try:
                resp = json.loads(line)
            except json.JSONDecodeError as e:
                self._poison(f"bad reply {line!r}")
                raise BackendTransportError(f"bad reply {line!r}") from e
            if resp.get("id") != rid:
                # The stream is now desynced: a late reply to THIS request
                # would be read by the NEXT one, failing every future call
                # against a healthy peer.  Kill the peer so subsequent
                # requests fail fast as transport errors instead.
                self._poison(f"reply id {resp.get('id')} != {rid}")
                raise BackendTransportError(
                    f"reply id {resp.get('id')} != request id {rid}")
        if not resp.get("ok"):
            raise BackendTransportError(resp.get("error", "peer error"))
        return resp

    def _poison(self, why: str) -> None:
        """The request/response framing is unrecoverable (timeout left an
        unread reply in flight, or garbage on the pipe): terminate the peer
        so the failure mode is a clean dead-peer, not an off-by-one reply
        stream."""
        if self.proc is None:
            return
        try:
            self.proc.kill()
        except OSError:
            pass

    def _read_line(self) -> str:
        ready, _, _ = select.select([self._rstream], [],
                                    [], self.request_timeout_s)
        if not ready:
            alive = self.proc.poll() is None if self.proc else False
            # A late reply would desync every subsequent request (it reads
            # the previous answer); poison the peer so this stays a clean
            # transport failure.
            self._poison("request timeout")
            raise BackendTransportError(
                f"no reply within {self.request_timeout_s}s "
                f"(peer was alive={alive})")
        try:
            line = self._rstream.readline()
        except OSError as e:
            # Socket resets / mid-line timeouts are transport failures like
            # any other, and leave the stream desynced.
            self._poison(f"read failed: {e}")
            raise BackendTransportError(f"peer read failed: {e}") from e
        if not line:
            raise BackendTransportError("peer closed the pipe")
        return line

    # ------------------------------------------- ClusterAdminBackend surface

    def execute_replica_reassignments(self, tasks: Sequence[ExecutionTask]) -> None:
        reassignments = []
        for t in tasks:
            p = t.proposal
            reassignments.append({
                "topic": p.topic_partition.topic,
                "partition": p.topic_partition.partition,
                "replicas": [r.broker_id for r in p.new_replicas],
                "logdirs": {str(r.broker_id): r.logdir
                            for r in p.new_replicas if r.logdir is not None},
            })
        if reassignments:
            self.request("alter_partition_reassignments",
                         reassignments=reassignments)

    def execute_logdir_moves(self, tasks: Sequence[ExecutionTask]) -> None:
        moves = []
        for t in tasks:
            p = t.proposal
            for old, new in p.replicas_to_move_between_disks:
                moves.append({"topic": p.topic_partition.topic,
                              "partition": p.topic_partition.partition,
                              "broker": old.broker_id,
                              "logdir": new.logdir})
        if moves:
            self.request("alter_replica_log_dirs", moves=moves)

    def execute_preferred_leader_election(self, tasks: Sequence[ExecutionTask]) -> None:
        # The preferred leader is position 0 of the PROPOSAL's replica order —
        # against Kafka the reassignment has already reordered the assignment
        # and a plain electLeaders suffices (ExecutorUtils.scala:94-114); the
        # wire op carries the target explicitly so the peer need not have
        # observed the reorder.
        parts = [{"topic": t.proposal.topic_partition.topic,
                  "partition": t.proposal.topic_partition.partition,
                  "leader": t.proposal.new_leader.broker_id}
                 for t in tasks]
        if parts:
            self.request("elect_leaders", partitions=parts)

    def in_progress_reassignments(self) -> Set[TP]:
        resp = self.request("list_partition_reassignments")
        return {(r["topic"], int(r["partition"]))
                for r in resp["reassignments"]}

    def offline_logdirs(self) -> Dict[int, List[int]]:
        resp = self.request("describe_log_dirs")
        return {int(b): [int(x) for x in dirs]
                for b, dirs in resp.get("offline", {}).items()}

    def finished(self, task: ExecutionTask,
                 raise_transport_errors: bool = False) -> bool:
        p = task.proposal
        try:
            if task.task_type is TaskType.LEADER_ACTION:
                return self._is_done("leader", p)
            if task.task_type is TaskType.INTRA_BROKER_REPLICA_ACTION:
                return all(
                    self._is_done("logdir", p, broker=old.broker_id)
                    for old, _ in p.replicas_to_move_between_disks)
            return self._is_done("reassign", p)
        except BackendTransportError:
            if raise_transport_errors:
                # The reconnecting wrapper wants the raw signal: it decides
                # between rebuilding the transport and pausing the executor.
                raise
            # Let the executor's alert-timeout mark the task dead instead of
            # blowing up the progress loop (Executor.java:1457-1540).
            return False

    def _is_done(self, kind: str, proposal, **extra) -> bool:
        resp = self.request("is_done", kind=kind,
                            topic=proposal.topic_partition.topic,
                            partition=proposal.topic_partition.partition,
                            **extra)
        return bool(resp["done"])

    # ----------------------------------------------------------- throttles

    def set_throttles(self, rate_bytes_per_s: Optional[int],
                      partitions: Sequence[TP],
                      brokers: Sequence[int] = (),
                      proposals: Sequence = ()) -> None:
        """ReplicationThrottleHelper.setThrottles: rate configs on every
        involved broker (old ∪ new replicas — a destination holding nothing
        yet still needs its follower rate), LEADER throttled-replica lists
        from the OLD replicas (they serve the catch-up reads), FOLLOWER
        lists from the ADDING replicas (they issue the catch-up fetches)."""
        if rate_bytes_per_s is None or not (partitions or proposals):
            return
        involved: Set[int] = set(brokers)
        leader_by_topic: Dict[str, List[str]] = {}
        follower_by_topic: Dict[str, List[str]] = {}
        if proposals:
            for p in proposals:
                tp = p.topic_partition
                old = [r.broker_id for r in p.old_replicas]
                adding = [r.broker_id for r in p.replicas_to_add]
                involved.update(old)
                involved.update(adding)
                leader_by_topic.setdefault(tp.topic, []).extend(
                    f"{tp.partition}:{b}" for b in old)
                follower_by_topic.setdefault(tp.topic, []).extend(
                    f"{tp.partition}:{b}" for b in adding)
        else:
            # Partition-only callers (no proposals): fall back to the current
            # assignment for both lists.
            assignment = {
                (d["topic"], int(d["partition"])): [int(b) for b in d["replicas"]]
                for d in self.request("describe_topics")["partitions"]}
            wanted = set(map(tuple, partitions))
            for (topic, part), replicas in assignment.items():
                if (topic, part) not in wanted:
                    continue
                involved.update(replicas)
                leader_by_topic.setdefault(topic, []).extend(
                    f"{part}:{b}" for b in replicas)
                follower_by_topic.setdefault(topic, []).extend(
                    f"{part}:{b}" for b in replicas)
        # Rate configs: set only where NOT already set by an operator
        # (ReplicationThrottleHelper.setThrottledRateIfUnset), recording what
        # we set so cleanup removes exactly that.  Existing configs are read
        # with ONE batched describe per entity type (Kafka AdminClient
        # describeConfigs takes a collection) — 2.6K sequential round trips
        # before the first movement is not a startup cost to pay.
        broker_cfgs = self.request(
            "describe_configs", entity_type="broker",
            entities=sorted(involved))["configs_by_entity"] if involved else {}
        topics = sorted(set(leader_by_topic) | set(follower_by_topic))
        topic_cfgs = self.request(
            "describe_configs", entity_type="topic",
            entities=topics)["configs_by_entity"] if topics else {}
        for b in sorted(involved):
            existing = broker_cfgs.get(str(b), {})
            ops = [{"name": name, "value": rate_bytes_per_s}
                   for name in (LEADER_THROTTLED_RATE, FOLLOWER_THROTTLED_RATE)
                   if name not in existing]
            if ops:
                self._alter("broker", b, ops)
        # Replica lists: MERGE our entries into any operator-set list and
        # remember only our additions (setLeaderThrottledReplicas merge +
        # removeLeaderThrottledReplicasFromTopic restore).
        for topic in topics:
            existing = topic_cfgs.get(topic, {})
            ops = []
            for name, wanted in ((LEADER_THROTTLED_REPLICAS,
                                  leader_by_topic.get(topic)),
                                 (FOLLOWER_THROTTLED_REPLICAS,
                                  follower_by_topic.get(topic))):
                if not wanted:
                    continue
                prior = [e for e in (existing.get(name) or "").split(",") if e]
                if prior == ["*"]:
                    continue    # operator throttles ALL replicas already
                added = sorted(set(wanted) - set(prior))
                if not added:
                    continue
                ops.append({"name": name, "value": ",".join(prior + added)})
                self._added_list_entries.append((topic, name, added))
            if ops:
                self.request("incremental_alter_configs", entity_type="topic",
                             entity=topic, ops=ops)

    def _alter(self, entity_type: str, entity, ops: List[Dict]) -> None:
        self.request("incremental_alter_configs", entity_type=entity_type,
                     entity=entity, ops=ops)
        for c in ops:
            key = (entity_type, entity, c["name"])
            if c.get("op", "set") != "delete" and key not in self._set_throttle_keys:
                self._set_throttle_keys.append(key)

    def clear_throttles(self) -> None:
        """Restore exactly the pre-execution throttle state: delete the rate
        keys WE set, and strip OUR entries from the replica lists, leaving
        operator-set values untouched (ReplicationThrottleHelper
        .removeThrottles semantics)."""
        keys, self._set_throttle_keys = self._set_throttle_keys, []
        entries, self._added_list_entries = self._added_list_entries, []
        try:
            for entity_type, entity, name in keys:
                self.request("incremental_alter_configs",
                             entity_type=entity_type, entity=entity,
                             ops=[{"name": name, "op": "delete"}])
            for topic, name, added in entries:
                current = self.request(
                    "describe_configs", entity_type="topic",
                    entity=topic)["configs"].get(name, "")
                keep = [e for e in current.split(",")
                        if e and e not in set(added)]
                op = ({"name": name, "value": ",".join(keep)} if keep
                      else {"name": name, "op": "delete"})
                self.request("incremental_alter_configs", entity_type="topic",
                             entity=topic, ops=[op])
        except BackendTransportError:
            pass  # peer gone — nothing left to throttle

    # --------------------------------------------------------- test surface

    def describe_topics(self) -> List[Dict]:
        return self.request("describe_topics")["partitions"]

    def stats(self) -> Dict:
        return self.request("stats")


class SocketClusterBackend(SubprocessClusterBackend):
    """The same admin driver over a TCP SOCKET — the network-facing edge.

    Where SubprocessClusterBackend pipes to a child it owns, this connects
    to an admin endpoint by address (a ``broker_simulator --listen`` peer,
    or anything speaking the protocol), the way the reference's executor
    reaches brokers through a networked AdminClient.  ``spawn_networked``
    starts a listener child on an ephemeral port and connects to it —
    executor traffic then crosses a real socket, not inherited pipes.
    """

    def __init__(self, host: str, port: int, request_timeout_s: float = 10.0,
                 proc: Optional[subprocess.Popen] = None,
                 auth_secret: Optional[str] = None,
                 ssl_enable: bool = False,
                 ssl_cafile: Optional[str] = None):
        import socket

        sock = socket.create_connection((host, port),
                                        timeout=request_timeout_s)
        if ssl_enable or ssl_cafile:
            from cruise_control_tpu_torch.utils.netsec import client_ssl_context
            sock = client_ssl_context(ssl_cafile).wrap_socket(sock)
        self._sock = sock
        # Keep a socket timeout as the mid-line backstop: select() only
        # bounds time-to-FIRST-byte, so a peer stalling after half a reply
        # would otherwise block readline() forever with self._lock held.  A
        # mid-line timeout raises OSError in _read_line, which poisons the
        # stream — the desync is moot because the peer is killed.
        self._sock.settimeout(request_timeout_s)
        super().__init__(proc, request_timeout_s=request_timeout_s)
        self._rstream = self._sock.makefile("r", encoding="utf-8")
        self._wstream = self._sock.makefile("w", encoding="utf-8")
        if auth_secret is not None:
            # First frame on the wire must authenticate (broker_simulator
            # --auth-token-file semantics); a rejection surfaces as the
            # BackendTransportError this raises.
            self.request("auth", token=auth_secret)

    @classmethod
    def spawn_networked(cls, partitions: Sequence[Dict],
                        polls_to_finish: int = 2,
                        request_timeout_s: float = 10.0,
                        auth_token_file: Optional[str] = None,
                        auth_secret: Optional[str] = None,
                        ssl_cert: Optional[str] = None,
                        ssl_key: Optional[str] = None,
                        ssl_cafile: Optional[str] = None) -> "SocketClusterBackend":
        cmd = [sys.executable, "-m",
               "cruise_control_tpu_torch.executor.broker_simulator",
               "--polls-to-finish", str(polls_to_finish), "--listen", "0"]
        if auth_token_file:
            cmd += ["--auth-token-file", auth_token_file]
        if ssl_cert:
            cmd += ["--ssl-cert", ssl_cert]
        if ssl_key:
            cmd += ["--ssl-key", ssl_key]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        # The listener prints its bound port as the first line.  Any failure
        # from here on must reap the child — an orphaned listener survives
        # in accept() holding a port.
        try:
            ready, _, _ = select.select([proc.stdout], [], [],
                                        request_timeout_s)
            if not ready:
                raise BackendTransportError("listener did not report a port")
            first = proc.stdout.readline()
            try:
                port = int(json.loads(first)["listening"])
            except (ValueError, KeyError, TypeError) as e:
                # Child died before/while printing the port (EOF reads as
                # ''): a transport failure, not a parse bug.
                raise BackendTransportError(
                    f"bad listener banner {first!r}: {e}") from e
            backend = cls("127.0.0.1", port,
                          request_timeout_s=request_timeout_s, proc=proc,
                          auth_secret=auth_secret,
                          ssl_enable=bool(ssl_cert or ssl_cafile),
                          ssl_cafile=ssl_cafile)
            backend.request("bootstrap", partitions=list(partitions))
            return backend
        except Exception:
            proc.kill()
            raise

    def _poison(self, why: str) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        super()._poison(why)

    def close(self) -> None:
        super().close()
        try:
            self._sock.close()
        except OSError:
            pass
