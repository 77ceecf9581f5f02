"""Pluggable transport between reporter agents and the monitor (the JAX
package's ``reporter/transport.py``: the same segment files on disk and the
same frames on the wire, so either package's client talks to the other's
server and reads the other's log directories).

Reference: the reporter publishes serialized metrics to the
``__CruiseControlMetrics`` Kafka topic (CruiseControlMetricsReporter.java:
producer setup :160-180, send :340-360) and samplers consume it partitioned.
Here the transport is an SPI with the same shape — append records to a
numbered partition, poll a partition range since an offset — so the
in-process demo, a file-backed queue, or a real message bus all fit behind
the fetch fan-out's partition assignor.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import List, Protocol, Tuple

_LEN = struct.Struct(">I")


class Transport(Protocol):
    @property
    def num_partitions(self) -> int: ...

    def append(self, partition: int, record: bytes) -> None: ...

    def poll(self, partition: int, offset: int,
             max_records: int = 10_000) -> Tuple[List[bytes], int]:
        """(records, next_offset) from ``offset`` onward."""
        ...


class InProcessTransport:
    """Partitioned in-memory log (the demo/test bus)."""

    def __init__(self, num_partitions: int = 8):
        self._parts: List[List[bytes]] = [[] for _ in range(num_partitions)]
        self._lock = threading.Lock()

    def record_count(self, partition: int) -> int:
        with self._lock:
            return len(self._parts[partition % len(self._parts)])

    def truncate_tail(self, partition: int, keep_records: int) -> None:
        """Drop everything but the newest ``keep_records`` (retention — the
        role Kafka topic retention plays for the reference's metrics/sample
        topics).  Invalidates outstanding poll offsets for the partition, so
        only offset-free consumers (replay-from-zero stores) may use it."""
        with self._lock:
            log = self._parts[partition % len(self._parts)]
            del log[:-keep_records]

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def append(self, partition: int, record: bytes) -> None:
        with self._lock:
            self._parts[partition % len(self._parts)].append(record)

    def poll(self, partition: int, offset: int,
             max_records: int = 10_000) -> Tuple[List[bytes], int]:
        with self._lock:
            log = self._parts[partition % len(self._parts)]
            out = log[offset:offset + max_records]
            return list(out), offset + len(out)


class FileTransport:
    """Partitioned length-prefixed segment files (durable demo bus)."""

    def __init__(self, directory: str, num_partitions: int = 8):
        self._dir = directory
        self._n = num_partitions
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()

    @property
    def num_partitions(self) -> int:
        return self._n

    def _path(self, partition: int) -> str:
        return os.path.join(self._dir, f"metrics-{partition % self._n}.log")

    def append(self, partition: int, record: bytes) -> None:
        with self._lock, open(self._path(partition), "ab") as f:
            f.write(_LEN.pack(len(record)))
            f.write(record)

    def record_count(self, partition: int) -> int:
        n = 0
        offset = 0
        while True:
            records, offset = self.poll(partition, offset)
            if not records:
                return n
            n += len(records)

    def truncate_tail(self, partition: int, keep_records: int) -> None:
        """Rewrite the segment keeping the newest ``keep_records`` (see
        InProcessTransport.truncate_tail for the offset-invalidation
        contract)."""
        tail: List[bytes] = []
        offset = 0
        while True:
            records, offset = self.poll(partition, offset)
            if not records:
                break
            tail.extend(records)
            tail = tail[-keep_records:]
        path = self._path(partition)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "wb") as f:
                for rec in tail:
                    f.write(_LEN.pack(len(rec)))
                    f.write(rec)
            os.replace(tmp, path)

    def poll(self, partition: int, offset: int,
             max_records: int = 10_000) -> Tuple[List[bytes], int]:
        """``offset`` is a BYTE offset for the file transport."""
        path = self._path(partition)
        if not os.path.exists(path):
            return [], offset
        out: List[bytes] = []
        with self._lock, open(path, "rb") as f:
            f.seek(offset)
            pos = offset
            while len(out) < max_records:
                head = f.read(_LEN.size)
                if len(head) < _LEN.size:
                    break
                (n,) = _LEN.unpack(head)
                rec = f.read(n)
                if len(rec) < n:   # torn tail write — re-read next poll
                    break
                out.append(rec)
                pos = f.tell()
            return out, pos


#: Upper bound on one request frame (metrics records are KB-scale; the
#: base64 of the largest sane record is far below this).  Bounding the
#: readline keeps one misbehaving peer from buffering an unbounded line into
#: service memory.
MAX_FRAME_BYTES = 4 * 1024 * 1024


class TransportServer:
    """Expose a Transport on a TCP listener — the bus's broker side.

    The reference's metrics bus is a Kafka topic: broker-side reporter
    plugins PRODUCE over the network and the service's samplers CONSUME
    partitioned — inheriting Kafka's SASL/SSL/ACLs.  This server gives any
    local Transport (file-backed for durability, in-process for tests) that
    network face: newline-delimited JSON frames with base64 payloads, ops
    ``meta`` / ``append`` / ``poll``.  Thread-per-connection is plenty at
    control-plane rates.

    Security (the role Kafka's listener security plays): ``auth_secret``
    requires every connection's FIRST frame to be
    ``{"op": "auth", "token": <secret>}`` — anything else is rejected and
    the connection closed, so an unauthenticated peer can neither forge
    metrics nor read workload data.  ``ssl_certfile``/``ssl_keyfile`` wrap
    the listener in TLS (same PEM config shape as the web server), which
    also protects the token in transit.  Plaintext + no secret is demo-only:
    bind it to loopback.
    """

    #: Bound on the per-connection TLS handshake; a peer that connects and
    #: goes silent is dropped after this instead of pinning its thread.
    HANDSHAKE_TIMEOUT_S = 15.0

    def __init__(self, transport: Transport, host: str = "127.0.0.1",
                 port: int = 0, auth_secret: str | None = None,
                 ssl_certfile: str | None = None,
                 ssl_keyfile: str | None = None):
        import socketserver

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def setup(self):
                # TLS is wrapped HERE, in the per-connection thread — never
                # on the listening socket, where one stalled peer's handshake
                # would block the accept loop (and every other agent) until
                # it went away.
                if outer._ssl_ctx is not None:
                    self.request.settimeout(outer.HANDSHAKE_TIMEOUT_S)
                    self.request = outer._ssl_ctx.wrap_socket(
                        self.request, server_side=True)
                    self.request.settimeout(None)
                super().setup()

            def handle(self):
                import base64
                import hmac
                import json
                authed = outer.auth_secret is None
                if not authed:
                    # An unauthenticated peer gets HANDSHAKE_TIMEOUT_S to
                    # present its auth frame; without the deadline, a client
                    # that connects and goes silent pins this handler thread
                    # forever (same DoS shape the TLS setup already guards).
                    self.connection.settimeout(outer.HANDSHAKE_TIMEOUT_S)
                while True:
                    try:
                        line = self.rfile.readline(MAX_FRAME_BYTES)
                    except OSError:
                        # Pre-auth deadline expired (or the socket died):
                        # drop the peer.
                        return
                    if not line:
                        return
                    if len(line) >= MAX_FRAME_BYTES and \
                            not line.endswith(b"\n"):
                        # Oversized frame: answer once, then drop the peer —
                        # the rest of the line would have to be drained
                        # (unbounded) to resync the stream.
                        self._reply({"ok": False, "error":
                                     "frame exceeds MAX_FRAME_BYTES"})
                        return
                    if not authed:
                        # The auth gate sits OUTSIDE the per-frame error
                        # handling: any pre-auth frame that is not a valid
                        # auth op — wrong token, other op, or unparseable
                        # garbage — gets one error frame and a disconnect.
                        # (Inside it, malformed lines would loop as per-frame
                        # errors, letting an unauthenticated peer pin this
                        # thread forever.)
                        try:
                            req = json.loads(line)
                            ok_auth = (isinstance(req, dict)
                                       and req.get("op") == "auth"
                                       and hmac.compare_digest(
                                           str(req.get("token", "")),
                                           outer.auth_secret))
                        except ValueError:
                            ok_auth = False
                        if not ok_auth:
                            self._reply({"ok": False,
                                         "error": "authentication required"})
                            return
                        authed = True
                        # Authenticated peers are long-lived publishers;
                        # clear the handshake deadline.
                        self.connection.settimeout(None)
                        self._reply({"ok": True})
                        continue
                    try:
                        req = json.loads(line)
                        op = req.get("op")
                        if op == "meta":
                            resp = {"ok": True, "num_partitions":
                                    outer.transport.num_partitions}
                        elif op == "append":
                            outer.transport.append(
                                int(req["p"]),
                                base64.b64decode(req["rec"]))
                            resp = {"ok": True}
                        elif op == "poll":
                            recs, nxt = outer.transport.poll(
                                int(req["p"]), int(req["off"]),
                                int(req.get("max", 10_000)))
                            resp = {"ok": True, "next": nxt,
                                    "recs": [base64.b64encode(r).decode()
                                             for r in recs]}
                        elif op == "auth":
                            resp = {"ok": True}      # idempotent re-auth
                        else:
                            resp = {"ok": False,
                                    "error": f"unknown op {op!r}"}
                    except Exception as e:   # noqa: BLE001 — report per frame
                        resp = {"ok": False,
                                "error": f"{type(e).__name__}: {e}"}
                    self._reply(resp)

            def _reply(self, resp) -> None:
                import json
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

            def handle_error(self, request, client_address):
                # Failed TLS handshakes / timeouts from scanners and broken
                # peers are expected noise — one log line, not a traceback.
                import logging
                import sys
                logging.getLogger(__name__).warning(
                    "transport connection from %s failed: %s",
                    client_address, sys.exc_info()[1])

        self.transport = transport
        self.auth_secret = auth_secret
        self._ssl_ctx = None
        if ssl_certfile:
            from cruise_control_tpu_torch.utils.netsec import server_ssl_context
            self._ssl_ctx = server_ssl_context(ssl_certfile, ssl_keyfile)
        self._server = Server((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name="metrics-transport")
        self._thread.start()

    def stop(self) -> None:
        # BaseServer.shutdown() blocks on an event only serve_forever sets —
        # a built-but-never-started server must not hang the caller.
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()


class SocketTransport:
    """Transport client over TCP — the role the Kafka producer/consumer
    clients play for the reference's ``__CruiseControlMetrics`` topic.
    Reporter agents on remote brokers publish through this; the service's
    consuming samplers can equally read a remote bus.  One connection,
    reconnected on failure; calls are serialized (each agent/fetcher owns
    its own instance)."""

    def __init__(self, address: str, timeout_s: float = 10.0,
                 auth_secret: str | None = None,
                 ssl_enable: bool = False,
                 ssl_cafile: str | None = None):
        host, _, port = address.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._timeout = timeout_s
        self._auth_secret = auth_secret
        self._ssl_enable = ssl_enable or bool(ssl_cafile)
        self._ssl_cafile = ssl_cafile
        self._sock = None
        self._rfile = None
        self._lock = threading.Lock()
        self._num_partitions: int | None = None

    def _connect_locked(self):
        import json
        import socket
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        if self._ssl_enable:
            from cruise_control_tpu_torch.utils.netsec import client_ssl_context
            sock = client_ssl_context(self._ssl_cafile).wrap_socket(sock)
        self._sock = sock
        self._rfile = sock.makefile("rb")
        if self._auth_secret is not None:
            # Authenticate the fresh connection before replaying the caller's
            # request (TransportServer requires auth as the first frame).
            sock.sendall((json.dumps(
                {"op": "auth", "token": self._auth_secret}) + "\n").encode())
            line = self._rfile.readline()
            try:
                accepted = bool(line) and json.loads(line).get("ok")
            except ValueError as e:
                # A garbled auth reply is a CONNECTION problem (proxy junk,
                # mid-frame disconnect) — surface it as such so _request's
                # reconnect-and-retry path handles it, instead of a raw
                # JSONDecodeError escaping to the caller.
                raise ConnectionError(
                    f"malformed transport auth reply: {e}") from None
            if not accepted:
                raise ConnectionError("transport authentication rejected")

    def _request(self, req: dict, idempotent: bool = True) -> dict:
        import json

        with self._lock:
            for attempt in (0, 1):
                sent = False
                try:
                    if self._sock is None:
                        self._connect_locked()
                    self._sock.sendall((json.dumps(req) + "\n").encode())
                    sent = True
                    line = self._rfile.readline()
                    if not line:
                        raise ConnectionError("transport peer closed")
                    try:
                        resp = json.loads(line)
                    except ValueError as e:
                        # Same contract as the auth reply: a response that is
                        # not JSON means the stream is broken, not the request.
                        raise ConnectionError(
                            f"malformed transport reply: {e}") from None
                    if not resp.get("ok"):
                        raise RuntimeError(
                            f"transport error: {resp.get('error')}")
                    return resp
                except (OSError, ConnectionError):
                    self._close_locked()
                    # A lost RESPONSE may mean the server already applied
                    # the request; blind resend would double-apply appends
                    # (at-least-once → duplicate metrics).  Retry only
                    # idempotent ops, or failures from before the send.
                    if attempt or (sent and not idempotent):
                        raise
        raise AssertionError("unreachable")

    def _close_locked(self) -> None:
        for f in (self._rfile, self._sock):
            try:
                if f is not None:
                    f.close()
            except OSError:
                pass
        self._sock = self._rfile = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    @property
    def num_partitions(self) -> int:
        if self._num_partitions is None:
            self._num_partitions = int(self._request(
                {"op": "meta"})["num_partitions"])
        return self._num_partitions

    def append(self, partition: int, record: bytes) -> None:
        import base64
        self._request({"op": "append", "p": int(partition),
                       "rec": base64.b64encode(record).decode()},
                      idempotent=False)

    def poll(self, partition: int, offset: int,
             max_records: int = 10_000) -> Tuple[List[bytes], int]:
        import base64
        resp = self._request({"op": "poll", "p": int(partition),
                              "off": int(offset), "max": int(max_records)})
        return ([base64.b64decode(r) for r in resp["recs"]],
                int(resp["next"]))
