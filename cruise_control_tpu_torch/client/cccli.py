"""``tpucc-torch`` — command-line client (the JAX package's ``tpucc``).

Reference: ``cruise-control-client/cruisecontrolclient/client/cccli.py`` (the
``cccli`` console script), ``client/Endpoint.py:14-430`` (one spec per REST
endpoint with its allowed parameters) and ``client/Responder.py`` (HTTP with
progress polling on 202 responses).  The offline ``propose`` subcommand runs
the port's analyzer locally on a snapshot file without a server
(:mod:`cruise_control_tpu_torch.client.propose`), on ``--device`` (``cuda``
by default).

    python -m cruise_control_tpu_torch.client.cccli -a http://127.0.0.1:9090 \
        rebalance --dryrun true
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

USER_TASK_HEADER = "User-Task-ID"


def _bool_param(raw: str) -> str:
    v = raw.strip().lower()
    if v not in ("true", "false", "1", "0", "yes", "no"):
        raise ValueError(f"expected a boolean, got {raw!r}")
    return "true" if v in ("true", "1", "yes") else "false"


def _int_param(raw: str) -> str:
    int(raw)          # raises ValueError with context via argparse
    return raw.strip()


def _pos_int_param(raw: str) -> str:
    if int(raw) <= 0:
        raise ValueError(f"expected a positive integer, got {raw!r}")
    return raw.strip()


def _float_param(raw: str) -> str:
    float(raw)
    return raw.strip()


def _csv_int_param(raw: str) -> str:
    parts = [p.strip() for p in raw.split(",") if p.strip()]
    if not parts:
        raise ValueError("expected a comma-separated id list")
    for p in parts:
        int(p)
    return ",".join(parts)


def _csv_str_param(raw: str) -> str:
    parts = [p.strip() for p in raw.split(",") if p.strip()]
    if not parts:
        raise ValueError("expected a comma-separated list")
    return ",".join(parts)


def _str_param(raw: str) -> str:
    return raw


_ANOMALY_TYPES = ("broker_failure", "goal_violation", "disk_failure",
                  "metric_anomaly", "topic_anomaly", "maintenance_event")


def _anomaly_type_param(raw: str) -> str:
    """CSV of anomaly types (the server accepts a list)."""
    parts = [p.strip().lower() for p in raw.split(",") if p.strip()]
    if not parts:
        raise ValueError("expected at least one anomaly type")
    for p in parts:
        if p not in _ANOMALY_TYPES:
            raise ValueError(f"expected one of {_ANOMALY_TYPES}, got {p!r}")
    return ",".join(parts)


# Typed parameter registry (the reference's CCParameter classes —
# cruise-control-client/.../client/CCParameter/* — one validator per
# parameter; bad values are rejected client-side before any HTTP).
PARAMETERS: Dict[str, "Parameter"] = {}


@dataclass(frozen=True)
class Parameter:
    name: str
    validator: "object"
    help: str = ""

    def __post_init__(self):
        PARAMETERS[self.name] = self


Parameter("verbose", _bool_param, "include verbose sections")
Parameter("entries", _pos_int_param, "max records returned")
Parameter("goals", _csv_str_param, "comma-separated goal names")
Parameter("excluded_topics", _csv_str_param, "topics to leave untouched")
Parameter("dryrun", _bool_param, "propose only, do not execute")
Parameter("kafka_assigner", _bool_param, "use kafka-assigner mode goals")
Parameter("destination_broker_ids", _csv_int_param, "allowed destinations")
Parameter("brokerid", _csv_int_param, "target broker id(s)")
Parameter("start", _float_param, "range start (ms)")
Parameter("end", _float_param, "range end (ms)")
Parameter("topic", _str_param, "topic name")
Parameter("replication_factor", _pos_int_param, "target replication factor")
Parameter("reason", _str_param, "free-form reason")
Parameter("approve", _csv_int_param, "review id(s) to approve")
Parameter("discard", _csv_int_param, "review id(s) to discard")
Parameter("enable_self_healing_for", _anomaly_type_param, "anomaly type")
Parameter("disable_self_healing_for", _anomaly_type_param, "anomaly type")
Parameter("concurrent_partition_movements_per_broker", _pos_int_param,
          "executor concurrency cap")


@dataclass(frozen=True)
class EndpointSpec:
    """One REST endpoint: method + the parameters it accepts
    (client/Endpoint.py's Endpoint classes)."""

    name: str
    method: str
    params: Tuple[str, ...] = ()
    help: str = ""

    def __post_init__(self):
        unknown = [p for p in self.params if p not in PARAMETERS]
        assert not unknown, f"{self.name}: unregistered parameters {unknown}"


ENDPOINTS: Dict[str, EndpointSpec] = {e.name: e for e in [
    EndpointSpec("state", "GET", ("verbose",), "cruise control state"),
    EndpointSpec("load", "GET", (), "broker-level load stats"),
    EndpointSpec("partition_load", "GET", ("entries",), "per-partition loads"),
    EndpointSpec("kafka_cluster_state", "GET", (), "broker/partition state"),
    EndpointSpec("user_tasks", "GET", (), "async task list"),
    EndpointSpec("review_board", "GET", (), "two-step review board"),
    EndpointSpec("proposals", "GET", ("goals", "excluded_topics"),
                 "compute (cached) proposals"),
    EndpointSpec("bootstrap", "GET", ("start", "end"), "re-ingest sample range"),
    EndpointSpec("train", "GET", ("start", "end"), "train the CPU model"),
    EndpointSpec("rebalance", "POST", ("dryrun", "goals", "excluded_topics",
                                       "destination_broker_ids",
                                       "kafka_assigner"), "rebalance"),
    EndpointSpec("add_broker", "POST", ("brokerid", "dryrun", "goals"),
                 "move load onto new brokers"),
    EndpointSpec("remove_broker", "POST", ("brokerid", "dryrun", "goals"),
                 "decommission brokers"),
    EndpointSpec("demote_broker", "POST", ("brokerid", "dryrun"),
                 "move leadership off brokers"),
    EndpointSpec("fix_offline_replicas", "POST", ("dryrun", "goals"),
                 "relocate offline replicas"),
    EndpointSpec("topic_configuration", "POST",
                 ("topic", "replication_factor", "dryrun", "goals"),
                 "change topic replication factor"),
    EndpointSpec("stop_proposal_execution", "POST", (), "stop ongoing execution"),
    EndpointSpec("pause_sampling", "POST", ("reason",), "pause metric sampling"),
    EndpointSpec("resume_sampling", "POST", ("reason",), "resume metric sampling"),
    EndpointSpec("admin", "POST", ("enable_self_healing_for",
                                   "disable_self_healing_for",
                                   "concurrent_partition_movements_per_broker"),
                 "admin toggles"),
    EndpointSpec("review", "POST", ("approve", "discard", "reason"),
                 "approve/discard parked requests"),
]}


class Responder:
    """HTTP with 202 progress polling (client/Responder.py semantics)."""

    def __init__(self, base_url: str, poll_interval_s: float = 0.5,
                 max_wait_s: float = 600.0,
                 auth_header: Optional[str] = None):
        self.base = base_url.rstrip("/")
        self.poll_interval_s = poll_interval_s
        self.max_wait_s = max_wait_s
        self.auth_header = auth_header

    def request(self, spec: EndpointSpec, params: Dict[str, str]) -> Dict:
        qs = urllib.parse.urlencode({k: v for k, v in params.items() if v is not None})
        url = f"{self.base}/kafkacruisecontrol/{spec.name}"
        if qs:
            url += f"?{qs}"
        task_id: Optional[str] = None
        deadline = time.time() + self.max_wait_s
        while True:
            req = urllib.request.Request(url, method=spec.method)
            if self.auth_header:
                req.add_header("Authorization", self.auth_header)
            if task_id:
                req.add_header(USER_TASK_HEADER, task_id)
            try:
                with urllib.request.urlopen(req) as resp:
                    payload = json.loads(resp.read().decode())
                    status = resp.status
                    task_id = resp.headers.get(USER_TASK_HEADER, task_id)
            except urllib.error.HTTPError as e:
                return {"httpStatus": e.code,
                        **json.loads(e.read().decode() or "{}")}
            if status != 202 or time.time() > deadline:
                payload["httpStatus"] = status
                return payload
            time.sleep(self.poll_interval_s)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="tpucc-torch", description="Cruise Control client")
    parser.add_argument("-a", "--address", default="http://127.0.0.1:9090",
                        help="server base URL")
    parser.add_argument("--username", default=None,
                        help="HTTP Basic username (secured servers)")
    parser.add_argument("--password", default=None,
                        help="HTTP Basic password")
    parser.add_argument("--token", default=None,
                        help="Bearer token (JWT-secured servers)")
    sub = parser.add_subparsers(dest="command")
    sub.required = False

    propose = sub.add_parser("propose",
                             help="offline: compute proposals for a snapshot file")
    propose.add_argument("--snapshot", required=True,
                         help="path to a cluster snapshot (.json or .npz)")
    propose.add_argument("--goals", default=None,
                         help="comma-separated goal names")
    propose.add_argument("--verbose", action="store_true")
    propose.add_argument("--device", default="cuda",
                         help="torch device of the solve (default: cuda)")

    for spec in ENDPOINTS.values():
        p = sub.add_parser(spec.name, help=spec.help)
        for param in spec.params:
            meta = PARAMETERS[param]
            # argparse runs the validator and reports ValueError as a
            # clean usage error — no malformed value ever reaches the wire.
            p.add_argument(f"--{param}", default=None, type=meta.validator,
                           help=meta.help)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 0
    if args.command == "propose":
        # Imported lazily: torch startup is slow and irrelevant for --help.
        from cruise_control_tpu_torch.client.propose import run_propose
        return run_propose(args)
    spec = ENDPOINTS[args.command]
    params = {p: getattr(args, p, None) for p in spec.params}
    auth = None
    if args.token:
        auth = f"Bearer {args.token}"
    elif args.username is not None:
        import base64
        creds = f"{args.username}:{args.password or ''}".encode()
        auth = "Basic " + base64.b64encode(creds).decode()
    result = Responder(args.address, auth_header=auth).request(spec, params)
    print(json.dumps(result, indent=2))
    return 0 if result.get("httpStatus", 200) < 400 else 1


if __name__ == "__main__":
    sys.exit(main())
