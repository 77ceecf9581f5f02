"""OpenAPI spec assembled from the live endpoint surface.

Reference: ``cruise-control/src/yaml/base.yaml`` + ``yaml/endpoints/*.yaml``
+ ``yaml/responses/*.yaml`` — the reference ships a hand-maintained OpenAPI
tree and ``ResponseTest.java`` validates live responses against it.  Here
the spec is GENERATED from the same tables the server dispatches on
(``GET_ENDPOINTS``/``POST_ENDPOINTS``) and the same response schemas the
tests validate (``schemas.ENDPOINT_SCHEMAS``), so it cannot drift from the
implementation: a new endpoint without spec metadata fails the build.

The port serves the JAX package's REST contract, so this module is its copy,
descriptions included: ``tests/test_torch_servlet.py`` holds
:func:`build_spec` equal to the JAX package's, whose rendering is the
committed ``docs/openapi.yaml``.  ``render_yaml`` imports PyYAML lazily;
nothing on the server's path needs it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from cruise_control_tpu_torch.servlet import schemas
from cruise_control_tpu_torch.servlet.server import GET_ENDPOINTS, POST_ENDPOINTS

API_PREFIX = "/kafkacruisecontrol"

#: endpoint -> (summary, [(param, type, description)], minimum role)
ENDPOINT_INFO: Dict[str, Tuple[str, List[Tuple[str, str, str]], str]] = {
    "state": ("Monitor/Executor/Analyzer/AnomalyDetector state", [
        ("substates", "string", "comma list restricting the sections"),
        ("verbose", "boolean", "include per-window/selfheal detail"),
    ], "USER"),
    "load": ("Per-broker load statistics (ClusterModelStats)", [
        ("allow_capacity_estimation", "boolean",
         "permit estimated broker capacities"),
    ], "USER"),
    "partition_load": ("Partitions sorted by utilization", [
        ("entries", "integer", "max records returned"),
    ], "USER"),
    "kafka_cluster_state": ("Partition/replica placement as the cluster "
                            "reports it", [], "VIEWER"),
    "user_tasks": ("Active and completed async tasks", [], "VIEWER"),
    "review_board": ("Two-step-verification queue", [], "VIEWER"),
    "proposals": ("Cached/derived rebalance proposals (dryrun)", [
        ("goals", "string", "comma list of goal names"),
        ("kafka_assigner", "boolean", "assigner-mode goal pair"),
        ("excluded_topics", "string", "regex of topics to exclude"),
        ("deadline_ms", "number", "wall-clock solve budget; on expiry the "
         "best-so-far placement returns tagged partial"),
        ("explain", "boolean", "include per-move provenance (originating "
         "goal, solve round/id, relax/rounding/repair/greedy path, cost "
         "delta) and the provenancePaths histogram in the response"),
    ], "USER"),
    "bootstrap": ("Re-ingest historical samples", [
        ("start", "number", "range start ms"),
        ("end", "number", "range end ms"),
    ], "ADMIN"),
    "train": ("Fit the linear CPU estimation model", [
        ("start", "number", "range start ms"),
        ("end", "number", "range end ms"),
    ], "ADMIN"),
    "metrics": ("Sensor registry (Prometheus text, or JSON with "
                "?json=true)", [
        ("json", "boolean", "JSON snapshot instead of Prometheus text"),
    ], "VIEWER"),
    "solver_stats": ("Solver convergence observatory: flight-recorder ring "
                     "of per-solve per-goal round curves (applied moves, "
                     "violated count, stranded, goal metric, resync/stall "
                     "flags) with derived stats; per-lane early-exit rounds "
                     "for what-if batches; empty unless trace.solver.rounds", [
        ("limit", "integer", "return only the newest N records"),
    ], "VIEWER"),
    "metrics/history": ("Bounded per-sensor time-series rings sampled from "
                        "the metric registry by the obsvc history thread "
                        "(obs.history.*); the SLO burn-rate evaluator reads "
                        "the same rings", [
        ("sensor", "string", "fnmatch pattern restricting the sensors "
         "(glob, e.g. Memory.*)"),
        ("since_ms", "number", "drop samples older than this epoch ms"),
        ("limit", "integer", "max series returned (default 64, cap 1024); "
         "truncated=true in the body when matches were dropped"),
    ], "VIEWER"),
    "execution_progress": ("Execution observatory: the active batch's "
                           "per-task live state joined with each move's "
                           "provenance record (originating goal, solve "
                           "round/id, relax/rounding/repair/greedy path, "
                           "cost delta), per-broker inflight counts, the "
                           "EWMA moves-per-second throughput and batch ETA, "
                           "recent batch summaries and AIMD concurrency-"
                           "tuner events; 404 while "
                           "execution.observatory.enabled=false", [],
                           "VIEWER"),
    "model_quality": ("Fidelity observatory: the current model fingerprint "
                      "(generation, newest-valid-window age, valid-partition "
                      "ratio, per-kind extrapolated fractions, dead brokers, "
                      "capacity source) with its staleness verdict against "
                      "the anomaly.model.* thresholds, the per-window "
                      "quality ring (ingest→commit latency per close), "
                      "broker-liveness flaps and the last fetch summary; "
                      "404 while monitor.fidelity.enabled=false", [],
                      "VIEWER"),
    "memory": ("Device-memory observatory: per-subsystem live-bytes ledger, "
               "backend reconciliation, headroom-guard shrink/refusal "
               "counters, and per-executable compile-cost rows "
               "(flops, bytes-accessed, arg/out/temp bytes, derived peak); "
               "404 while memory.enabled=false", [], "VIEWER"),
    "compile_cache": ("Compile-service state: shape-bucket policy, compiled "
                      "lane widths, persistent XLA cache, warmup progress, "
                      "per-bucket compile/hit/miss counters", [], "VIEWER"),
    "trace": ("Recent root span trees (per-request / precompute / executor "
              "batch) and the per-phase time rollup; empty unless "
              "trace.enabled", [], "VIEWER"),
    "health": ("Component health probes (model freshness, admin backend "
               "circuit, accelerator liveness, crash-journal lag) with a "
               "ready/degraded/unhealthy rollup; 503 + Retry-After while "
               "unhealthy", [], "VIEWER"),
    "profile": ("Open a JAX device+host profile capture window for "
                "duration_s seconds on a background thread (202; poll "
                "GET /profile) writing a TensorBoard trace directory; "
                "409 while a window is already open", [
        ("duration_s", "number", "capture window seconds (default 2, "
         "max 600)"),
    ], "ADMIN"),
    "rebalance": ("Full-cluster rebalance", [
        ("dryrun", "boolean", "propose only (default true)"),
        ("goals", "string", "comma list of goal names"),
        ("kafka_assigner", "boolean", "assigner-mode goal pair"),
        ("rebalance_disk", "boolean", "balance between each broker's disks"),
        ("destination_broker_ids", "string", "comma list of allowed targets"),
        ("excluded_topics", "string", "regex of topics to exclude"),
        ("only_move_immigrant_replicas", "boolean",
         "restrict to immigrant replicas"),
        ("deadline_ms", "number", "wall-clock solve budget; on expiry the "
         "best-so-far placement returns tagged partial"),
        ("explain", "boolean", "include per-move provenance and the "
         "provenancePaths histogram in the response"),
    ], "ADMIN"),
    "add_broker": ("Move load onto new brokers", [
        ("brokerid", "string", "comma list of broker ids"),
        ("dryrun", "boolean", "propose only"),
        ("goals", "string", "comma list of goal names"),
        ("throttle_added_broker", "boolean", "apply replication throttle"),
        ("deadline_ms", "number", "wall-clock solve budget"),
        ("explain", "boolean", "include per-move provenance in the response"),
    ], "ADMIN"),
    "remove_broker": ("Decommission brokers", [
        ("brokerid", "string", "comma list of broker ids"),
        ("dryrun", "boolean", "propose only"),
        ("goals", "string", "comma list of goal names"),
        ("destination_broker_ids", "string", "comma list of allowed targets"),
        ("deadline_ms", "number", "wall-clock solve budget"),
        ("explain", "boolean", "include per-move provenance in the response"),
    ], "ADMIN"),
    "demote_broker": ("Shed leadership from brokers", [
        ("brokerid", "string", "comma list of broker ids"),
        ("dryrun", "boolean", "propose only"),
        ("deadline_ms", "number", "wall-clock solve budget"),
        ("explain", "boolean", "include per-move provenance in the response"),
    ], "ADMIN"),
    "fix_offline_replicas": ("Re-replicate offline replicas", [
        ("dryrun", "boolean", "propose only"),
        ("goals", "string", "comma list of goal names"),
        ("deadline_ms", "number", "wall-clock solve budget"),
        ("explain", "boolean", "include per-move provenance in the response"),
    ], "ADMIN"),
    "topic_configuration": ("Change topic replication factor", [
        ("topic", "string", "topic regex"),
        ("replication_factor", "integer", "target RF"),
        ("dryrun", "boolean", "propose only"),
        ("goals", "string", "comma list of goal names"),
        ("deadline_ms", "number", "wall-clock solve budget"),
        ("explain", "boolean", "include per-move provenance in the response"),
    ], "ADMIN"),
    "cancel_user_task": ("Abort an in-flight 202 operation: fires its solve "
                         "budget's cancellation token; the solve stops at "
                         "the next segment/goal boundary and the task "
                         "completes with its partial result (never "
                         "executed)", [
        ("user_task_id", "string",
         "task to cancel (or User-Task-ID header)"),
    ], "ADMIN"),
    "stop_proposal_execution": ("Abort the in-flight execution", [], "ADMIN"),
    "pause_sampling": ("Pause metric sampling", [
        ("reason", "string", "audit note"),
    ], "ADMIN"),
    "resume_sampling": ("Resume metric sampling", [
        ("reason", "string", "audit note"),
    ], "ADMIN"),
    "admin": ("Runtime admin toggles", [
        ("enable_self_healing_for", "string", "comma list of anomaly types"),
        ("disable_self_healing_for", "string", "comma list of anomaly types"),
        ("concurrent_partition_movements_per_broker", "integer",
         "executor concurrency cap"),
    ], "ADMIN"),
    "review": ("Approve/discard parked two-step requests", [
        ("approve", "string", "comma list of review ids"),
        ("discard", "string", "comma list of review ids"),
        ("reason", "string", "audit note"),
    ], "ADMIN"),
}

#: Routes served under BOTH verbs: ENDPOINT_INFO describes the POST
#: operation; this table supplies the GET operation (summary, params,
#: role, component name, response schema).
DUAL_GET_INFO: Dict[str, Tuple[str, List[Tuple[str, str, str]], str,
                               str, Dict]] = {
    "profile": ("Pollable profile-capture status: busy while a window is "
                "open, done + trace_dir once the last async capture landed",
                [], "VIEWER", "ProfileStatusResponse",
                schemas.PROFILE_STATUS_SCHEMA),
}

#: Schema components referenced by more than one endpoint get one shared
#: component name; everything else is named after its endpoint.
_SHARED = {
    id(schemas.OPERATION_RESULT_SCHEMA): "OptimizationResult",
    id(schemas.MESSAGE_SCHEMA): "Message",
    id(schemas.REVIEW_BOARD_SCHEMA): "ReviewBoard",
}

ERROR_SCHEMA = {
    "type": "object",
    "required": ["error"],
    "properties": {"error": {"type": "string"}},
}

PROGRESS_SCHEMA = {
    "type": "object",
    "required": ["progress"],
    "properties": {"progress": {"type": "array",
                                "items": {"type": "object"}}},
}


def _component_name(endpoint: str) -> str:
    schema = schemas.ENDPOINT_SCHEMAS[endpoint]
    # Slash endpoints (metrics/history) camel-case like underscores do.
    return _SHARED.get(id(schema)) or "".join(
        part.capitalize()
        for part in endpoint.replace("/", "_").split("_")) + "Response"


def build_spec() -> Dict:
    """The OpenAPI 3.0 document as a plain dict (YAML-ready)."""
    missing = (GET_ENDPOINTS | POST_ENDPOINTS) - set(ENDPOINT_INFO)
    if missing:
        raise AssertionError(
            f"endpoints without OpenAPI metadata: {sorted(missing)} — add "
            "them to servlet/openapi.py ENDPOINT_INFO")

    components: Dict[str, Dict] = {"Error": ERROR_SCHEMA,
                                   "AsyncProgress": PROGRESS_SCHEMA}
    paths: Dict[str, Dict] = {}
    for endpoint, (summary, params, role) in sorted(ENDPOINT_INFO.items()):
        # Dual-verb routes: ENDPOINT_INFO is the POST operation, the GET
        # operation comes from DUAL_GET_INFO below.
        if endpoint in POST_ENDPOINTS:
            method = "post"
        else:
            method = "get"
        cname = _component_name(endpoint)
        components.setdefault(cname, schemas.ENDPOINT_SCHEMAS[endpoint])
        ref = {"$ref": f"#/components/schemas/{cname}"}
        responses = {
            "200": {"description": "success",
                    "content": {"application/json": {"schema": ref}}},
            "400": {"description": "client error",
                    "content": {"application/json": {"schema":
                                {"$ref": "#/components/schemas/Error"}}}},
        }
        if endpoint == "health":
            responses["503"] = {
                "description": "service unhealthy; Retry-After header set",
                "content": {"application/json": {"schema": ref}}}
        if method == "post" or endpoint in ("proposals",):
            # Long-running operations return 202 + User-Task-ID until done
            # (async servlet machinery; poll with the same header).
            responses["202"] = {
                "description": "operation in progress; poll with the "
                               "returned User-Task-ID header",
                "content": {"application/json": {"schema":
                            {"$ref": "#/components/schemas/AsyncProgress"}}}}
        if endpoint == "memory":
            responses["404"] = {
                "description": "memory ledger disabled (memory.enabled="
                               "false)",
                "content": {"application/json": {"schema":
                            {"$ref": "#/components/schemas/Error"}}}}
        if endpoint == "execution_progress":
            responses["404"] = {
                "description": "execution observatory disabled "
                               "(execution.observatory.enabled=false)",
                "content": {"application/json": {"schema":
                            {"$ref": "#/components/schemas/Error"}}}}
        if endpoint == "model_quality":
            responses["404"] = {
                "description": "fidelity observatory disabled "
                               "(monitor.fidelity.enabled=false)",
                "content": {"application/json": {"schema":
                            {"$ref": "#/components/schemas/Error"}}}}
        if endpoint == "profile":
            responses["409"] = {
                "description": "a capture window is already open",
                "content": {"application/json": {"schema":
                            {"$ref": "#/components/schemas/Error"}}}}
        ops = {method: {
            "operationId": endpoint.replace("/", "_"),
            "summary": summary,
            "description": f"Minimum role: {role}.",
            "parameters": [
                {"name": n, "in": "query", "required": False,
                 "description": d, "schema": {"type": t}}
                for n, t, d in params
            ],
            "responses": responses,
        }}
        if endpoint in GET_ENDPOINTS and method == "post":
            gsummary, gparams, grole, gcname, gschema = \
                DUAL_GET_INFO[endpoint]
            components.setdefault(gcname, gschema)
            ops["get"] = {
                "operationId": f"{endpoint.replace('/', '_')}_status",
                "summary": gsummary,
                "description": f"Minimum role: {grole}.",
                "parameters": [
                    {"name": n, "in": "query", "required": False,
                     "description": d, "schema": {"type": t}}
                    for n, t, d in gparams
                ],
                "responses": {"200": {
                    "description": "success",
                    "content": {"application/json": {"schema":
                                {"$ref": f"#/components/schemas/"
                                         f"{gcname}"}}}}},
            }
        paths[f"{API_PREFIX}/{endpoint}"] = ops
    return {
        "openapi": "3.0.3",
        "info": {
            "title": "cruise-control-tpu REST API",
            "description": "Generated from servlet/openapi.py — do not edit "
                           "docs/openapi.yaml by hand; run "
                           "scripts/gen_openapi.py.",
            "version": "1",
        },
        "paths": paths,
        "components": {"schemas": components},
    }


def render_yaml() -> str:
    import yaml

    return yaml.safe_dump(build_spec(), sort_keys=False,
                          default_flow_style=False, width=79)
