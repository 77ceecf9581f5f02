"""Response schemas + a minimal JSON-schema checker.

Reference: ``cruise-control/src/yaml/{endpoints,responses}/**`` — OpenAPI
response schemas — and the ``ResponseTest`` pattern that validates live
endpoint payloads against them in CI.  The subset of JSON Schema used by
those files (type/properties/required/items/enum) is implemented here with
the stdlib so schema checks can run inside the server tests (and optionally
at serving time for debugging).
"""

from __future__ import annotations

from typing import Any, Dict, List

from cruise_control_tpu_torch.common.exceptions import CruiseControlError


class SchemaViolation(CruiseControlError):
    pass


_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "null": type(None),
}


def _type_ok(value: Any, expected: str) -> bool:
    if expected == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if expected == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    return isinstance(value, _TYPES[expected])


def validate(value: Any, schema: Dict, path: str = "$") -> None:
    """Raise SchemaViolation on the first mismatch."""
    expected = schema.get("type")
    if expected is not None:
        types = expected if isinstance(expected, list) else [expected]
        if not any(_type_ok(value, t) for t in types):
            raise SchemaViolation(
                f"{path}: expected {expected}, got {type(value).__name__}")
    if "enum" in schema and value not in schema["enum"]:
        raise SchemaViolation(f"{path}: {value!r} not in {schema['enum']}")
    if isinstance(value, dict):
        for key in schema.get("required", []):
            if key not in value:
                raise SchemaViolation(f"{path}: missing required key {key!r}")
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key in value:
                validate(value[key], sub, f"{path}.{key}")
        extra = schema.get("additionalProperties")
        if isinstance(extra, dict):
            for key, v in value.items():
                if key not in props:
                    validate(v, extra, f"{path}.{key}")
    if isinstance(value, list) and "items" in schema:
        for i, item in enumerate(value):
            validate(item, schema["items"], f"{path}[{i}]")


# ------------------------------------------------------- endpoint schemas

STATE_SCHEMA = {
    "type": "object",
    "required": ["MonitorState", "ExecutorState", "AnalyzerState",
                 "AnomalyDetectorState", "version"],
    "properties": {
        "MonitorState": {
            "type": "object",
            "required": ["state", "numValidWindows",
                         "monitoredPartitionsPercentage"],
            "properties": {
                "state": {"type": "string"},
                "numValidWindows": {"type": "integer"},
                "monitoredPartitionsPercentage": {"type": "number"},
            },
        },
        "ExecutorState": {
            "type": "object",
            "required": ["state"],
            "properties": {"state": {"type": "string"}},
        },
        "AnalyzerState": {"type": "object"},
        "AnomalyDetectorState": {"type": "object"},
        "version": {"type": "integer"},
    },
}

_STAT_ROW = {
    "type": "object",
    "required": ["cpu", "networkInbound", "networkOutbound", "disk"],
    "properties": {k: {"type": "number"} for k in
                   ("cpu", "networkInbound", "networkOutbound", "disk",
                    "replicas")},
}

LOAD_SCHEMA = {
    "type": "object",
    "required": ["statistics", "numBrokers", "numReplicas", "numLeaders",
                 "version"],
    "properties": {
        "statistics": {
            "type": "object",
            "required": ["AVG", "MAX", "MIN", "STD"],
            "properties": {k: _STAT_ROW for k in ("AVG", "MAX", "MIN", "STD")},
        },
        "numBrokers": {"type": "integer"},
        "numReplicas": {"type": "integer"},
        "numLeaders": {"type": "integer"},
        "version": {"type": "integer"},
    },
}

PARTITION_LOAD_SCHEMA = {
    "type": "object",
    "required": ["records", "version"],
    "properties": {
        "records": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["topic", "partition", "cpu", "networkInbound",
                             "networkOutbound", "disk"],
                "properties": {
                    "topic": {"type": "string"},
                    "partition": {"type": "integer"},
                    "cpu": {"type": "number"},
                    "networkInbound": {"type": "number"},
                    "networkOutbound": {"type": "number"},
                    "disk": {"type": "number"},
                },
            },
        },
    },
}

OPERATION_RESULT_SCHEMA = {
    "type": "object",
    "required": ["dryrun", "executed", "result", "version"],
    "properties": {
        "dryrun": {"type": "boolean"},
        "executed": {"type": "boolean"},
        "partial": {"type": "boolean"},
        "result": {
            "type": "object",
            "required": ["numLeaderMovements", "violatedGoalsBefore",
                         "violatedGoalsAfter", "goals"],
            "properties": {
                "numLeaderMovements": {"type": "integer"},
                "violatedGoalsBefore": {"type": "array",
                                        "items": {"type": "string"}},
                "violatedGoalsAfter": {"type": "array",
                                       "items": {"type": "string"}},
                "balancednessScore": {"type": "number"},
                "goals": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["goal", "violatedBrokersBefore",
                                     "violatedBrokersAfter"],
                    },
                },
                # ?explain=true only: per-move provenance and the
                # relax/rounding/repair/greedy path histogram.
                "proposals": {"type": "array", "items": {"type": "object"}},
                "provenancePaths": {
                    "type": "object",
                    "additionalProperties": {"type": "integer"},
                },
            },
        },
    },
}

USER_TASKS_SCHEMA = {
    "type": "object",
    "required": ["userTasks", "version"],
    "properties": {
        "userTasks": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["UserTaskId", "Status", "RequestURL", "StartMs"],
                "properties": {
                    "UserTaskId": {"type": "string"},
                    "Status": {"type": "string"},
                    "RequestURL": {"type": "string"},
                    "StartMs": {"type": "integer"},
                },
            },
        },
    },
}

KAFKA_CLUSTER_STATE_SCHEMA = {
    "type": "object",
    "required": ["KafkaBrokerState", "KafkaPartitionState", "version"],
    "properties": {
        "KafkaBrokerState": {"type": "object"},
        "KafkaPartitionState": {"type": "object"},
    },
}

#: Plain acknowledgement bodies (bootstrap, sampling toggles, stop).
MESSAGE_SCHEMA = {
    "type": "object",
    "required": ["message"],
    "properties": {"message": {"type": "string"}},
}

TRAIN_SCHEMA = {
    "type": "object",
    "required": ["message", "coefficients"],
    "properties": {
        "message": {"type": "string"},
        "coefficients": {"type": ["array", "null"],
                         "items": {"type": "number"}},
    },
}

_REVIEW_ROW = {
    "type": "object",
    "required": ["Id", "EndPoint", "Status"],
    "properties": {
        "Id": {"type": "integer"},
        "EndPoint": {"type": "string"},
        "Query": {"type": "string"},
        "Submitter": {"type": "string"},
        "Status": {"type": "string"},
        "Reason": {"type": "string"},
    },
}

REVIEW_BOARD_SCHEMA = {
    "type": "object",
    "required": ["RequestInfo"],
    "properties": {"RequestInfo": {"type": "array", "items": _REVIEW_ROW}},
}

ADMIN_SCHEMA = {
    "type": "object",
    "properties": {
        "selfHealingEnabledBefore": {"type": "object"},
        "concurrency": {"type": "integer"},
        "message": {"type": "string"},
    },
}

METRICS_JSON_SCHEMA = {
    "type": "object",
    "required": ["sensors"],
    "properties": {"sensors": {"type": "object"}},
}

COMPILE_CACHE_SCHEMA = {
    "type": "object",
    "required": ["policy", "telemetry"],
    "properties": {
        "policy": {"type": "object"},
        "chunking_enabled": {"type": "boolean"},
        "warmup_enabled": {"type": "boolean"},
        "compiled_lane_widths": {"type": "object"},
        "persistent_cache": {"type": "object"},
        "telemetry": {"type": "object"},
        "warmup": {"type": ["object", "null"]},
    },
}

_SPAN_SCHEMA = {
    "type": "object",
    "required": ["span_id", "name", "start_ms"],
    "properties": {
        "span_id": {"type": "integer"},
        "parent_id": {"type": ["integer", "null"]},
        "name": {"type": "string"},
        "start_ms": {"type": "number"},
        # null while the span (or a late-finishing child) is in progress.
        "wall_ms": {"type": ["number", "null"]},
        "attrs": {"type": "object"},
        "children": {"type": "array", "items": {"type": "object"}},
    },
}

TRACE_SCHEMA = {
    "type": "object",
    "required": ["enabled", "traces", "rollup"],
    "properties": {
        "enabled": {"type": "boolean"},
        "traces": {"type": "array", "items": _SPAN_SCHEMA},
        "rollup": {
            "type": "object",
            "additionalProperties": {
                "type": "object",
                "required": ["count", "total_ms", "mean_ms"],
                "properties": {
                    "count": {"type": "integer"},
                    "total_ms": {"type": "number"},
                    "mean_ms": {"type": "number"},
                },
            },
        },
    },
}

PROFILE_SCHEMA = {
    "type": "object",
    "required": ["message", "status", "trace_dir", "duration_s"],
    "properties": {
        "message": {"type": "string"},
        "status": {"type": "string"},
        "trace_dir": {"type": "string"},
        "duration_s": {"type": "number"},
    },
}

# GET /profile — pollable async-capture state.
PROFILE_STATUS_SCHEMA = {
    "type": "object",
    "required": ["busy", "done"],
    "properties": {
        "busy": {"type": "boolean"},
        "done": {"type": "boolean"},
        "trace_dir": {"type": ["string", "null"]},
        "duration_s": {"type": "number"},
        "started_ms": {"type": "integer"},
        "error": {"type": ["string", "null"]},
    },
}

MEMORY_SCHEMA = {
    "type": "object",
    "required": ["enabled", "analysisMode", "liveBytes", "subsystems",
                 "guard", "reconcile", "costs"],
    "properties": {
        "enabled": {"type": "boolean"},
        "analysisMode": {"type": "string"},
        "headroomFraction": {"type": "number"},
        "deviceBudgetBytes": {"type": ["integer", "null"]},
        "liveBytes": {"type": "integer"},
        # subsystem -> {liveBytes, peakBytes, pins}
        "subsystems": {
            "type": "object",
            "additionalProperties": {
                "type": "object",
                "properties": {"liveBytes": {"type": "integer"},
                               "peakBytes": {"type": "integer"},
                               "pins": {"type": "integer"}},
            },
        },
        "events": {"type": "object",
                   "additionalProperties": {"type": "integer"}},
        "guard": {"type": "object",
                  "properties": {"shrinks": {"type": "integer"},
                                 "refusals": {"type": "integer"}}},
        "reconcile": {"type": "object"},
        # bucket label -> compile-cost row (flops, bytes_accessed,
        # arg/out/temp/generated bytes, derived peak_bytes)
        "costs": {"type": "object",
                  "additionalProperties": {"type": "object"}},
    },
}

_CURVE_ROW_SCHEMA = {
    "type": "object",
    "required": ["applied", "violated", "stranded", "metric"],
    "properties": {
        "applied": {"type": "integer"},
        "violated": {"type": "integer"},
        "stranded": {"type": "integer"},
        "metric": {"type": "number"},
        "resync": {"type": "boolean"},
        "stall": {"type": "integer"},
    },
}

_SOLVE_RECORD_SCHEMA = {
    "type": "object",
    "required": ["id", "timestampMs", "kind"],
    "properties": {
        "id": {"type": "integer"},
        "timestampMs": {"type": "number"},
        "kind": {"type": "string", "enum": ["propose", "what_if"]},
        "goals": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["goal", "rounds", "moves"],
                "properties": {
                    "goal": {"type": "string"},
                    "rounds": {"type": "integer"},
                    "moves": {"type": "integer"},
                    "stats": {"type": "object"},
                    "curve": {"type": "array", "items": _CURVE_ROW_SCHEMA},
                },
            },
        },
        # what_if records: per-lane early-exit rounds instead of curves.
        "lanes": {"type": "integer"},
        "warmStart": {"type": "boolean"},
        "laneRounds": {"type": "object"},
    },
}

SOLVER_STATS_SCHEMA = {
    "type": "object",
    "required": ["enabled", "records", "version"],
    "properties": {
        "enabled": {"type": "boolean"},
        "recorded": {"type": "integer"},
        "ringSize": {"type": "integer"},
        "records": {"type": "array", "items": _SOLVE_RECORD_SCHEMA},
    },
}

METRICS_HISTORY_SCHEMA = {
    "type": "object",
    "required": ["enabled", "intervalMs", "ringSize", "series", "version"],
    "properties": {
        "enabled": {"type": "boolean"},
        "intervalMs": {"type": "number"},
        "ringSize": {"type": "integer"},
        "samples": {"type": "integer"},
        # True when the series cap (limit param) dropped matching rings.
        "truncated": {"type": "boolean"},
        # sensor name -> [[ts_ms, value], ...] oldest first
        "series": {
            "type": "object",
            "additionalProperties": {
                "type": "array",
                "items": {"type": "array", "items": {"type": "number"}},
            },
        },
    },
}

_PROVENANCE_SCHEMA = {
    # Move provenance: which goal's solve emitted the move and through
    # which pipeline path it reached the final placement.
    "type": ["object", "null"],
    "properties": {
        "goal": {"type": "string"},
        "round": {"type": "integer"},
        "solveId": {"type": ["integer", "null"]},
        "path": {"type": "string",
                 "enum": ["relax", "rounding", "repair", "greedy"]},
        "costDelta": {"type": "number"},
    },
}

EXECUTION_PROGRESS_SCHEMA = {
    "type": "object",
    "required": ["enabled", "active", "version"],
    "properties": {
        "enabled": {"type": "boolean"},
        "active": {"type": "boolean"},
        "batch": {
            "type": "object",
            "properties": {
                "executionId": {"type": "integer"},
                "startedMs": {"type": "number"},
                "principal": {"type": ["string", "null"]},
                "requestId": {"type": ["string", "null"]},
                "total": {"type": "integer"},
                "pathHistogram": {"type": "object",
                                  "additionalProperties": {"type": "integer"}},
                "tunerIncreases": {"type": "integer"},
                "tunerDecreases": {"type": "integer"},
            },
        },
        "tasks": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["topicPartition", "type", "state"],
                "properties": {
                    "topicPartition": {"type": "string"},
                    "type": {"type": "string"},
                    "state": {"type": "string"},
                    "provenance": _PROVENANCE_SCHEMA,
                },
            },
        },
        "throughput": {
            "type": "object",
            "properties": {
                "completed": {"type": "integer"},
                "remaining": {"type": "integer"},
                "inflight": {"type": "integer"},
                "secondsPerMove": {"type": ["number", "null"]},
                "movesPerSecond": {"type": ["number", "null"]},
                "etaSeconds": {"type": ["number", "null"]},
            },
        },
        "inflightPerBroker": {"type": "object",
                              "additionalProperties": {"type": "integer"}},
        "tunerEvents": {"type": "array", "items": {"type": "object"}},
        "recentBatches": {"type": "array", "items": {"type": "object"}},
    },
}

_FINGERPRINT_SCHEMA = {
    # Model fingerprint: the quality of the monitor snapshot a solve (or
    # the current moment) sees — stamped onto proposals at solve time.
    "type": ["object", "null"],
    "properties": {
        "generation": {"type": "integer"},
        "windowEndMs": {"type": ["number", "null"]},
        "ageMs": {"type": ["number", "null"]},
        "validWindows": {"type": "integer"},
        "validPartitionRatio": {"type": "number"},
        "extrapolatedFraction": {
            "type": "object",
            "properties": {k: {"type": "number"}
                           for k in ("AVG_AVAILABLE", "AVG_ADJACENT",
                                     "FORECAST")},
        },
        "deadBrokers": {"type": "array", "items": {"type": "integer"}},
        "capacitySource": {"type": "string"},
        "kind": {"type": "string", "enum": ["freeze", "delta"]},
        "frozenAtMs": {"type": "number"},
    },
}

MODEL_QUALITY_SCHEMA = {
    "type": "object",
    "required": ["enabled", "fingerprint", "stale", "thresholds",
                 "windowQuality"],
    "properties": {
        "enabled": {"type": "boolean"},
        "fingerprint": _FINGERPRINT_SCHEMA,
        "stale": {"type": ["string", "null"]},
        "thresholds": {
            "type": "object",
            "properties": {
                "minValidPartitionRatio": {"type": "number"},
                "maxAgeMs": {"type": "integer"},
            },
        },
        "windowQuality": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["window", "windowEndMs", "closedAtMs",
                             "ingestCommitMs"],
                "properties": {
                    "window": {"type": "integer"},
                    "windowEndMs": {"type": "number"},
                    "closedAtMs": {"type": "number"},
                    "ingestCommitMs": {"type": "number"},
                },
            },
        },
        "recentFingerprints": {"type": "array",
                               "items": _FINGERPRINT_SCHEMA},
        "livenessFlaps": {
            "type": "array",
            "items": {
                "type": "object",
                "properties": {
                    "broker": {"type": "integer"},
                    "alive": {"type": "boolean"},
                    "atMs": {"type": "number"},
                },
            },
        },
        "lastFetch": {
            "type": "object",
            "properties": {
                "partitionSamples": {"type": "integer"},
                "brokerSamples": {"type": "integer"},
                "atMs": {"type": ["number", "null"]},
            },
        },
    },
}

_HEALTH_PROBE_SCHEMA = {
    "type": "object",
    "required": ["status"],
    "properties": {
        "status": {"type": "string",
                   "enum": ["ready", "degraded", "unhealthy"]},
        "reason": {"type": "string"},
    },
}

HEALTH_SCHEMA = {
    "type": "object",
    "required": ["status", "probes"],
    "properties": {
        "status": {"type": "string",
                   "enum": ["ready", "degraded", "unhealthy"]},
        "probes": {
            "type": "object",
            "required": ["model", "backend", "device", "journal"],
            "properties": {k: _HEALTH_PROBE_SCHEMA
                           for k in ("model", "backend", "device", "journal")},
        },
    },
}

ENDPOINT_SCHEMAS: Dict[str, Dict] = {
    "state": STATE_SCHEMA,
    "load": LOAD_SCHEMA,
    "partition_load": PARTITION_LOAD_SCHEMA,
    "proposals": OPERATION_RESULT_SCHEMA,
    "rebalance": OPERATION_RESULT_SCHEMA,
    "add_broker": OPERATION_RESULT_SCHEMA,
    "remove_broker": OPERATION_RESULT_SCHEMA,
    "demote_broker": OPERATION_RESULT_SCHEMA,
    "fix_offline_replicas": OPERATION_RESULT_SCHEMA,
    "topic_configuration": OPERATION_RESULT_SCHEMA,
    "user_tasks": USER_TASKS_SCHEMA,
    "kafka_cluster_state": KAFKA_CLUSTER_STATE_SCHEMA,
    "bootstrap": MESSAGE_SCHEMA,
    "train": TRAIN_SCHEMA,
    "cancel_user_task": MESSAGE_SCHEMA,
    "stop_proposal_execution": MESSAGE_SCHEMA,
    "pause_sampling": MESSAGE_SCHEMA,
    "resume_sampling": MESSAGE_SCHEMA,
    "review_board": REVIEW_BOARD_SCHEMA,
    "review": REVIEW_BOARD_SCHEMA,
    "admin": ADMIN_SCHEMA,
    "metrics": METRICS_JSON_SCHEMA,
    "metrics/history": METRICS_HISTORY_SCHEMA,
    "solver_stats": SOLVER_STATS_SCHEMA,
    "compile_cache": COMPILE_CACHE_SCHEMA,
    "trace": TRACE_SCHEMA,
    "profile": PROFILE_SCHEMA,
    "memory": MEMORY_SCHEMA,
    "execution_progress": EXECUTION_PROGRESS_SCHEMA,
    "model_quality": MODEL_QUALITY_SCHEMA,
    "health": HEALTH_SCHEMA,
}
