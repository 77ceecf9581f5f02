"""CompileService: the facade over shape buckets, lane chunks, the persistent
kernel-build cache and compile telemetry (the JAX package's
``compilesvc/service.py``).

One object ties the subsystem together: the shape-bucket policy decides the
canonical padded shapes (R, B, C, L), the lane-chunk planner routes what-if
batches through the lane widths already run, the persistent cache manager
keeps the aggregate kernel's library across process restarts, and telemetry
counts every hit/miss/compile.

- ``facade.CruiseControl`` asks ``pad_targets`` when freezing snapshots;
- ``analyzer.optimizer`` asks ``plan_lanes``/``note_lanes_compiled`` around
  the lane runner;
- ``main.build_app`` calls ``configure(config)`` once at startup and the
  warmup daemon runs the configured goal stack's bucket set;
- ``servlet`` renders ``snapshot()`` as the ``compile_cache`` admin view.

A process-wide instance (``compile_service()``) exists so code deep in the
solver does not need plumbing; ``set_compile_service`` swaps it in tests.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
from cruise_control_tpu_torch.compilesvc.cache import PersistentCompileCache
from cruise_control_tpu_torch.compilesvc.chunking import LaneChunk, plan_lane_chunks
from cruise_control_tpu_torch.compilesvc.telemetry import CompileTelemetry, telemetry


def goal_stack_hash(goal_names: Iterable[str]) -> str:
    """Order-sensitive short hash of a goal stack — part of the persistent
    cache key and of the compiled-lane-width registry key."""
    raw = "\x1f".join(str(n) for n in goal_names)
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


class CompileService:
    def __init__(self,
                 policy: Optional[ShapeBucketPolicy] = None,
                 cache: Optional[PersistentCompileCache] = None,
                 compile_telemetry: Optional[CompileTelemetry] = None,
                 chunking_enabled: bool = True,
                 warmup_enabled: bool = False,
                 warmup_lanes: Union[int, Sequence[int]] = 4):
        self.policy = policy or ShapeBucketPolicy()
        self.cache = cache or PersistentCompileCache()
        self.telemetry = compile_telemetry or telemetry()
        self.chunking_enabled = bool(chunking_enabled)
        self.warmup_enabled = bool(warmup_enabled)
        # ``warmup_lanes`` is a LADDER: every width in it gets its own warm
        # what-if task, so chunked wide batches find each block width already
        # compiled.  A scalar is accepted for back-compat (one-rung ladder).
        if isinstance(warmup_lanes, (int, float, str)):
            rungs = [int(warmup_lanes)]
        else:
            rungs = [int(w) for w in warmup_lanes]
        self.warmup_lane_ladder: Tuple[int, ...] = tuple(
            sorted({max(1, w) for w in rungs})) or (1,)
        self._lock = threading.Lock()
        # (stack_hash, R_padded, B_padded, C) -> lane widths already compiled
        self._compiled_lanes: Dict[Tuple, Set[int]] = {}

    @property
    def warmup_lanes(self) -> int:
        """Widest ladder rung — the historical scalar accessor."""
        return self.warmup_lane_ladder[-1]

    # ------------------------------------------------------------- shapes

    def pad_targets(self, n_replicas: int, n_brokers: int) -> Tuple[int, int]:
        return self.policy.pad_targets(n_replicas, n_brokers)

    def bucket_label(self, num_replicas_padded: int, num_candidates: int,
                     lanes: Optional[int] = None) -> str:
        return self.policy.bucket_label(num_replicas_padded, num_candidates,
                                        lanes)

    # ------------------------------------------------------ lane chunking

    def lane_key(self, goal_names: Iterable[str], num_replicas_padded: int,
                 num_brokers_padded: int, num_candidates: int) -> Tuple:
        return (goal_stack_hash(goal_names), int(num_replicas_padded),
                int(num_brokers_padded), int(num_candidates))

    def compiled_lane_widths(self, key: Tuple) -> Set[int]:
        with self._lock:
            return set(self._compiled_lanes.get(key, ()))

    def note_lanes_compiled(self, key: Tuple, width: int) -> None:
        with self._lock:
            self._compiled_lanes.setdefault(key, set()).add(int(width))

    def plan_lanes(self, n_lanes: int, key: Optional[Tuple] = None
                   ) -> List[LaneChunk]:
        """Chunk plan for an ``n_lanes``-wide what-if batch.  With chunking
        disabled the plan is the identity (one chunk at the native width)."""
        if not self.chunking_enabled:
            return [LaneChunk(size=int(n_lanes), start=0,
                              n_real=int(n_lanes))]
        compiled = self.compiled_lane_widths(key) if key is not None else set()
        return plan_lane_chunks(
            n_lanes, self.policy.lane_ladder, compiled=compiled,
            max_chunk=self.policy.max_lane_bucket)

    # ------------------------------------------------------------- admin

    def snapshot(self) -> Dict:
        with self._lock:
            lane_registry = {
                f"{k[0]}/R{k[1]}-B{k[2]}-C{k[3]}": sorted(v)
                for k, v in sorted(self._compiled_lanes.items())}
        return {
            "policy": {
                "replica_floor": self.policy.replica_floor,
                "broker_floor": self.policy.broker_floor,
                "growth": self.policy.growth,
                "lane_ladder": list(self.policy.lane_ladder),
                "max_lane_bucket": self.policy.max_lane_bucket,
            },
            "chunking_enabled": self.chunking_enabled,
            "warmup_enabled": self.warmup_enabled,
            "warmup_lane_ladder": list(self.warmup_lane_ladder),
            "compiled_lane_widths": lane_registry,
            "persistent_cache": self.cache.stats(),
            "telemetry": self.telemetry.snapshot(),
        }


_GLOBAL: Optional[CompileService] = None
_GLOBAL_LOCK = threading.Lock()


def compile_service() -> CompileService:
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = CompileService()
    return _GLOBAL


def set_compile_service(svc: Optional[CompileService]) -> None:
    """Swap the process-wide service (tests; ``None`` resets to default)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = svc


def _parse_lanes(raw) -> List[int]:
    """``compile.warmup.lanes`` ladder: LIST config yields List[str]; legacy
    scalar ints (and bare "8" strings) still mean a one-rung ladder."""
    if isinstance(raw, (list, tuple)):
        return [int(str(w).strip()) for w in raw if str(w).strip()] or [4]
    return [int(w) for w in str(raw).split(",") if w.strip()] or [4]


def configure(config) -> CompileService:
    """Build the process-wide service from ``compile.*`` config keys and
    install it.  ``config`` is a ``CruiseControlConfig`` (anything with
    ``.get``)."""
    def _get(key, default):
        try:
            v = config.get(key)
        except Exception:   # noqa: BLE001 — missing key -> default
            return default
        return default if v is None else v

    policy = ShapeBucketPolicy(
        replica_floor=int(_get("compile.replica.pad.floor", 64)),
        broker_floor=int(_get("compile.broker.pad.floor", 8)),
        growth=float(_get("compile.bucket.growth", 2.0)),
        max_lane_bucket=int(_get("compile.max.lane.bucket", 16)),
    )
    # CC_TPU_PERSIST_CACHE turns the cache on where the config key is unset
    # (a CPU activation still stays off: nothing is compiled there).  An
    # explicit config value wins; a value other than 1/true/yes is the root.
    import os
    persist_env = os.environ.get("CC_TPU_PERSIST_CACHE", "")
    explicit = hasattr(config, "originals") and \
        "compile.persistent.cache.enabled" in getattr(config, "originals", {})
    enabled = bool(_get("compile.persistent.cache.enabled", False))
    root = str(_get("compile.persistent.cache.path", "")) or None
    if persist_env and not explicit:
        enabled = True
        if persist_env.lower() not in ("1", "true", "yes") and root is None:
            root = persist_env
    cache = PersistentCompileCache(
        root=root,
        max_bytes=int(_get("compile.persistent.cache.max.bytes", 4 << 30)),
        enabled=enabled,
    )
    svc = CompileService(
        policy=policy,
        cache=cache,
        chunking_enabled=bool(_get("compile.lane.chunking.enabled", True)),
        warmup_enabled=bool(_get("compile.warmup.enabled", True)),
        warmup_lanes=_parse_lanes(_get("compile.warmup.lanes", [4])),
    )
    set_compile_service(svc)
    return svc
