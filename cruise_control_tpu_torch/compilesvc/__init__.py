"""Compile-plan subsystem (the JAX package's ``compilesvc/``).

Shape-bucket policy (``buckets``), lane-chunk planning (``chunking``), the
persistent kernel-build cache manager (``cache``), compile telemetry
(``telemetry``), the service facade tying them together (``service``) and
the startup warmup daemon (``warmup``).  The JAX package compiles one XLA
executable per goal family and shape bucket; the port compiles one CUDA
kernel library and runs eager torch, but it keeps the same discipline and
counts: pad to canonical buckets, route wide what-if batches through lane
widths already run, keep what was compiled across restarts, and warm the
configured goal stack before the first request.
"""

from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
from cruise_control_tpu_torch.compilesvc.cache import PersistentCompileCache
from cruise_control_tpu_torch.compilesvc.chunking import LaneChunk, plan_lane_chunks
from cruise_control_tpu_torch.compilesvc.service import (
    CompileService,
    compile_service,
    configure,
    set_compile_service,
)
from cruise_control_tpu_torch.compilesvc.telemetry import CompileTelemetry, telemetry
from cruise_control_tpu_torch.compilesvc.warmup import WarmupDaemon

__all__ = [
    "CompileService",
    "CompileTelemetry",
    "LaneChunk",
    "PersistentCompileCache",
    "ShapeBucketPolicy",
    "WarmupDaemon",
    "compile_service",
    "configure",
    "plan_lane_chunks",
    "set_compile_service",
    "telemetry",
]
