"""One run of one cell: set-up, the measured window, the check, the result line.

The cell's kind of request (``kinds/<kind>.py``) supplies a ``Workload``: its
constructor is the set-up (inputs from the seed, the program's state, the
warm-up), ``request(i)`` is one timed request, ``check()`` judges the
window's answers with the reference after the program's state is freed, and
``end_to_end(records, window_s)`` gives the end-to-end metrics.
Per-layer metrics are read by ``metrics/<name>.py`` from the window's
records and, with ``--trace 1``, from a profile of a few more requests.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, TextIO, Tuple

from ccbench.harness import spec
from ccbench.harness import trace as tracing

#: Modules no run may hold once its window has closed (whole top-level names).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cruise_control_tpu")

#: Where the program's build and kernel caches live, inside the checkout.
CACHE_DIR = ".ccbench_cache"


@dataclass
class Context:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    err: TextIO = sys.stderr

    def log(self, *parts) -> None:
        print("ccbench:", *parts, file=self.err, flush=True)


@dataclass
class Checks:
    """The numbers a run compares, each with its limit, and what else the
    check found."""

    numbers: Dict[str, Tuple[float, float]]          # name -> (value, limit)
    notes: List[str] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return all(v <= lim for v, lim in self.numbers.values())


@dataclass
class RunRecord:
    """What a per-layer metric reads: the window's request records, the
    profile of the traced requests, and the cell's shapes."""

    requests: List[dict]
    trace: Optional[tracing.TraceSummary]
    shapes: dict


def synchronize(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def prepare_caches(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed place inside
    the checkout, so that only a checkout's first run builds."""
    base = Path(root) / CACHE_DIR
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    from cruise_control_tpu_torch.ops import aggregate
    aggregate.set_build_dir(base / "aggregate")


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def profile_requests(workload, first: int, n: int, device: str) -> tracing.TraceSummary:
    """Run ``n`` more requests under ``torch.profiler`` and read the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    synchronize(device)
    with profile(activities=activities) as prof:
        for k in range(n):
            with record_function(tracing.REQUEST_SPAN):
                workload.request(first + k)
        synchronize(device)
    ops, host, window, requests = tracing.from_profiler(prof)
    return tracing.summarize(ops, host, window, requests)


def _device_info(device: str, chips: int) -> dict:
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, out: TextIO = sys.stdout, err: TextIO = sys.stderr) -> int:
    """Run the cell once and print its result line; the exit code."""
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, err=err)
    prepare_caches(cell.root)
    kind = spec.kind_module(cell)
    readers = spec.readers(cell) if trace else {}

    workload = kind.Workload(ctx)
    synchronize(device)
    # What set-up made (the generated cluster's identity lists, the loaded
    # modules) is moved out of the cyclic collector's reach once, so that no
    # collection in the window walks the benchmark's own objects; what the
    # requests make is collected as a service's would be.
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - t_start
    ctx.log(f"set-up {setup_s:.3f} s")

    records: List[dict] = []
    failed = attempted = 0
    t0 = time.monotonic()
    while True:
        attempted += 1
        try:
            records.append(workload.request(attempted - 1))
        except Exception:                      # a request that fails is counted, not fatal
            failed += 1
            ctx.log(f"request {attempted - 1} failed:\n{traceback.format_exc(limit=8)}")
        if time.monotonic() - t0 >= seconds:
            break
    window_s = time.monotonic() - t0
    dev = _device_info(device, cell.chips)
    ctx.log(f"window {window_s:.3f} s, {attempted} requests, {failed} failed; walls "
            + " ".join(f"{r['wall_s']:.4f}" for r in records[:64]))
    ctx.log("rounds " + " ".join(str(r.get("rounds")) for r in records[:64]))

    summary = None
    card: dict = {}
    if trace:
        from ccbench.harness import roofline
        summary = profile_requests(workload, attempted, int(cell.traffic["trace_requests"]), device)
        card = roofline.card()
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s

    bad = forbidden_modules()
    if bad:
        print(f"ccbench: modules loaded that no run may load: {', '.join(bad)}", file=err)
        return 3

    checks = workload.check()
    for note in checks.notes:
        ctx.log(note)

    metrics: Dict[str, dict] = {}
    if trace:
        rec = RunRecord(requests=records, trace=summary, shapes=workload.shapes)
        for m in cell.per_layer:
            value = readers[m.name](rec)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        values = dict(workload.end_to_end(records, window_s), setup_s=setup_s)
        for m in cell.end_to_end:
            if values.get(m.name) is not None:
                metrics[m.name] = {"value": values[m.name], "unit": m.unit}

    correct = failed == 0 and bool(records) and checks.passed
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.top_device_ops(),
                               "idle_gaps": summary.top_idle()}
        least, bound = roofline.aggregate_bound(workload.shapes)
        result["trace"] = {"requests": summary.requests, "device_ops": summary.device_ops,
                           "idle_gaps": summary.gaps, "aggregate_bound": bound,
                           "aggregate_least_s": least, "peaks": roofline.PEAKS, **card}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.numbers.items()}
    print(json.dumps(result), file=out, flush=True)
    for name, (v, lim) in checks.numbers.items():
        print(f"check {name} = {v} (limit {lim})", file=err, flush=True)
    return 0


def process_start() -> float:
    """The process's start on the monotonic clock (from ``/proc``, to a
    clock tick; the current time where ``/proc`` cannot say)."""
    now_mono = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return now_mono
    return now_mono - max(age, 0.0)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 ccbench/run.py",
                                description="Run one cell of BENCHMARK.json on this machine's card.")
    p.add_argument("--workload", required=True, help="a workload name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="the seed of the inputs")
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics from a traced run")
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = process_start() if t_start is None else t_start
    args = parse_args(argv)
    root = spec.BENCH_DIR.parent
    cell = spec.load_cell(root, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("ccbench: torch.cuda.is_available() is false: no card, no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"ccbench: {cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}: no result", file=sys.stderr)
        return 2
    return run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
