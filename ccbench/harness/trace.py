"""Device time, idle share and idle gaps from a ``torch.profiler`` trace.

The trace is read in memory (nothing is written to disk): the device's
operations (kernels, copies, memsets) and the host's operations with their
start and end on the trace's one clock.  Busy time is the union of the
device operations' intervals inside the traced window, so overlapping
operations count once and the idle share is 1 - busy / window.  Each idle
gap is named by the innermost host operation that was running at its
middle, on the thread that ran the requests.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: The span the harness puts around every profiled request.
REQUEST_SPAN = "ccbench.request"

Interval = Tuple[int, int, str]          # (start ns, end ns, name)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    requests: int
    device_ops: int
    device_time: Dict[str, Tuple[float, int]]       # name -> (seconds, count)
    idle_by_host_op: Dict[str, float]               # host op -> idle seconds
    gaps: int = 0
    notes: List[str] = field(default_factory=list)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def top_device_ops(self, n: int = 10) -> List[list]:
        ranked = sorted(self.device_time.items(), key=lambda kv: -kv[1][0])
        return [[name, secs] for name, (secs, _) in ranked[:n]]

    def top_idle(self, n: int = 10) -> List[list]:
        ranked = sorted(self.idle_by_host_op.items(), key=lambda kv: -kv[1])
        return [[name, secs] for name, secs in ranked[:n]]

    def kernel_times(self, fragment: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``fragment``."""
        secs = count = 0
        for name, (s, c) in self.device_time.items():
            if fragment in name:
                secs += s
                count += c
        return secs, count


def union_busy(device: Sequence[Interval], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The merged busy intervals of ``device`` clipped to [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e, _ in device if e > lo and s < hi)
    merged: List[Tuple[int, int]] = []
    for s, e in spans:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _name(stack: List[Tuple[int, str]]) -> Optional[str]:
    """The innermost open host operation, with its enclosing operation
    where the innermost is a runtime call."""
    if not stack:
        return None
    inner = stack[-1][1]
    if inner.startswith("cuda") and len(stack) > 1:
        return f"{stack[-2][1]} > {inner}"
    return inner


def summarize(device: Sequence[Interval], host: Sequence[Interval],
              window: Tuple[int, int], requests: int) -> TraceSummary:
    """Busy and idle time of ``device`` inside ``window`` (ns), with each
    idle gap named by the ``host`` operation (one thread) running at its
    middle."""
    lo, hi = window
    busy = union_busy(device, lo, hi)
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    n_ops = 0
    for s, e, name in device:
        if e > lo and s < hi:
            acc = by_name[name]
            acc[0] += (e - s) / 1e9
            acc[1] += 1
            n_ops += 1
    host = sorted(host, key=lambda iv: (iv[0], -iv[1]))     # a parent before its child
    idle: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    # One sweep over the gaps in time order and the host operations in start
    # order, keeping the stack of operations open at each gap's middle
    # (operations of one thread nest).
    stack: List[Tuple[int, str]] = []
    j = gaps = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        gaps += 1
        t = (a + b) // 2
        while j < len(host) and host[j][0] <= t:
            s, e, name = host[j]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((e, name))
            j += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        idle[_name(stack) or "host outside any operation"] += (b - a) / 1e9
    return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9, requests=requests,
                        device_ops=n_ops,
                        device_time={k: (v[0], int(v[1])) for k, v in by_name.items()},
                        idle_by_host_op=dict(idle), gaps=gaps)


def from_profiler(prof) -> Tuple[List[Interval], List[Interval], Tuple[int, int], int]:
    """(device operations, host operations of the requests' thread, the
    window from the first request's start to the last one's end, the number
    of requests) of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device: List[Interval] = []
    host_all: List[Tuple[int, int, str, int]] = []
    spans: List[Tuple[int, int, int]] = []
    for ev in events:
        start = ev.start_ns()
        end = start + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((start, end, name))
            continue
        tid = ev.start_thread_id()
        if name == REQUEST_SPAN:
            spans.append((start, end, tid))
        host_all.append((start, end, name, tid))
    if not spans:
        raise RuntimeError(f"the trace holds no {REQUEST_SPAN!r} span")
    tid = spans[0][2]
    host = [(s, e, n) for s, e, n, t in host_all if t == tid]
    window = (min(s for s, _, _ in spans), max(e for _, e, _ in spans))
    return device, host, window, len(spans)
