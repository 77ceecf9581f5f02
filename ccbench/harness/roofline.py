"""Published peaks of one NVIDIA H100 and the least time of a kernel's work.

The roofline arithmetic of the repository's ``chip_smoke.py`` (``bound``),
kept here so that the yardstick stays fixed: the least time of a call is the
larger of its bytes over the memory bandwidth and its operations over the
arithmetic peak, each byte of input read once and each byte of output
written once.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

#: NVIDIA H100 SXM data sheet, dense rates, at its full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "fp32_ops_per_s": FP32_OPS_PER_S}


def channel_sums_bound(rows: int, channels: int, segments: int) -> Tuple[float, str]:
    """(seconds, 'bytes' | 'operations'): the least time of one per-broker
    channel sum: read rows x channels float32 values and rows int32 broker
    ids, write segments x channels float32 sums, and do rows x channels
    float32 adds."""
    t_bytes = (rows * channels * 4 + rows * 4 + segments * channels * 4) / HBM_BYTES_PER_S
    t_ops = rows * channels / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card() -> dict:
    """The card's name and power limit from ``nvidia-smi`` (every share of a
    peak is stated beside the limit the card ran at)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"not measured ({type(e).__name__})"}
    return {"nvidia_smi": out[0] if out else "not measured"}


#: The aggregate kernel's name in the trace (``ops/csrc/aggregate.cu``), and
#: the channels it sums a replica row: 4 loads, the replica and leader
#: counts, potential NW-out and leader bytes-in.
AGGREGATE_KERNEL = "channel_sums"
AGGREGATE_CHANNELS = 8


def aggregate_bound(shapes: dict) -> Tuple[float, str]:
    return channel_sums_bound(shapes["rows"], AGGREGATE_CHANNELS, shapes["brokers"])


def kernel_roofline_pct(run) -> Optional[float]:
    """100 x the aggregate kernel's least time a call at the cell's shape
    over its mean device time a launch in the trace; None without a trace
    or a launch."""
    if run.trace is None:
        return None
    secs, launches = run.trace.kernel_times(AGGREGATE_KERNEL)
    if not launches or secs <= 0:
        return None
    least, _ = aggregate_bound(run.shapes)
    return 100.0 * least / (secs / launches)
