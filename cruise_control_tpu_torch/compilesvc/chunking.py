"""Lane-chunk planning: route an N-lane what-if batch through the lane
widths already run (the JAX package's ``compilesvc/chunking.py``, copied as
it is).

A what-if batch's lanes are independent, so a 64-lane request is the same as
four 16-lane requests.  The JAX package compiles one vmapped executable per
lane width, and a fresh wide one costs minutes; the port runs a block's lanes
one after another and compiles nothing, but it plans the same blocks, so the
two packages split a batch, pad it and guard its memory alike.  The planner
prefers widths already run ("compiled"), falls back to the smallest ladder
bucket wide enough for the remainder, and pads ragged tails (padding lanes
duplicate a real lane's masks; the runner discards their results).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence

from cruise_control_tpu_torch.compilesvc.buckets import ladder_bucket


@dataclass(frozen=True)
class LaneChunk:
    size: int     # executable lane width (a ladder bucket)
    start: int    # first real lane index covered by this chunk
    n_real: int   # real lanes in this chunk (<= size; rest is padding)

    @property
    def padded(self) -> bool:
        return self.n_real < self.size


def plan_lane_chunks(n_lanes: int, ladder: Sequence[int],
                     compiled: Iterable[int] = (),
                     max_chunk: int | None = None) -> List[LaneChunk]:
    """Chunks covering ``n_lanes`` lanes, preferring compiled widths.

    Selection per remaining span: the largest already-compiled ladder width
    that fits (reuse beats everything); otherwise the smallest ladder bucket
    >= the span, capped at ``max_chunk`` — one fresh compile at a canonical
    width the next request can reuse.  64 with {16} compiled -> 4x16; 70 ->
    4x16 + 1x8 (the 8-chunk carries 6 real lanes + 2 padding).
    """
    if n_lanes <= 0:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    ladder = sorted({int(s) for s in ladder if int(s) >= 1})
    if not ladder:
        raise ValueError("empty lane ladder")
    cap = max(ladder) if max_chunk is None else int(max_chunk)
    usable = [s for s in ladder if s <= cap] or [min(ladder)]
    compiled_usable = sorted({int(s) for s in compiled} & set(usable))

    chunks: List[LaneChunk] = []
    start = 0
    while start < n_lanes:
        remaining = n_lanes - start
        fit = [s for s in compiled_usable if s <= remaining]
        if fit:
            size = max(fit)
        else:
            # Nothing compiled fits whole; if a compiled width covers the
            # remainder with LESS padding than a fresh bucket would need to
            # compile, ride it — reuse beats a fresh compile outright.
            cover = [s for s in compiled_usable if s >= remaining]
            size = min(cover) if cover else min(
                ladder_bucket(remaining, usable), max(usable))
        n_real = min(size, remaining)
        chunks.append(LaneChunk(size=size, start=start, n_real=n_real))
        start += n_real
    return chunks


def plan_is_identity(chunks: Sequence[LaneChunk], n_lanes: int) -> bool:
    """True when the plan is a single unpadded chunk over all lanes — the
    caller can run its original unchunked path."""
    return (len(chunks) == 1 and chunks[0].size == n_lanes
            and chunks[0].n_real == n_lanes)
