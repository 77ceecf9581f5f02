"""The program's span trees of the traced requests, for the per-layer
metrics whose source is ``program_span``.

While ``torch.profiler`` traces the requests, the program's tracer
(``cruise_control_tpu_torch.obsvc.tracer``) records a span tree for each
what-if batch, rooted at ``batch_optimize``, whether or not its tracing is
switched on.  A reader takes the trees of the traced requests: the last
``run.trace.requests`` roots of that name in the tracer's ring.  A program
whose tracer records no such root gives none, and neither does a trace that
holds no operation of the card: the readers then return None.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional

#: The root span of one what-if batch.
ROOT = "batch_optimize"


def roots(run) -> Optional[List[dict]]:
    """The span trees of the traced requests, or None."""
    if run.trace is None or not run.trace.device_ops:
        return None
    from cruise_control_tpu_torch.obsvc.tracer import tracer
    found = [t for t in tracer().traces() if t["name"] == ROOT]
    return found[-run.trace.requests:] or None


def walk(tree: dict) -> Iterator[dict]:
    yield tree
    for child in tree.get("children", ()):
        yield from walk(child)


def walls_ms(trees: Iterable[dict], names: Iterable[str]) -> List[float]:
    """The wall of every closed span named in ``names``, in milliseconds."""
    names = set(names)
    return [s["wall_ms"] for t in trees for s in walk(t)
            if s["name"] in names and s["wall_ms"] is not None]


def share_pct(run, names: Iterable[str]) -> Optional[float]:
    """100 × the summed walls of the spans named in ``names`` over the
    summed walls of the roots, or None."""
    trees = roots(run)
    if trees is None:
        return None
    whole = sum(walls_ms(trees, [ROOT]))
    if not whole:
        return None
    return 100.0 * sum(walls_ms(trees, names)) / whole
