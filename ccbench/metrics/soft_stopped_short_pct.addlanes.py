"""Percent of the soft goal solves of the traced what-if requests that
stopped with work left: the soft ``goal.<Goal>`` spans (``hard`` false)
whose ``end`` reads ``no_move`` (a round applied nothing), ``stalled`` (the
stall cutoff) or ``round_cap``, over all soft ``goal.<Goal>`` spans
(``analyzer/solver.py``'s loop condition).  A program whose goal spans carry
no ``end`` attribute gives none."""

from ccbench.harness.spans import roots, walk

SHORT = ("no_move", "stalled", "round_cap")


def read(run):
    trees = roots(run)
    if trees is None:
        return None
    ends = [s["attrs"]["end"] for t in trees for s in walk(t)
            if s["name"].startswith("goal.") and "end" in s.get("attrs", {})
            and not s["attrs"].get("hard", True)]
    if not ends:
        return None
    return 100.0 * sum(e in SHORT for e in ends) / len(ends)
