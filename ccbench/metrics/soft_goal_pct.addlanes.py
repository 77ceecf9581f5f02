"""Percent of the traced what-if requests' ``batch_optimize`` wall spent in
the solves of soft goals: the ``goal.<Goal>`` spans whose ``hard``
attribute is false (``analyzer/optimizer.py``'s lane runner, around
``analyzer/solver.py``'s solve).  A program whose goal spans carry no
``hard`` attribute gives none."""

from ccbench.harness.spans import ROOT, roots, walk


def read(run):
    trees = roots(run)
    if trees is None:
        return None
    goals = [s for t in trees for s in walk(t)
             if s["name"].startswith("goal.") and "hard" in s.get("attrs", {})]
    whole = sum(t["wall_ms"] or 0.0 for t in trees if t["name"] == ROOT)
    if not goals or not whole:
        return None
    return 100.0 * sum(s["wall_ms"] or 0.0 for s in goals if not s["attrs"]["hard"]) / whole
