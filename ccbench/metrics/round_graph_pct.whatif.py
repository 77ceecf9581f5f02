"""Percent of the solver rounds of the traced what-if requests that replayed
their round's CUDA graph: the ``solve.round`` spans whose ``graph`` attribute
reads ``replay``, over all ``solve.round`` spans (``analyzer/solver.py``).  A
program whose rounds carry no ``graph`` attribute gives none."""

from ccbench.harness.spans import roots, walk


def read(run):
    trees = roots(run)
    if trees is None:
        return None
    how = [s.get("attrs", {}).get("graph") for t in trees for s in walk(t)
           if s["name"] == "solve.round"]
    if not any(h is not None for h in how):
        return None
    return 100.0 * sum(h == "replay" for h in how) / len(how)
