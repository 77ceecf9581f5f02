"""The mean wall of one solver round (``solve.round``: its phases, its stats
and the loop condition read after it; ``analyzer/solver.py``) in the traced
what-if requests, in milliseconds."""

from ccbench.harness.spans import roots, walls_ms


def read(run):
    trees = roots(run)
    walls = walls_ms(trees, ("solve.round",)) if trees is not None else []
    return sum(walls) / len(walls) if walls else None
