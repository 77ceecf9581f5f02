"""Percent of the traced what-if requests' ``batch_optimize`` wall spent in
the fixed part of every goal solve of every lane: its entry residuals and the
loop condition before its first round (``solve.enter``), and its final
recompute and stats read (``solve.exit``); ``analyzer/solver.py``."""

from ccbench.harness.spans import share_pct


def read(run):
    return share_pct(run, ("solve.enter", "solve.exit"))
