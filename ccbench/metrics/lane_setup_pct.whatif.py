"""Percent of the traced what-if requests' ``batch_optimize`` wall spent
setting the lanes up: the batch's context and masks (``lanes.setup``), the
lane-chunk plan and its memory guard (``lanes.plan``) and each block's
per-lane contexts (``lanes.context``); ``analyzer/optimizer.py``'s lane
runner."""

from ccbench.harness.spans import share_pct


def read(run):
    return share_pct(run, ("lanes.setup", "lanes.plan", "lanes.context"))
