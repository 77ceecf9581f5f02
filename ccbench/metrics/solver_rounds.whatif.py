"""Solver rounds a what-if lane, summed over its goals (the lane batch's
``BatchScenarioResult.rounds``; ``analyzer/solver.py`` through the lane
runner), over every lane of the window."""


def read(run):
    lanes = sum(r.get("lanes", 0) for r in run.requests)
    if not lanes:
        return None
    return sum(r["rounds"] for r in run.requests if "lanes" in r) / lanes
