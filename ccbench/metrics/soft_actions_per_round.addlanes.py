"""Actions a soft goal's round applies, over the traced what-if requests:
the summed ``moves`` of the soft ``goal.<Goal>`` spans (``hard`` false) over
their summed ``rounds`` (``analyzer/solver.py``).  A span's ``moves`` counts
every action its solve applied: replica moves, and the ``swaps`` (a swap
once) and ``leader_moves`` it also names, so it is the replica moves plus
the swaps plus the leadership moves.  A program whose goal spans carry no
``swaps`` attribute gives none, and so do soft goals that ran no round."""

from ccbench.harness.spans import roots, walk


def read(run):
    trees = roots(run)
    if trees is None:
        return None
    soft = [s["attrs"] for t in trees for s in walk(t)
            if s["name"].startswith("goal.") and "swaps" in s.get("attrs", {})
            and not s["attrs"].get("hard", True)]
    rounds = sum(a["rounds"] for a in soft)
    return sum(a["moves"] for a in soft) / rounds if rounds else None
