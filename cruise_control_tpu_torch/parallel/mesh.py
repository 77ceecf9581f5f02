"""Process meshes and sharding rules for the solver (the JAX package's
``parallel/mesh.py``).

The JAX package shards the REPLICA axis of the cluster tensors over a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives; a second mesh
axis runs independent what-if scenarios side by side.  Here the mesh is a
2-D layout of the ranks of ``torch.distributed``'s default process group,
and the collectives are written out.  The state and the placement stay
whole on every rank, as the JAX package keeps its broker-axis aggregates
replicated; a rank's slice of R splits only the passes that reduce over R
(:class:`ReplicaShard`): the aggregate recompute and the candidate top-k.
Everything after those runs on every rank, and the moves each phase keeps,
a goal's loop condition and its verdicts are the replica group's first
rank's (:meth:`ReplicaShard.agree`), so every rank holds the same integer
placement; the stop test's counts need no collective for that reason.

Why whole state and not rows owned per rank: the C×B tile gathers arbitrary
rows of the placement (``sibling_on_broker``, ``current_leader_of``), which
under owned rows would each become a cross-rank gather inside the tile.  The
price is memory: every rank holds all of R (at 1M replicas well under one
card's memory).  The price in time: every rank still scores all of R and
computes the whole tile, so more ranks make no solve faster; the split
passes are what a later design that scores and tiles only a rank's rows
would build on.

The shape rule (:func:`replica_shardings`, :func:`scenario_shardings`) is the
JAX package's, returning per leaf the mesh axes that split it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

SCENARIO_AXIS = "scenario"
REPLICA_AXIS = "replica"

#: Collectives issued by the solver's mesh paths since the last reset, by
#: kind (``chip_smoke.py`` reads and resets them).
CALLS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _grouped() -> bool:
    """Is a process group up?  Without one a mesh has one rank, and every
    collective over it is the identity."""
    return dist.is_available() and dist.is_initialized()


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, in place."""
    if _grouped():
        CALLS["all_reduce"] += 1
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """``t`` of every rank of ``group`` (``size`` ranks) stacked on a new
    leading axis, in the group's rank order."""
    if not _grouped():
        return t[None]
    CALLS["all_gather"] += 1
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t, group=group)
    return torch.stack(out)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` overwritten, in place, with (global) rank ``src``'s content."""
    if _grouped():
        CALLS["broadcast"] += 1
        dist.broadcast(t, src, group=group)
    return t


#: Groups made by :func:`_groups` under the current default group, by their
#: ranks.  Each group costs a ``new_group`` call on every rank (and under
#: NCCL a communicator of its own once used), so a mesh rebuilt for every
#: solve reuses its layout's groups.  ``_GROUPS_WORLD`` is the default group
#: they belong to: after a destroy and a new ``init_process_group`` they are
#: dropped.
_GROUPS: Dict[Tuple[int, ...], object] = {}
_GROUPS_WORLD: list = [None]


def _groups(member_lists: Sequence[Tuple[int, ...]]):
    """[(members, group)] for each member list, each group made once per
    default group.  Every rank must call this with the same lists in the
    same order (``new_group`` is collective over the whole world, for groups
    a rank is not in too); the cache hits alike on every rank, since every
    rank has made the same meshes."""
    world = dist.group.WORLD
    if _GROUPS_WORLD[0] is not world:
        _GROUPS.clear()
        _GROUPS_WORLD[0] = world
    everyone = tuple(range(dist.get_world_size()))
    out = []
    for members in member_lists:
        key = tuple(members)
        if key not in _GROUPS:
            # The whole world needs no group of its own: the default group is it.
            _GROUPS[key] = (world if tuple(sorted(key)) == everyone
                            else dist.new_group(list(key)))
        out.append((key, _GROUPS[key]))
    return out


class ReplicaShard:
    """One rank's part of a replica-sharded solve: its rows ``[lo, hi)`` of
    the padded replica axis and the replica group that sums over R.  A
    :class:`~cruise_control_tpu_torch.analyzer.context.GoalContext` carries
    it (``GoalSolver.shard_inputs``); it is not a dataclass, so it stays out
    of the dispatch's shape signature."""

    __slots__ = ("group", "size", "root", "lo", "hi")

    def __init__(self, group, size: int, root: int, lo: int, hi: int):
        self.group = group
        self.size = size
        self.root = root        # the group's first rank (global rank)
        self.lo = lo
        self.hi = hi

    @property
    def rows(self) -> slice:
        return slice(self.lo, self.hi)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's partial sum completed over the replica group."""
        return all_reduce_sum(t, self.group)

    def agree(self, *tensors: torch.Tensor):
        """``tensors`` (one shape) as the group's first rank holds them.

        Every rank runs the same code on the same placement, but float sums
        on the card (the applies' ``index_add``, ``host_load``) round in no
        fixed order, so two ranks could weigh a near-tie apart and then
        diverge.  So every decision that moves a replica, steers a goal's
        loop or reports its verdict is the first rank's: one broadcast of
        the packed decision (float64 holds rows, counts, flags and float32
        values exactly)."""
        packed = torch.stack([t.to(torch.float64) for t in tensors])
        broadcast(packed, self.root, self.group)
        return tuple(p.to(t.dtype) for p, t in zip(packed, tensors))

    def top_candidates(self, score: torch.Tensor, k: int):
        """(values, indices) of the k best rows of ``score`` (f32[R]) over
        the whole replica axis, descending, ties to the lower row (the order
        of one stable sort of all of R, ``lax.top_k``'s order).

        Each rank takes a stable top-m of its rows, m = min(k, rows a rank):
        every row of the global top-k is within its rank's top-m.  One
        all-gather brings every rank's m (value, row) pairs, in rank order,
        which is row order; one stable sort of the concatenation then breaks
        ties to the lower row as the unsharded sort does.  Rows are equal in
        number on every rank, so no rank pads."""
        m = min(k, self.hi - self.lo)
        vals, idx = torch.sort(score[self.rows], descending=True, stable=True)
        # One gather for both: rows < 2^53 are exact in float64.
        pairs = torch.stack([vals[:m].to(torch.float64),
                             (idx[:m] + self.lo).to(torch.float64)])
        got = all_gather(pairs, self.group, self.size)          # [n, 2, m]
        vals = got[:, 0].reshape(-1).to(score.dtype)
        rows = got[:, 1].reshape(-1).to(torch.int64)
        order = torch.sort(vals, descending=True, stable=True).indices[:k]
        return vals[order], rows[order]


class SolverMesh:
    """A 2-D (scenario, replica) layout of ranks, row-major: the rank at
    position p of ``ranks`` sits at (p // replica, p % replica).  The ranks
    of one scenario row form its *replica group*, which splits R; the ranks
    of one replica column form its *scenario group*, which splits what-if
    lanes.

    With ``torch.distributed`` initialized, every rank of the default group
    must build the same mesh in the same order (``new_group`` is collective
    over the whole world, for groups a rank is not in too).  Without a
    process group the mesh is a layout only: it has its shape and each
    rank's coordinates, and a solve on it raises unless it has one rank."""

    def __init__(self, ranks: Sequence[int], scenario_parallelism: int = 1):
        self.ranks = tuple(int(r) for r in ranks)
        n, s = len(self.ranks), int(scenario_parallelism)
        if s < 1 or n % s:
            raise ValueError(f"{n} devices not divisible by "
                             f"scenario_parallelism={scenario_parallelism}")
        nr = n // s
        self.shape = {SCENARIO_AXIS: s, REPLICA_AXIS: nr}
        self.bound = _grouped()
        self.rank = dist.get_rank() if self.bound else 0
        self.replica_group = self.scenario_group = None
        if not self.bound:
            return
        rows = [self.ranks[i * nr:(i + 1) * nr] for i in range(s)]
        cols = [self.ranks[j::nr] for j in range(nr)]
        for (members, group), attr in (
                [(mg, "replica_group") for mg in _groups(rows)]
                + [(mg, "scenario_group") for mg in _groups(cols)]):
            if self.rank in members:
                setattr(self, attr, group)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(scenario, replica) coordinates of ``rank`` (default: this one)."""
        p = self.ranks.index(self.rank if rank is None else rank)
        return divmod(p, self.shape[REPLICA_AXIS])

    def row_range(self, num_replicas_padded: int,
                  rank: Optional[int] = None) -> Tuple[int, int]:
        """The rows ``[lo, hi)`` of the padded replica axis that ``rank``
        owns.  The replica axis must divide R_pad, as in the JAX package's
        ``pad_replicas_to % n_dev`` rule."""
        nr = self.shape[REPLICA_AXIS]
        if num_replicas_padded % nr:
            raise ValueError(f"{num_replicas_padded} padded replicas not divisible by "
                             f"the mesh's replica axis {nr}")
        step = num_replicas_padded // nr
        j = self.coords(rank)[1]
        return j * step, (j + 1) * step

    def replica_shard(self, num_replicas_padded: int) -> ReplicaShard:
        """This rank's part of a solve on the mesh; raises unless this
        process can run one."""
        if self.size > 1 and not self.bound:
            raise RuntimeError(f"a mesh of {self.size} ranks needs torch.distributed "
                               "initialized (parallel.multihost.initialize)")
        if self.bound and self.rank not in self.ranks:
            raise RuntimeError(f"rank {self.rank} is not in the mesh {self.ranks}")
        lo, hi = self.row_range(num_replicas_padded)
        nr = self.shape[REPLICA_AXIS]
        root = self.ranks[self.coords()[0] * nr]
        return ReplicaShard(self.replica_group, nr, root, lo, hi)


def make_solver_mesh(num_devices: Optional[int] = None,
                     scenario_parallelism: int = 1,
                     devices: Optional[Sequence[int]] = None) -> SolverMesh:
    """2D mesh (scenario, replica) over ranks.  ``scenario_parallelism``
    ranks are dedicated to lane-parallel what-ifs; the rest shard the
    replica axis.  With the defaults the whole mesh shards replicas.

    ``devices`` are ranks of the default process group (default: all of
    them, or ``range(num_devices)`` as a layout when no group is up)."""
    if devices is not None:
        devs = list(devices)
    elif _grouped():
        devs = list(range(dist.get_world_size()))
    else:
        devs = list(range(num_devices if num_devices is not None else 1))
    n = num_devices if num_devices is not None else len(devs)
    if len(devs) < n:
        raise RuntimeError(f"make_solver_mesh({n}): only {len(devs)} ranks in the "
                           "process group")
    return SolverMesh(devs[:n], scenario_parallelism)


def _spec_for(arr, num_replicas_padded: int, lanes: Optional[int]) -> Tuple[str, ...]:
    shape = getattr(arr, "shape", ())
    if lanes is not None and len(shape) >= 1 and shape[0] == lanes:
        if len(shape) >= 2 and shape[1] == num_replicas_padded:
            return (SCENARIO_AXIS, REPLICA_AXIS)
        return (SCENARIO_AXIS,)
    if len(shape) >= 1 and shape[0] == num_replicas_padded:
        return (REPLICA_AXIS,)
    return ()


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: _tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def replica_shardings(mesh: SolverMesh, tree, num_replicas_padded: int):
    """Per leaf, the mesh axes that split it: ``("replica",)`` for arrays
    whose leading axis is the padded replica count, ``()`` (replicated) for
    the rest."""
    return _tree_map(lambda a: _spec_for(a, num_replicas_padded, None), tree)


def scenario_shardings(mesh: SolverMesh, tree, num_replicas_padded: int, lanes: int):
    """Per leaf of a lane-stacked tree (what-if batches), the mesh axes that
    split it."""
    return _tree_map(lambda a: _spec_for(a, num_replicas_padded, lanes), tree)
