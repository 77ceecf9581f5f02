"""The control and the faults that the check of ``correct`` has to catch,
planted in the program for one run (``ccbench/control.py`` runs them on the
card, ``ccbench/tests/test_ccbench_faults.py`` on the CPU).

- ``control``: the reference put in the program's place one precision
  below the float32 the configuration states: the per-broker sums of each
  judged placement computed from the benchmark's loads in bfloat16 (inputs
  and accumulation) on the program's device, in place of the program's
  aggregate kernel.
- ``unchanged``: every goal's solve returns its placement unchanged and
  claims success.
- ``half_rows``: the aggregate leaves out every other replica row and
  doubles the rest (half of the batch left out, the mean taken over the
  rest).
- ``half_lanes``: a what-if block solves only its first half of lanes; the
  rest keep their seed placement.
- ``altered``: one answer altered where it is produced: one replica of a
  what-if lane put back on the broker the lane removes.

A cell on one card has no exchange between chips, so that fault has no
place here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator


@contextlib.contextmanager
def _patched(obj, name: str, value) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _control():
    from ccbench.harness import program

    def bf16_sums(state, placement, meta, balancing, broker, is_leader):
        import numpy as np
        import torch
        dev, bf16 = state.device, torch.bfloat16
        ll, fl = state.leader_load.to(bf16), state.follower_load.to(bf16)
        b_n = len(meta.broker_ids)
        out = np.empty((broker.shape[0], b_n, 8))
        for s in range(broker.shape[0]):
            lead = torch.as_tensor(is_leader[s], device=dev)
            load = torch.where(lead[:, None], ll, fl)
            ones = torch.ones_like(load[:, :1])
            lead_c = lead[:, None].to(bf16)
            channels = torch.cat([load, ones, lead_c, ll[:, 2:3], ll[:, 1:2] * lead_c], dim=1)
            sums = torch.zeros((b_n, 8), dtype=bf16, device=dev).index_add_(
                0, torch.as_tensor(broker[s], device=dev).long(), channels)
            out[s] = sums.float().cpu().numpy()
        return out
    return _patched(program, "broker_sums", bf16_sums)


def _unchanged():
    from cruise_control_tpu_torch.analyzer import solver

    def optimize_goal(self, goal, priors, gctx, placement, agg=None, budget=None, width=None):
        if agg is None:
            agg = self.aggregates(gctx, placement)
        return placement, agg, solver.GoalOptimizationInfo(goal_name=goal.name)
    return _patched(solver.GoalSolver, "optimize_goal", optimize_goal)


def _half_rows():
    from cruise_control_tpu_torch.analyzer import context
    sums = context.broker_channel_sums

    def half(channels, broker, num_segments):
        return sums(channels[::2].contiguous(), broker[::2].contiguous(), num_segments) * 2.0
    return _patched(context, "broker_channel_sums", half)


def _half_lanes():
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    run = GoalOptimizer._run_lanes

    def run_lanes(self, gctx, seed, goals, num_candidates, alive_s, excl_move_s,
                  excl_lead_s, budget, n_real):
        half = max(n_real // 2, 1)
        rounds, moves, violated, stranded, stacked = run(
            self, gctx, seed, goals, num_candidates, alive_s, excl_move_s, excl_lead_s,
            budget, half)
        import numpy as np
        import torch
        pad = n_real - half
        if pad:
            z = np.zeros((pad, rounds.shape[1]), rounds.dtype)
            rounds, moves, violated = (np.concatenate([a, z]) for a in (rounds, moves, violated))
            stranded = np.concatenate([stranded, np.zeros(pad, stranded.dtype)])
            stacked = type(stacked)(**{f: torch.cat([getattr(stacked, f),
                                                     getattr(seed, f).expand(pad, -1)])
                                       for f in ("broker", "disk", "is_leader")})
        return rounds, moves, violated, stranded, stacked
    return _patched(GoalOptimizer, "_run_lanes", run_lanes)


def _altered():
    from cruise_control_tpu_torch.analyzer import optimizer as opt
    run = opt.GoalOptimizer._run_lanes

    def run_lanes(self, gctx, seed, goals, num_candidates, alive_s, excl_move_s,
                  excl_lead_s, budget, n_real):
        out = run(self, gctx, seed, goals, num_candidates, alive_s, excl_move_s, excl_lead_s,
                  budget, n_real)
        stacked = out[4]
        removed = int((~alive_s[0] & gctx.state.broker_valid).nonzero()[0, 0])
        broker = stacked.broker.clone()
        broker[0, 0] = removed
        return out[:4] + (dataclasses.replace(stacked, broker=broker),)
    return _patched(opt.GoalOptimizer, "_run_lanes", run_lanes)


_MAKERS = {"control": _control, "unchanged": _unchanged, "half_rows": _half_rows,
           "half_lanes": _half_lanes, "altered": _altered}
PLANTS = tuple(_MAKERS)


def planted(name: str):
    """A context manager that plants ``name`` (one of :data:`PLANTS`) in the
    program for its duration."""
    if name not in _MAKERS:
        raise ValueError(f"unknown plant {name!r} (known: {', '.join(PLANTS)})")
    return _MAKERS[name]()
