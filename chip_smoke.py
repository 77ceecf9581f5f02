#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernel from the sources in this checkout,
holds it against its plain PyTorch version at the shapes the main path and
the north-star cluster give it, drives the offline propose path (the
``run_propose`` entry point) at BASELINE config #3 (200 brokers, 50K
replicas) on the 15-goal default stack, counts the kernel launches that run
made, and checks the result.  Then it holds one swap tile's selection on
the card against the CPU, runs every other goal set (kafka-assigner,
intra-broker on a JBOD variant, preferred-leader election, minimum topic
leaders), and the north-star cluster (BASELINE config #4: 2,600 brokers, 1M
replicas) on the default stack.  Then the slice of the builder, budgets,
lanes and relaxation: the DeterministicCluster fixtures (BASELINE config
#1), the propose from a JSON snapshot, remove- and add-broker what-if lanes
(BASELINE config #5), budgeted solves and the relaxation path, each phase
counting the kernel's launches.  Prints one JSON object per phase; the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when CUDA is unavailable or the port's package is not beside this
script, and whenever a check fails.
"""

import io
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bandwidth and float32 outside the
# tensor cores.  The bound of a kernel is the larger of its bytes over the
# first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TOL = dict(rtol=1e-6, atol=1e-4)

# BASELINE config #3 (bench.py:425-428): the repo's headline mid-size cluster.
BASELINE3 = dict(num_brokers=200, num_racks=10, num_topics=1000,
                 num_replicas=50_000, mean_cpu=0.006, mean_disk=90.0,
                 mean_nw_in=90.0, mean_nw_out=90.0, seed=3140)
# BASELINE config #4 (bench.py:478-481): the north-star cluster.
NORTH_STAR = dict(num_brokers=2600, num_racks=40, num_topics=2000,
                  num_replicas=1_000_000, mean_cpu=0.0035, mean_disk=90.0,
                  mean_nw_in=90.0, mean_nw_out=90.0, seed=3141)
# BASELINE #3 with 50 topics: its three largest topics then hold ~1K-2K
# partitions, enough for every broker to lead MIN_TOPIC_LEADERS of each (no
# topic of BASELINE #3 itself has one partition per broker).
MIN_LEADERS = dict(BASELINE3, num_topics=50)
MIN_TOPIC_LEADERS = 3
# The swap tile check's priors: the default stack's hard and replica-count goals.
SWAP_PRIORS = 7
# The kafka-assigner even goal's round budget at BASELINE #3: the JAX
# package's solve needs 123 rounds there (scripts/jax_reference_quality.py
# --run kafka_assigner --max-rounds 400) and fails at the default 96.
KAFKA_ASSIGNER_ROUNDS = 256
# BASELINE config #5 (bench.py:497-553): decommission what-ifs over a healthy
# 2,600-broker cluster on the six hard goals, at the lanes' candidate width.
HEALTHY = dict(num_brokers=2600, num_racks=40, num_topics=2000,
               num_replicas=1_000_000, mean_cpu=0.002, mean_disk=60.0,
               mean_nw_in=60.0, mean_nw_out=60.0, seed=3142)
WHATIF_LANES = 16
DECOMMISSION = 64
LANE_WIDTH = 512
# The add-broker batch (tests/test_analyzer.py:417-454) at BASELINE #3
# scale: its goals, and the candidates provisioned dead (the last four
# brokers), revived alone, in a pair and all four.
ADD_GOALS = ["RackAwareGoal", "ReplicaCapacityGoal", "ReplicaDistributionGoal"]
ADD_CANDIDATES = 4
# Removal lanes of the relax phase (the full default stack at BASELINE #3).
RELAX_LANES = 4
# The small cluster on which the CUDA run is held against the CPU run.
SMALL = dict(num_brokers=20, num_racks=5, num_topics=50, num_replicas=2000,
             mean_cpu=0.005, mean_disk=2100.0, mean_nw_in=2000.0,
             mean_nw_out=2000.0, seed=11)
# Kernel shapes: (rows, channels, brokers, inputs).  "ragged" adds rows
# outside [0, B); "skewed" puts half of the rows on 26 brokers; "offset"
# passes channels as a contiguous view 4 bytes into its storage (the scalar
# path); 8,192 brokers at 64 channels take ten broker tiles.
KERNEL_SHAPES = [(1613, 8, 37, "ragged"), (50_000, 8, 200, "uniform"),
                 (1_000_000, 8, 2600, "uniform"), (1_000_000, 8, 8192, "uniform"),
                 (1_000_000, 8, 2600, "skewed"), (50_000, 4, 200, "uniform"),
                 (50_000, 13, 200, "offset"), (50_000, 8, 200, "offset"),
                 (0, 8, 200, "uniform"), (200_000, 64, 8192, "uniform")]
# Row counts (at K = 8, B = 200) at which BLOCK and GLOBAL are timed
# against each other, on uniform and skewed brokers, around the launch
# plan's threshold between them.
CROSSOVER_ROWS = (1024, 2048, 4096, 8192, 16_384, 24_576, 32_768)

class SmokeFailure(Exception):
    pass


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device milliseconds per call over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def per_call_ms(fns, trials=5, iters=50):
    """Median milliseconds per call of each function over ``trials`` runs
    of ``iters`` back-to-back calls (CUDA events), the functions taking
    turns (a, b, b, a, ...), so that host noise falls on both alike."""
    import statistics
    times = [[] for _ in fns]
    for t in range(trials):
        for i in (range(len(fns)) if t % 2 == 0 else reversed(range(len(fns)))):
            times[i].append(cuda_ms(fns[i], iters))
    return [statistics.median(ts) for ts in times]


def bound(r, k, b):
    """(ms, 'bytes' | 'operations'): the least time for one channel sum:
    read R*(K*4 + 4) bytes, write B*K*4, and do R*K float32 adds."""
    t_bytes = (r * (k * 4 + 4) + b * k * 4) / HBM_BYTES_PER_S
    t_ops = r * k / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def host_us(fn, calls=1000):
    """Host microseconds per call over ``calls`` calls without a sync, then
    one sync (the wrapper's host cost where it exceeds the device's)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def device_per_call(fn, iters=20, tries=3):
    """(device ms per call over all device entries, device entries per call,
    {name: device ms per call}) from torch.profiler.  A trace that lost some
    of the calls' device entries (fewer than one per call, or a count that
    the calls do not divide) is taken again."""
    for _ in range(tries):
        _, busy_ms, by_name = device_profile(fn, iters)
        count = sum(c for _, c in by_name.values())
        if count >= iters and count % iters == 0:
            break
    return (busy_ms / iters, count / iters,
            {name: ms / iters for name, (ms, _) in by_name.items()})


def plan_fields(plan, ch):
    """The launch plan, and whether these inputs take its vector path."""
    return dict(plan._asdict(), vector_path=bool(plan.vector and ch.data_ptr() % 16 == 0))


def rounding_bounds(aggregate, ch, br, b):
    """Per broker and channel, the f32 rounding of an n-term sum in any
    order: the worst case (n - 1) * 2^-24 * sum |x|, and the bar for
    zero-mean channels, min(n - 1, 4 sqrt(n)) * 2^-24 * sum |x|: four times
    the typical rounding of such a sum (sqrt(n) terms) where n is large, the
    worst case where it is small.  A lost row moves a sum by about |x|, far
    more than the bar."""
    import torch
    n = aggregate.broker_channel_sums_plain(
        torch.ones(ch.shape[0], 1, dtype=torch.float64, device=ch.device), br, b)
    mag = aggregate.broker_channel_sums_plain(ch.double().abs(), br, b) * 2.0 ** -24
    worst = (n - 1).clamp(min=0)
    return worst * mag, torch.minimum(worst, 4 * n.sqrt()) * mag


def bound_use(err, bar):
    """The largest share of its bar that an error takes (a sum of one row or
    none has a bar of 0 and no error)."""
    import torch
    return float(torch.where(bar > 0, err / bar.clamp(min=1e-300), err * 1e300).max())


def measure_kernel(aggregate, ch, br, b, inputs):
    """Kernel against its plain version (and a float64 sum) on the same
    inputs: errors, times, and the launch plan.  ``inputs``: "main path"
    (the snapshot's loads), or random zero-mean channels of that kind, held
    to the zero-mean bar and, but for "skewed", to rtol/atol against plain."""
    import torch
    got = aggregate.broker_channel_sums(ch, br, b)
    ref = aggregate.broker_channel_sums_plain(ch, br, b)
    ref64 = aggregate.broker_channel_sums_plain(ch.double(), br, b)
    torch.cuda.synchronize()
    zero_mean = inputs != "main path"
    diff = (got - ref).abs()
    big = ref.abs() > 1.0
    # The library yardstick: one index_add on inputs with the out-of-range
    # rows already masked (index_add would fault on them).
    ok = (br >= 0) & (br < b)
    br_l = torch.where(ok, br, 0).long()
    ch_m = torch.where(ok[:, None], ch, 0.0)
    zeros = torch.zeros(b, ch.shape[1], device=ch.device)
    lib = zeros.index_add(0, br_l, ch_m)
    r, k = ch.shape
    bound_ms, bound_by = bound(r, k, b)
    worst, zero_mean_bar = rounding_bounds(aggregate, ch, br, b)
    err64 = (got.double() - ref64).abs()
    plain_err64 = (ref.double() - ref64).abs()
    call = lambda: aggregate.broker_channel_sums(ch, br, b)  # noqa: E731
    lib_call = lambda: zeros.index_add(0, br_l, ch_m)  # noqa: E731
    dev_ms, dev_ops, by_name = device_per_call(call)
    lib_dev_ms, lib_dev_ops, _ = device_per_call(lib_call)
    kernel_ms, library_ms = per_call_ms([call, lib_call])
    out = dict(
        max_abs_err=float(diff.max()),
        max_rel_err=float((diff[big] / ref[big].abs()).max()) if bool(big.any()) else 0.0,
        max_abs_err_vs_f64=float(err64.max()),
        plain_max_abs_err_vs_f64=float(plain_err64.max()),
        within_f32_bound=bool((err64 <= worst + 1e-9).all()),
        # Of the zero-mean bar: the largest share that the kernel's and the
        # plain version's distance from float64 take.
        zero_mean_bar_use=bound_use(err64, zero_mean_bar),
        plain_zero_mean_bar_use=bound_use(plain_err64, zero_mean_bar),
        within_zero_mean_bar=bool((err64 <= zero_mean_bar + 1e-9).all()),
        allclose=bool(torch.allclose(got, ref, **TOL)),
        allclose_f64=bool(torch.allclose(got, ref64.float(), **TOL)),
        library_allclose=bool(torch.allclose(lib, ref, **TOL)),
        counts_exact=bool(torch.equal(got[:, 4:6], ref[:, 4:6])) if k >= 6 else None,
        kernel_ms=kernel_ms,
        device_ms=dev_ms,
        kernel_device_ms=sum(ms for name, ms in by_name.items() if "channel_sums" in name),
        device_ops_per_call=dev_ops,
        host_us_per_call=host_us(call),
        plain_ms=cuda_ms(lambda: aggregate.broker_channel_sums_plain(ch, br, b)),
        library_ms=library_ms,
        library_device_ms=lib_dev_ms,
        library_device_ops_per_call=lib_dev_ops,
        library_host_us_per_call=host_us(lib_call),
        bound_ms=bound_ms, bound_by=bound_by,
        plan=plan_fields(aggregate.plan_for(r, k, b, ch.device), ch),
    )
    # Any order of f32 sums stays within this bound of the float64 sum; on
    # real loads (sums ~2e4) kernel and plain may differ by more than the
    # rtol=1e-6 bar while both are within it.
    check(out["within_f32_bound"], f"kernel outside the f32 bound at {(r, k, b)}: {out}")
    if zero_mean:
        check(out["within_zero_mean_bar"], f"kernel outside the zero-mean bar at {(r, k, b)}: {out}")
    if zero_mean and inputs != "skewed":
        # Normal-distributed channels: tests/test_ops.py's bar against plain.
        # (Skewed brokers sum ~19K rows each: the plain version's own f32
        # rounding then exceeds this bar.)
        check(out["allclose"], f"kernel disagrees with plain at {(r, k, b)}: {out}")
    if k >= 6:
        check(out["counts_exact"], f"count channels not exact at {(r, k, b)}")
    # One kernel per call (and a memset at R = 0), nothing else on the card.
    check(dev_ops <= 2, f"{dev_ops} device operations per call at {(r, k, b)}: {by_name}")
    return out


def crossover(aggregate, kind, k=8, b=200):
    """BLOCK against GLOBAL, each forced through the launch plan's row
    threshold, on the same inputs at each of CROSSOVER_ROWS: held to the
    plain version, then device ms per call (the calls' host cost is the
    same)."""
    import torch
    saved = aggregate.GLOBAL_MAX_ROWS
    rows = []
    try:
        for i, r in enumerate(CROSSOVER_ROWS):
            ch, br = random_channels(r, k, b, kind, seed=200 + i)
            ref = aggregate.broker_channel_sums_plain(ch, br, b)
            row = dict(rows=r, rule="GLOBAL" if r <= saved else "BLOCK")
            for name, limit in (("BLOCK", -1), ("GLOBAL", r)):
                aggregate.GLOBAL_MAX_ROWS = limit
                aggregate._plans.clear()
                call = lambda: aggregate.broker_channel_sums(ch, br, b)  # noqa: E731
                got = call()
                torch.cuda.synchronize()
                check(torch.allclose(got, ref, **TOL), f"{name} disagrees with plain at {r} rows")
                row[name] = dict(device_ms=device_per_call(call)[0],
                                 plan=plan_fields(aggregate.plan_for(r, k, b, ch.device), ch))
            rows.append(row)
    finally:
        aggregate.GLOBAL_MAX_ROWS = saved
        aggregate._plans.clear()
    return rows


def host_costs(aggregate):
    """Host microseconds per call of the wrapper's steps (1,000 calls each),
    to pick the cheapest stream handle and see where the host time goes."""
    import torch
    dev = torch.device("cuda", torch.cuda.current_device())
    ch = torch.zeros(16, 8, device=dev)
    br = torch.zeros(16, dtype=torch.int32, device=dev)
    steps = {
        "current_stream(device).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(dev.index).cuda_stream,
        "_C._cuda_getCurrentRawStream(index)":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "torch.empty(B, K)": lambda: torch.empty(4, 8, dtype=torch.float32, device=dev),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "plan_for (cached)": lambda: aggregate.plan_for(16, 8, 4, dev),
        "broker_channel_sums, 0 rows (memset only)":
            lambda: aggregate.broker_channel_sums(ch[:0], br[:0], 4),
        "broker_channel_sums, 0 brokers (checks, plan, empty)":
            lambda: aggregate.broker_channel_sums(ch, br, 0),
        "broker_channel_sums, 16 rows": lambda: aggregate.broker_channel_sums(ch, br, 4),
    }
    return {name: host_us(fn) for name, fn in steps.items()}


def sass_atomics(aggregate):
    """{atomic or reduction opcode: count} over the built library's SASS
    (cuobjdump from the toolkit beside nvcc), or "not measured"."""
    import re
    cuobjdump = os.path.join(os.path.dirname(aggregate._nvcc()), "cuobjdump")
    lib = aggregate.build()
    try:
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120).stdout
    except OSError:
        return "not measured"
    counts = {}
    for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


def random_channels(r, k, b, kind, seed):
    """Channels shaped like compute_aggregates' (normal loads, 0/1 counts)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    pad = 1 if kind == "offset" else 0
    ch = torch.randn(r * k + pad, device="cuda", generator=g)[pad:].view(r, k)
    if k >= 6:
        ch[:, 4] = 1.0
        ch[:, 5] = (torch.rand(r, device="cuda", generator=g) < 0.34).float()
    lo, hi = (-3, b + 3) if kind == "ragged" else (0, b)
    br = torch.randint(lo, hi, (r,), device="cuda", generator=g, dtype=torch.int32)
    if kind == "skewed":
        hot = torch.rand(r, device="cuda", generator=g) < 0.5
        br = torch.where(hot, br % 26, br)
    return ch, br


def sync(device):
    """Wait for the card (host clocks around device work end here)."""
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def propose_once(path, goals, device="cuda"):
    """One run of the CLI entry point; returns (wall s, parsed JSON)."""
    from cruise_control_tpu_torch.client.propose import run_propose
    out = io.StringIO()
    args = SimpleNamespace(snapshot=path, goals=",".join(goals), device=device,
                           verbose=True)
    t0 = time.monotonic()
    rc = run_propose(args, out)
    sync(device)
    wall = time.monotonic() - t0
    check(rc == 0, f"run_propose exited {rc} (OptimizationFailureError or bad input)")
    return wall, json.loads(out.getvalue())


def check_proposals(proposals):
    """Every proposal moves a partition to distinct brokers, keeps its
    replica count, and names an old leader among its old replicas."""
    for p in proposals:
        check(len(set(p["newReplicas"])) == len(p["newReplicas"]) == len(p["oldReplicas"])
              and p["oldLeader"] in p["oldReplicas"], f"malformed proposal {p}")


def run_goals(aggregate, props, goal_names, device, constraint=None, placement=None):
    """One GoalOptimizer run of ``goal_names`` on a generated cluster (or on
    ``placement`` of it): checks that no hard goal of the run is violated
    after, that the proposals are well formed and that the kernel launched;
    returns (summary dict, result)."""
    import torch
    from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing import random_cluster as rc
    st, pl, mt = rc.generate(rc.ClusterProperties(**props), device=device)
    pl = pl if placement is None else placement
    optimizer = GoalOptimizer(constraint=constraint or BalancingConstraint(),
                              goal_names=goal_names)
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    res = optimizer.optimizations(st, pl, mt)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = aggregate.LAUNCHES
    doc = res.to_dict()
    hard = hard_names(goal_names)
    check(launches > 0, f"{goal_names}: the aggregate kernel launched 0 times")
    check(not set(res.violated_goals_after) & hard,
          f"{goal_names}: hard goals violated after: {res.violated_goals_after}")
    check_proposals([p.to_dict() for p in res.proposals])
    return dict(
        replicas=mt.num_replicas, brokers=mt.num_brokers, wall_s=wall,
        optimizer_s=res.elapsed_s, kernel_launches=launches,
        goals=[{k: g[k] for k in ("goal", "rounds", "moves", "violatedBrokersBefore",
                                  "violatedBrokersAfter")} for g in doc["goals"]],
        violated_goals_before=res.violated_goals_before,
        violated_goals_after=res.violated_goals_after,
        balancedness=res.balancedness_score, proposals=len(res.proposals),
        replica_moves=doc["numInterBrokerReplicaMovements"],
        intra_broker_moves=doc["numIntraBrokerReplicaMovements"],
        leader_moves=doc["numLeaderMovements"]), res


def to_device(obj, device):
    """A dataclass of tensors (Placement, Aggregates) on ``device``."""
    import dataclasses
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device)
                                       for f in dataclasses.fields(obj)})


def swap_tile_check(aggregate, props, device="cuda"):
    """One NetworkOutboundUsageDistributionGoal swap tile behind the default
    stack's first SWAP_PRIORS goals (solved first, on ``device``): the
    selection on ``device`` against the CPU's on the same inputs (jitter
    off), every kept pair held to the CPU feasibility mask, the hard goals
    after the swaps, and the swap phase's time per round."""
    import torch
    from cruise_control_tpu_torch.analyzer import solver as S
    from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.context import (
        build_context, compute_aggregates, currently_offline)
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS, goal_by_name
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
    from cruise_control_tpu_torch.testing import random_cluster as rc
    names = DEFAULT_GOALS[:SWAP_PRIORS]
    _, res = run_goals(aggregate, props, names, device)
    goal = goal_by_name("NetworkOutboundUsageDistributionGoal")
    priors = [goal_by_name(n) for n in names]
    solver = S.GoalSolver()
    sel = {}
    for dev in (device, "cpu"):
        st, _, mt = rc.generate(rc.ClusterProperties(**props), device=dev)
        pl = to_device(res.final_placement, dev)
        gctx = build_context(st, pl, mt, BalancingConstraint(), OptimizationOptions())
        if dev == device:
            agg = compute_aggregates(gctx, pl)
            c = solver.swap_width(goal, st.num_replicas_padded)
            tile = S.swap_tile(goal, gctx, pl, agg, 0, c)
        a = to_device(agg, dev)
        t = [x.to(dev) for x in tile]
        keep, r_in, _, _ = S.swap_select(goal, priors, gctx, pl, a, 0, *t, jitter_frac=0.0)
        sel[dev] = (keep.cpu(), r_in.cpu(), gctx, pl, a, t)
    keep, r_in = sel["cpu"][:2]
    kept = int(keep.sum())
    same = (torch.equal(sel[device][0], keep)
            and torch.equal(sel[device][1][keep], r_in[keep]))
    # Every kept pair against the feasibility mask, on the CPU.
    _, _, gctx, pl, a, t = sel["cpu"]
    ro, ri = t[1][keep], r_in[keep]
    bo, bi = pl.broker[ro], pl.broker[ri]
    feasible = ((bo != bi) & (gctx.state.partition[ro] != gctx.state.partition[ri])
                & goal.swap_ok(gctx, pl, a, ro, ri)
                & S._chain_accept_swap(priors)(gctx, pl, a, ro, ri, bo, bi))
    # The swaps applied on the device: hard goals after, fresh aggregates.
    _, _, gctx_d, pl_d, a_d, t_d = sel[device]
    pl2, _, applied = S.swap_body(goal, priors, gctx_d, pl_d, a_d, 0, *t_d, jitter_frac=0.0)
    agg2 = compute_aggregates(gctx_d, pl2)
    hard_after = {g.name: int(g.violated_brokers(gctx_d, pl2, agg2).sum())
                  for g in priors if g.is_hard}
    stranded = int(currently_offline(gctx_d, pl2).sum())
    # The whole swap phase (tile selection included, jitter on) per round.
    phase = S._swap_phase(goal, priors, c, jitter_frac=solver.dst_jitter_frac)
    ms = cuda_ms(lambda: phase(gctx_d, pl_d, a_d, 1), iters=10, warmup=2)
    out = dict(replicas=gctx.state.num_replicas_padded, tile=c, kept=kept,
               applied_on_device=int(applied), same_swaps_as_cpu=same,
               kept_pairs_feasible_on_cpu=bool(feasible.all()),
               hard_goals_violated_after=hard_after, stranded_after=stranded,
               swap_phase_ms_per_round=ms)
    check(kept > 0, f"the swap tile kept no swap: {out}")
    check(same, f"the card and the CPU keep different swaps: {out}")
    check(bool(feasible.all()), f"a kept swap fails the CPU feasibility mask: {out}")
    check(not any(hard_after.values()) and stranded == 0,
          f"hard goals violated after the swaps: {out}")
    return out


def other_goal_sets(aggregate, full_placement, device="cuda"):
    """Every goal outside the default stack, one run each at BASELINE #3
    scale: the kafka-assigner pair (KAFKA_ASSIGNER_ROUNDS rounds a goal),
    the intra-broker pair on a four-logdir variant, preferred-leader
    election on the default stack's result, and MIN_TOPIC_LEADERS leaders a
    broker of each of the three largest topics of a 50-topic variant.  Some
    goal of each run must have work to do."""
    import numpy as np
    from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals.registry import (
        DEFAULT_INTRA_BROKER_GOALS, KAFKA_ASSIGNER_GOALS)
    from cruise_control_tpu_torch.testing import random_cluster as rc
    st, _, mt = rc.generate(rc.ClusterProperties(**MIN_LEADERS), device="cpu")
    valid = st.valid.numpy()
    parts = np.bincount(st.topic.numpy()[valid][st.pos.numpy()[valid] == 0],
                        minlength=mt.num_topics)
    top3 = np.argsort(-parts, kind="stable")[:3]
    largest = tuple(mt.topics[i] for i in top3)
    runs = [
        ("kafka_assigner", BASELINE3, KAFKA_ASSIGNER_GOALS,
         BalancingConstraint(max_rounds_per_goal=KAFKA_ASSIGNER_ROUNDS), None),
        ("intra_broker_jbod", dict(BASELINE3, num_disks=4), DEFAULT_INTRA_BROKER_GOALS,
         None, None),
        ("preferred_leader", BASELINE3, ["PreferredLeaderElectionGoal"], None,
         full_placement),
        ("min_topic_leaders", MIN_LEADERS, ["MinTopicLeadersPerBrokerGoal"],
         BalancingConstraint(min_leader_topic_names=largest,
                             min_topic_leaders_per_broker=MIN_TOPIC_LEADERS), None),
    ]
    out = {}
    for name, props, goals, constraint, placement in runs:
        out[name], res = run_goals(aggregate, props, goals, device, constraint, placement)
        if name == "min_topic_leaders":
            out[name]["topic_partitions"] = dict(zip(largest, parts[top3].tolist()))
        check(any(i.violated_brokers_before > 0 for i in res.goal_infos),
              f"{name}: no goal of the run had anything to do")
    return out


def bench1_cluster(det):
    """BASELINE config #1 as bench.py:442-454 builds it: 6 brokers on 3
    racks, 100 partitions of RF 2 on one topic."""
    cm = det.homogeneous_cluster({0: 0, 1: 0, 2: 1, 3: 1, 4: 2, 5: 2})
    for p in range(100):
        lead, foll = p % 6, (p + 1 + p % 3) % 6
        cm.create_replica("T1", p, broker_id=lead, index=0, is_leader=True)
        cm.create_replica("T1", p, broker_id=foll, index=1, is_leader=False)
        cm.set_replica_load("T1", p, lead, det.load(0.5, 120.0, 180.0, 220.0))
        cm.set_replica_load("T1", p, foll, det.load(0.1, 120.0, 0.0, 220.0))
    return cm


def hard_names(goal_names):
    from cruise_control_tpu_torch.analyzer.goals.registry import goal_by_name
    return {g for g in goal_names if goal_by_name(g).is_hard}


def deterministic_phase(aggregate, device="cuda"):
    """BASELINE config #1: the DeterministicCluster fixtures that the JAX
    tests solve with the default stack, and bench.py's 6-broker harness,
    each built by the port's builder, frozen on ``device`` and solved there
    and on the CPU."""
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing import deterministic as det
    fixtures = {"unbalanced": (det.unbalanced, {}),
                "unbalanced_with_a_follower": (det.unbalanced_with_a_follower, {}),
                "bench_6brokers_200replicas": (lambda: bench1_cluster(det),
                                               dict(pad_replicas_to=256, pad_brokers_to=8))}
    hard = hard_names(DEFAULT_GOALS)
    out = {}
    for name, (build, pads) in fixtures.items():
        runs = {}
        for dev in (device, "cpu"):
            st, pl, mt = build().freeze(device=dev, **pads)
            aggregate.LAUNCHES = 0
            t0 = time.monotonic()
            res = GoalOptimizer().optimizations(st, pl, mt)
            sync(dev)
            runs[dev] = dict(wall_s=time.monotonic() - t0, kernel_launches=aggregate.LAUNCHES,
                             violated_goals_before=res.violated_goals_before,
                             violated_goals_after=res.violated_goals_after,
                             balancedness=res.balancedness_score,
                             proposals=len(res.proposals))
            check(not set(res.violated_goals_after) & hard,
                  f"{name} on {dev}: hard goals violated after: {res.violated_goals_after}")
            check_proposals([p.to_dict() for p in res.proposals])
        check(runs[device]["kernel_launches"] > 0, f"{name}: the kernel launched 0 times")
        out[name] = dict(replicas=mt.num_replicas, brokers=mt.num_brokers,
                         card=runs[device], cpu=runs["cpu"])
    return out


def json_propose_phase(aggregate, props, device="cuda"):
    """The offline propose from a JSON snapshot: the generated cluster
    through builder_from_snapshot and save_json, held on the host to the
    NPZ snapshot of the same cluster bit for bit, then proposed from the
    JSON file by the CLI entry point."""
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS
    from cruise_control_tpu_torch.model.builder import builder_from_snapshot
    from cruise_control_tpu_torch.model.snapshot import (load_json, load_npz, save_json,
                                                         save_npz)
    from cruise_control_tpu_torch.model.state import state_to_numpy
    from cruise_control_tpu_torch.testing import random_cluster as rc
    with tempfile.TemporaryDirectory() as tmp:
        npz, jpath = os.path.join(tmp, "snap.npz"), os.path.join(tmp, "snap.json")
        save_npz(npz, *rc.generate(rc.ClusterProperties(**props), device="cpu"))
        st, pl, mt = load_npz(npz, device="cpu")
        t0 = time.monotonic()
        save_json(builder_from_snapshot(st, pl, mt), jpath)
        write_s = time.monotonic() - t0
        t0 = time.monotonic()
        packed, _ = load_json(jpath).freeze_packed()
        read_s = time.monotonic() - t0
        ref = state_to_numpy(st, pl)
        same = sorted(packed) == sorted(ref) and all(
            packed[k].dtype == ref[k].dtype and packed[k].tobytes() == ref[k].tobytes()
            for k in ref)
        check(same, "the JSON snapshot freezes to other arrays than the NPZ snapshot")
        size = os.path.getsize(jpath)
        aggregate.LAUNCHES = 0
        wall, doc = propose_once(jpath, DEFAULT_GOALS, device)
    launches = aggregate.LAUNCHES
    s = doc["summary"]
    check(launches > 0, "the JSON propose launched the aggregate kernel 0 times")
    check(not set(s["violatedGoalsAfter"]) & hard_names(DEFAULT_GOALS),
          f"JSON propose: hard goals violated after: {s['violatedGoalsAfter']}")
    check(len(doc["proposals"]) > 0, "JSON propose: no proposals at an unbalanced cluster")
    check_proposals(doc["proposals"])
    return dict(replicas=mt.num_replicas, brokers=mt.num_brokers, json_bytes=size,
                json_write_s=write_s, json_read_and_freeze_s=read_s,
                packed_equal_to_npz=same, wall_s=wall, elapsed_s=doc["elapsedSeconds"],
                kernel_launches=launches, violated_goals_after=s["violatedGoalsAfter"],
                balancedness=s["balancednessScore"], proposals=len(doc["proposals"]))


def lane_summary(res, wall, launches):
    import numpy as np
    lanes = res.num_scenarios
    return dict(lanes=lanes, wall_s=wall, wall_per_lane_s=wall / lanes,
                kernel_launches=launches, kernel_launches_per_lane=launches / lanes,
                goals=res.goal_names, preempted=res.preempted,
                rounds=res.rounds.tolist(), stranded_after=res.stranded_after.tolist(),
                violated_after=res.violated_after.sum(axis=1).tolist(),
                balancedness=[res.balancedness(s) for s in range(lanes)],
                succeeded=int(np.sum([res.succeeded(s) for s in range(lanes)])))


def run_lanes(aggregate, call, device):
    """(result, wall s, kernel launches) of one what-if batch."""
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    res = call()
    sync(device)
    return res, time.monotonic() - t0, aggregate.LAUNCHES


def check_removal(res, state, meta, goal_names, what, hard_goals=True):
    """Every lane evacuated its brokers (nothing stranded, no replica left on
    them) and, with ``hard_goals``, meets the hard goals among
    ``goal_names``."""
    import numpy as np
    valid = state.valid.cpu().numpy()
    hard = [i for i, g in enumerate(res.goal_names) if g in hard_names(goal_names)]
    for s, ids in enumerate(res.scenario_sets):
        rows = [meta.broker_index[b] for b in ids]
        brokers = res.placement_for(s).broker.cpu().numpy()[valid]
        check(int(res.stranded_after[s]) == 0, f"{what}, lane {s}: stranded "
              f"{int(res.stranded_after[s])}")
        check(not np.isin(brokers, rows).any(), f"{what}, lane {s}: {ids} not evacuated")
        check(not hard_goals or int(res.violated_after[s, hard].sum()) == 0,
              f"{what}, lane {s}: hard goals violated {res.violated_after[s].tolist()}")


def whatif_phase(aggregate, healthy, lanes, decommission, add_props, device="cuda"):
    """BASELINE config #5, yielding (run, summary) as each batch ends and
    checking it after: ``lanes`` single-broker removal lanes and one
    scenario removing ``decommission`` brokers at once, on the six hard
    goals over the healthy cluster — cold from the generated placement, as
    bench.py runs them, and warm from the hard goals' solve of it (lanes
    then only evacuate); then one add-broker batch at ``add_props`` scale,
    its candidates provisioned dead and emptied.  The generated cluster is
    not rack-aware, so a cold lane repairs the whole rack layout at the
    lanes' width as well: only the warm lanes are held to the hard goals."""
    import dataclasses
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_HARD_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing import random_cluster as rc
    st, pl, mt = rc.generate(rc.ClusterProperties(**healthy), device=device)
    opt = GoalOptimizer(goal_names=DEFAULT_HARD_GOALS)
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    solved = opt.optimizations(st, pl, mt)
    sync(device)
    yield "hard_goal_solve", dict(
        replicas=mt.num_replicas, brokers=mt.num_brokers, wall_s=time.monotonic() - t0,
        kernel_launches=aggregate.LAUNCHES, rounds=[i.rounds for i in solved.goal_infos],
        violated_goals_before=solved.violated_goals_before,
        violated_goals_after=solved.violated_goals_after)
    check(not solved.violated_goals_after, f"hard-goal solve: {solved.violated_goals_after}")
    for start, warm in (("cold", None), ("warm", solved.final_placement)):
        for name, sets in (("single_broker_lanes", [[b] for b in mt.broker_ids[:lanes]]),
                           ("decommission", [mt.broker_ids[:decommission]])):
            res, wall, launches = run_lanes(aggregate, lambda: opt.batch_remove_scenarios(
                st, pl, mt, sets, num_candidates=LANE_WIDTH, warm_start=warm), device)
            yield f"{name}_{start}", dict(replicas=mt.num_replicas, brokers=mt.num_brokers,
                                          brokers_removed=len(sets[0]),
                                          **lane_summary(res, wall, launches))
            check(launches > 0, f"{name} {start}: the kernel launched 0 times")
            check_removal(res, st, mt, DEFAULT_HARD_GOALS, f"{name} {start}",
                          hard_goals=warm is not None)
            del res
    del st, pl, solved
    st, pl, mt = rc.generate(rc.ClusterProperties(**add_props), device=device)
    cands = mt.broker_ids[-ADD_CANDIDATES:]
    opt = GoalOptimizer(goal_names=ADD_GOALS)
    base = opt.batch_remove_scenarios(st, pl, mt, [cands], num_candidates=LANE_WIDTH)
    check_removal(base, st, mt, ADD_GOALS, "add base")
    alive = st.alive.clone()
    alive[[mt.broker_index[b] for b in cands]] = False
    dead = dataclasses.replace(st, alive=alive)
    sets = [[cands[0]], [cands[1]], cands[2:], cands]
    res, wall, launches = run_lanes(aggregate, lambda: opt.batch_add_scenarios(
        dead, base.placement_for(0), mt, sets, num_candidates=LANE_WIDTH), device)
    valid = st.valid.cpu().numpy()
    received = [[int((res.placement_for(s).broker.cpu().numpy()[valid]
                      == mt.broker_index[b]).sum()) for b in cands] for s in range(len(sets))]
    yield "add_brokers", dict(replicas=mt.num_replicas, brokers=mt.num_brokers,
                              candidates=cands, received=received,
                              **lane_summary(res, wall, launches))
    check(launches > 0, "add_brokers: the kernel launched 0 times")
    for s, ids in enumerate(sets):
        for b, got in zip(cands, received[s]):
            check(got > 0 if b in ids else got == 0,
                  f"add_brokers, lane {s}: candidate {b} {'revived' if b in ids else 'dead'} "
                  f"holds {got} replicas")


def anytime_phase(aggregate, props, device="cuda"):
    """Budgeted solves of the default stack: cancelled before the start, a
    deadline at a third of the unbudgeted wall measured here, and one at
    ten times it."""
    import torch
    from cruise_control_tpu_torch.analyzer.budget import SolveBudget
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing import random_cluster as rc
    st, pl, mt = rc.generate(rc.ClusterProperties(**props), device=device)
    opt = GoalOptimizer()
    hard = hard_names(DEFAULT_GOALS)
    t0 = time.monotonic()
    opt.optimizations(st, pl, mt)
    sync(device)
    wall = time.monotonic() - t0
    out = dict(unbudgeted_wall_s=wall)
    cancelled = SolveBudget()
    cancelled.cancel("user")
    res = opt.optimizations(st, pl, mt, budget=cancelled)
    check(res.partial and not res.proposals and torch.equal(res.final_placement.broker, pl.broker)
          and all(i.preempted and i.rounds == 0 for i in res.goal_infos),
          "a cancel before the start did not return the input placement")
    out["cancel_before_start"] = dict(partial=res.partial, preempt_reason=res.preempt_reason,
                                      proposals=len(res.proposals))
    for name, scale in (("third_of_wall", 1 / 3), ("ten_times_wall", 10.0)):
        deadline_ms = wall * 1000.0 * scale
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        res = opt.optimizations(st, pl, mt, budget=SolveBudget(deadline_ms=deadline_ms))
        sync(device)
        took_ms = (time.monotonic() - t0) * 1000.0
        launches = aggregate.LAUNCHES
        ran = [i.goal_name for i in res.goal_infos if i.rounds > 0 or not i.preempted]
        stopped = [i for i in res.goal_infos if i.preempted]
        check(launches > 0, f"anytime {name}: the kernel launched 0 times")
        for i in res.goal_infos:
            check(i.goal_name not in hard or i.preempted or i.violated_brokers_after == 0,
                  f"anytime {name}: completed hard goal {i.goal_name} violated")
        check_proposals([p.to_dict() for p in res.proposals])
        if scale < 1:
            check(res.partial and stopped, f"anytime {name}: not partial ({took_ms:.1f} ms "
                  f"against a {deadline_ms:.1f} ms deadline)")
        else:
            check(not res.partial, f"anytime {name}: partial at ten times the wall")
        out[name] = dict(deadline_ms=deadline_ms, wall_ms=took_ms,
                         overshoot_ms=took_ms - deadline_ms, partial=res.partial,
                         preempt_reason=res.preempt_reason, goals_run=ran,
                         preempted_goals=[i.goal_name for i in stopped],
                         preempted_mid_goal=[i.goal_name for i in stopped if i.rounds > 0],
                         kernel_launches=launches, proposals=len(res.proposals),
                         violated_goals_after=res.violated_goals_after,
                         balancedness=res.balancedness_score)
    return out


def relax_phase(aggregate, props, lanes, device="cuda"):
    """The default stack with the relaxation path on, beside the greedy
    solve of the same cluster, then ``lanes`` removal lanes each way."""
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.relax import RelaxationConfig
    from cruise_control_tpu_torch.testing import random_cluster as rc
    st, pl, mt = rc.generate(rc.ClusterProperties(**props), device=device)
    hard = hard_names(DEFAULT_GOALS)
    out = {}
    for name, config in (("greedy", None), ("relax", RelaxationConfig())):
        opt = GoalOptimizer(relaxation=config)
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        res = opt.optimizations(st, pl, mt)
        sync(device)
        wall = time.monotonic() - t0
        launches = aggregate.LAUNCHES
        check(launches > 0, f"{name}: the kernel launched 0 times")
        check(not set(res.violated_goals_after) & hard,
              f"{name}: hard goals violated after: {res.violated_goals_after}")
        check_proposals([p.to_dict() for p in res.proposals])
        relaxed = [i for i in res.goal_infos if i.relaxed]
        for i in relaxed:
            check(i.metric_after <= i.metric_before * (1 + 1e-5) + 1e-9,
                  f"relaxed {i.goal_name} worsened: {i.metric_before} -> {i.metric_after}")
        check(config is None or relaxed, "no goal took the relaxation path")
        doc = res.to_dict()
        out[name] = dict(wall_s=wall, kernel_launches=launches,
                         violated_goals_after=res.violated_goals_after,
                         balancedness=res.balancedness_score, proposals=len(res.proposals),
                         replica_moves=doc["numInterBrokerReplicaMovements"],
                         leader_moves=doc["numLeaderMovements"],
                         relax_attempts=len(relaxed),
                         relax_fallbacks=sum(i.relax_fallback for i in relaxed),
                         fractional_moves=sum(i.relax_moves for i in relaxed),
                         relax_ms=sum(i.relax_ms for i in relaxed),
                         rounds=[i.rounds for i in res.goal_infos])
        sets = [[b] for b in mt.broker_ids[:lanes]]
        lres, lwall, llaunches = run_lanes(aggregate, lambda: opt.batch_remove_scenarios(
            st, pl, mt, sets, num_candidates=LANE_WIDTH), device)
        check(llaunches > 0, f"{name} lanes: the kernel launched 0 times")
        check_removal(lres, st, mt, DEFAULT_GOALS, f"{name} lanes")
        out[f"{name}_lanes"] = lane_summary(lres, lwall, llaunches)
    return out


def load_consistent(state, placement, agg):
    """The kernel-computed broker loads against a float64 numpy recompute
    from the placement (the verifier's LOAD_CONSISTENCY check)."""
    import numpy as np
    ll = state.leader_load.cpu().numpy().astype(np.float64)
    fl = state.follower_load.cpu().numpy().astype(np.float64)
    lead = placement.is_leader.cpu().numpy()
    eff = np.where(lead[:, None], ll, fl) * state.valid.cpu().numpy()[:, None]
    expect = np.zeros((state.num_brokers_padded, 4))
    np.add.at(expect, placement.broker.cpu().numpy(), eff)
    got = agg.broker_load.cpu().numpy()
    return bool(np.allclose(got, expect, rtol=1e-4, atol=1e-3)), float(np.abs(got - expect).max())


def device_profile(fn, iters=1):
    """Run ``fn`` ``iters`` times under torch.profiler: (wall ms, device busy
    ms summed over kernels and copies, {device op: (device ms, calls)})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name = {}
    for e in prof.key_averages():
        # Device-side entries only (kernels, copies): the aten:: op entries
        # repeat their kernels' time.
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            by_name[e.key] = (dev_us / 1e3, e.count)
    return wall_ms, sum(ms for ms, _ in by_name.values()), by_name


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "cruise_control_tpu_torch")):
        print("chip_smoke: the cruise_control_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "not measured"
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=card)

    from cruise_control_tpu_torch.analyzer.context import (
        aggregate_channels, build_context, compute_aggregates)
    from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS, goal_by_name
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
    from cruise_control_tpu_torch.model.snapshot import load_npz, save_npz
    from cruise_control_tpu_torch.model.state import Placement
    from cruise_control_tpu_torch.ops import aggregate
    from cruise_control_tpu_torch.testing import random_cluster as rc

    emit("build", seconds=aggregate.load_seconds(), ptxas=[
        line.strip() for line in aggregate.BUILD_LOG.splitlines()
        if "registers" in line or "smem" in line], sass_atomics=sass_atomics(aggregate))

    emit("host", us_per_call=host_costs(aggregate))
    for i, (r, k, b, kind) in enumerate(KERNEL_SHAPES):
        ch, br = random_channels(r, k, b, kind, seed=i)
        emit("kernel", name="broker_channel_sums", shape=[r, k, b], inputs=kind,
             **measure_kernel(aggregate, ch, br, b, kind))
        del ch, br
    for kind in ("uniform", "skewed"):
        emit("crossover", shape=["rows", 8, 200], inputs=kind,
             global_max_rows=aggregate.GLOBAL_MAX_ROWS, rows=crossover(aggregate, kind))

    # ---- the main path: propose at BASELINE #3, twice.
    hard = [g for g in DEFAULT_GOALS if goal_by_name(g).is_hard]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "baseline3.npz")
        state, placement, meta = rc.generate(rc.ClusterProperties(**BASELINE3), device="cpu")
        save_npz(path, state, placement, meta)
        runs = []
        for run in range(2):
            aggregate.LAUNCHES = 0
            wall, doc = propose_once(path, DEFAULT_GOALS)
            launches = aggregate.LAUNCHES
            s = doc["summary"]
            runs.append(dict(wall_s=wall, launches=launches, doc=doc))
            emit("propose", run=run, wall_s=wall, elapsed_s=doc["elapsedSeconds"],
                 replicas=meta.num_replicas, brokers=meta.num_brokers,
                 kernel_launches=launches,
                 goals=[{k: g[k] for k in ("goal", "rounds", "moves",
                                           "violatedBrokersBefore",
                                           "violatedBrokersAfter")}
                        for g in s["goals"]],
                 violated_goals_before=s["violatedGoalsBefore"],
                 violated_goals_after=s["violatedGoalsAfter"],
                 balancedness=s["balancednessScore"], proposals=len(doc["proposals"]),
                 replica_moves=s["numInterBrokerReplicaMovements"],
                 leader_moves=s["numLeaderMovements"])
            check(launches > 0, "the propose run launched the aggregate kernel 0 times")
            check(not set(s["violatedGoalsAfter"]) & set(hard),
                  f"hard goals violated after the run: {s['violatedGoalsAfter']}")
            check(len(doc["proposals"]) > 0, "no proposals at an unbalanced cluster")

        # The main path's kernel inputs: the snapshot's channels as
        # compute_aggregates builds them.
        cs, cp, _ = load_npz(path, device="cuda")
        main_kernel = measure_kernel(aggregate, aggregate_channels(cs, cp).contiguous(),
                                     cp.broker, cs.num_brokers_padded, "main path")
        emit("kernel", name="broker_channel_sums", shape="main path (BASELINE #3)",
             **main_kernel)

    # ---- the result is right: proposals are well formed, and on a small
    # cluster the CUDA run holds against the CPU run of the same code.
    check_proposals(runs[-1]["doc"]["proposals"])
    small = {}
    for dev in ("cuda", "cpu"):
        st, pl, mt = rc.generate(rc.ClusterProperties(**SMALL), device=dev)
        res = GoalOptimizer().optimizations(st, pl, mt)
        gctx = build_context(st, pl, mt, BalancingConstraint(), OptimizationOptions())
        agg = compute_aggregates(gctx, res.final_placement)
        small[dev] = (st, res, gctx, agg)
        check(not set(res.violated_goals_after) & set(hard),
              f"small cluster on {dev}: hard goals violated {res.violated_goals_after}")
    st, res, gctx, agg = small["cuda"]
    consistent, err = load_consistent(st, res.final_placement, agg)
    check(consistent, f"kernel loads disagree with the placement (max err {err})")
    # The same final placement aggregated by the plain version on the CPU.
    _, _, gctx_cpu, _ = small["cpu"]
    fin = res.final_placement
    cpu_pl = Placement(broker=fin.broker.cpu(), disk=fin.disk.cpu(),
                       is_leader=fin.is_leader.cpu())
    agg_cpu = compute_aggregates(gctx_cpu, cpu_pl)
    same = all(torch.allclose(getattr(agg, f).cpu().float(), getattr(agg_cpu, f).float(), **TOL)
               for f in ("broker_load", "host_load", "replica_counts", "leader_counts",
                         "potential_nw_out", "leader_bytes_in", "topic_counts"))
    check(same, "CUDA and CPU aggregates of the same placement disagree")
    emit("check", small_cuda_violated_after=res.violated_goals_after,
         small_cpu_violated_after=small["cpu"][1].violated_goals_after,
         small_cuda_balancedness=res.balancedness_score,
         small_cpu_balancedness=small["cpu"][1].balancedness_score,
         load_consistency_max_err=err, cuda_vs_cpu_aggregates_allclose=same)

    # ---- where the time goes in one propose run (torch.profiler; its
    # tracing slows the host side).
    st, pl, mt = rc.generate(rc.ClusterProperties(**BASELINE3), device="cuda")
    profiled = []
    wall_ms, busy_ms, pprof = device_profile(
        lambda: profiled.append(GoalOptimizer().optimizations(st, pl, mt)))
    top = sorted(pprof.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", propose_wall_ms_profiled=wall_ms, propose_device_busy_ms=busy_ms,
         propose_device_idle_share=1.0 - busy_ms / wall_ms,
         propose_device_ops=sum(c for _, c in pprof.values()),
         top_device_ms=[[k[:80], round(ms, 4), c] for k, (ms, c) in top])

    # ---- a swap tile on the card against the CPU, behind the stack's
    # first seven goals.
    emit("swap", **swap_tile_check(aggregate, BASELINE3))

    # ---- every goal outside the default stack.
    for name, summary in other_goal_sets(aggregate, profiled[0].final_placement).items():
        emit("goals", run=name, **summary)

    # ---- the north-star cluster, once, on the default stack.
    summary, _ = run_goals(aggregate, NORTH_STAR, DEFAULT_GOALS, "cuda")
    emit("north_star", **summary)

    # ---- BASELINE #1: the DeterministicCluster fixtures on the builder.
    emit("deterministic", **deterministic_phase(aggregate))

    # ---- the offline propose from a JSON snapshot at BASELINE #3.
    emit("json_propose", **json_propose_phase(aggregate, BASELINE3))

    # ---- BASELINE #5: remove-broker what-ifs, then an add-broker batch.
    for name, summary in whatif_phase(aggregate, HEALTHY, WHATIF_LANES, DECOMMISSION,
                                      BASELINE3):
        emit("whatif", run=name, **summary)

    # ---- budgeted (anytime) solves, and the relaxation path.
    emit("anytime", **anytime_phase(aggregate, BASELINE3))
    emit("relax", **relax_phase(aggregate, BASELINE3, RELAX_LANES))

    print(json.dumps({"kernels": [{
        "name": "broker_channel_sums",
        "route": "cuda",
        "source": "cruise_control_tpu_torch/ops/csrc/aggregate.cu",
        "replaces": "cruise_control_tpu/ops/pallas_aggregate.py:75",
        "launches": runs[-1]["launches"],
        "max_abs_err": main_kernel["max_abs_err"],
        "ms": main_kernel["kernel_ms"],
        "device_ms": main_kernel["device_ms"],
        "plain_ms": main_kernel["plain_ms"],
        "bound_ms": main_kernel["bound_ms"],
        "bound_by": main_kernel["bound_by"],
        "library_ms": main_kernel["library_ms"],
        "library_device_ms": main_kernel["library_device_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
