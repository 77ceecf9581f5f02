#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernel from the sources in this checkout,
holds it against its plain PyTorch version at the shapes the main path and
the north-star cluster give it, drives the offline propose path (the
``run_propose`` entry point) at BASELINE config #3 (200 brokers, 50K
replicas) on the slice's goal stack, counts the kernel launches that run
made, and checks the result.  Prints one JSON object per phase; the last
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
# The small cluster on which the CUDA run is held against the CPU run.
SMALL = dict(num_brokers=20, num_racks=5, num_topics=50, num_replicas=2000,
             mean_cpu=0.005, mean_disk=2100.0, mean_nw_in=2000.0,
             mean_nw_out=2000.0, seed=11)
KERNEL_SHAPES = [(1613, 8, 37), (50_000, 8, 200), (1_000_000, 8, 2600),
                 (1_000_000, 8, 8192)]


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


def bound(r, k, b):
    """(ms, 'bytes' | 'operations'): the least time for one channel sum:
    read R*(K*4 + 4) bytes, write B*K*4, and do R*K float32 adds."""
    t_bytes = (r * (k * 4 + 4) + b * k * 4) / HBM_BYTES_PER_S
    t_ops = r * k / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def measure_kernel(aggregate, ch, br, b, synthetic=True):
    """Kernel against its plain version (and a float64 sum) on the same
    inputs: errors and times."""
    import torch
    got = aggregate.broker_channel_sums(ch, br, b)
    ref = aggregate.broker_channel_sums_plain(ch, br, b)
    ref64 = aggregate.broker_channel_sums_plain(ch.double(), br, b)
    torch.cuda.synchronize()
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
    # Worst-case f32 rounding of an n-term sum in any order:
    # |s - s64| <= (n - 1) * 2^-24 * sum |x|, per broker and channel.
    n = aggregate.broker_channel_sums_plain(
        torch.ones(r, 1, dtype=torch.float64, device=ch.device), br, b)
    f32_bound = (n - 1).clamp(min=0) * 2.0 ** -24 * aggregate.broker_channel_sums_plain(
        ch.double().abs(), br, b)
    out = dict(
        max_abs_err=float(diff.max()),
        max_rel_err=float((diff[big] / ref[big].abs()).max()) if bool(big.any()) else 0.0,
        max_abs_err_vs_f64=float((got.double() - ref64).abs().max()),
        plain_max_abs_err_vs_f64=float((ref.double() - ref64).abs().max()),
        within_f32_bound=bool(((got.double() - ref64).abs() <= f32_bound + 1e-9).all()),
        allclose=bool(torch.allclose(got, ref, **TOL)),
        library_allclose=bool(torch.allclose(lib, ref, **TOL)),
        counts_exact=bool(torch.equal(got[:, 4:6], ref[:, 4:6])) if k >= 6 else None,
        kernel_ms=cuda_ms(lambda: aggregate.broker_channel_sums(ch, br, b)),
        kernel_device_ms=sum(ms for name, (ms, _) in device_profile(
            lambda: aggregate.broker_channel_sums(ch, br, b), 20)[2].items()
            if "channel_sums" in name) / 20,
        plain_ms=cuda_ms(lambda: aggregate.broker_channel_sums_plain(ch, br, b)),
        library_ms=cuda_ms(lambda: zeros.index_add(0, br_l, ch_m)),
        bound_ms=bound_ms, bound_by=bound_by,
        launch_shape=list(aggregate.launch_shape(r, k, b)),
    )
    # Any order of f32 sums stays within this bound of the float64 sum; on
    # real loads (sums ~2e4) kernel and plain may differ by more than the
    # rtol=1e-6 bar while both are within it.
    check(out["within_f32_bound"], f"kernel outside the f32 bound at {(r, k, b)}: {out}")
    if synthetic:
        # Normal-distributed channels: tests/test_ops.py's bar against plain.
        check(out["allclose"], f"kernel disagrees with plain at {(r, k, b)}: {out}")
    if k >= 6:
        check(out["counts_exact"], f"count channels not exact at {(r, k, b)}")
    return out


def random_channels(r, k, b, ragged, seed):
    """Channels shaped like compute_aggregates' (normal loads, 0/1 counts)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    ch = torch.randn(r, k, device="cuda", generator=g)
    ch[:, 4] = 1.0
    ch[:, 5] = (torch.rand(r, device="cuda", generator=g) < 0.34).float()
    lo, hi = (-3, b + 3) if ragged else (0, b)
    br = torch.randint(lo, hi, (r,), device="cuda", generator=g, dtype=torch.int32)
    return ch, br


def propose_once(path, goals):
    """One run of the CLI entry point; returns (wall s, parsed JSON)."""
    import torch
    from cruise_control_tpu_torch.client.propose import run_propose
    out = io.StringIO()
    args = SimpleNamespace(snapshot=path, goals=",".join(goals), device="cuda",
                           verbose=True)
    t0 = time.monotonic()
    rc = run_propose(args, out)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check(rc == 0, f"run_propose exited {rc} (OptimizationFailureError or bad input)")
    return wall, json.loads(out.getvalue())


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
        if "registers" in line or "smem" in line])

    for i, (r, k, b) in enumerate(KERNEL_SHAPES):
        ch, br = random_channels(r, k, b, ragged=(i == 0), seed=i)
        emit("kernel", name="broker_channel_sums", shape=[r, k, b],
             **measure_kernel(aggregate, ch, br, b))
        del ch, br

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
                                     cp.broker, cs.num_brokers_padded, synthetic=False)
        emit("kernel", name="broker_channel_sums", shape="main path (BASELINE #3)",
             **main_kernel)

    # ---- the result is right: proposals are well formed, and on a small
    # cluster the CUDA run holds against the CPU run of the same code.
    for p in runs[-1]["doc"]["proposals"]:
        check(len(set(p["newReplicas"])) == len(p["newReplicas"]) == len(p["oldReplicas"])
              and p["oldLeader"] in p["oldReplicas"], f"malformed proposal {p}")
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
    wall_ms, busy_ms, pprof = device_profile(lambda: GoalOptimizer().optimizations(st, pl, mt))
    top = sorted(pprof.items(), key=lambda kv: -kv[1][0])[:12]
    emit("profile", propose_wall_ms_profiled=wall_ms, propose_device_busy_ms=busy_ms,
         propose_device_idle_share=1.0 - busy_ms / wall_ms,
         propose_device_ops=sum(c for _, c in pprof.values()),
         top_device_ms=[[k[:80], round(ms, 4), c] for k, (ms, c) in top])

    print(json.dumps({"kernels": [{
        "name": "broker_channel_sums",
        "route": "cuda",
        "source": "cruise_control_tpu_torch/ops/csrc/aggregate.cu",
        "replaces": "cruise_control_tpu/ops/pallas_aggregate.py:75",
        "launches": runs[-1]["launches"],
        "max_abs_err": main_kernel["max_abs_err"],
        "ms": main_kernel["kernel_ms"],
        "plain_ms": main_kernel["plain_ms"],
        "bound_ms": main_kernel["bound_ms"],
        "bound_by": main_kernel["bound_by"],
        "library_ms": main_kernel["library_ms"],
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
