#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards N     # the multi-card solve alone, N >= 2 cards

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
(BASELINE config #5), budgeted solves and the relaxation path.  Then the
load monitor (synthetic windows to a model on the card, a propose, and the
resident model's delta apply when a broker dies) at BASELINE #3; on the
monitor's cluster then the executor and the detectors: the goal-violation
solves, the hard goals' solve judged by the verifier on the card and
executed through the fake admin backend (and a share of it through the
broker simulator's process), and a broker failure detected and fixed by a
self-healing round through the facade's fix; then the facade itself
(``CruiseControl`` from ``CruiseControlConfig``) on a fresh monitored
cluster: every operation, the precompute daemon, self-healing and the
shutdown drain; then the REST server (``CruiseControlApp``, basic
security) in front of a facade at BASELINE #3, driven over HTTP by the CLI
client (``POST /rebalance?dryrun=true&explain=true`` among its requests),
and the service's entry point (``python -m cruise_control_tpu_torch.main
--demo``) as a process, stopped by SIGTERM; then the ingestion edge at
BASELINE #3 (``main.build_app`` in reporter mode: 200 reporter agents, a
share of them publishing from a child process over the authenticated TCP
bus, the consuming sampler, the model on the card and a rebalance over HTTP,
a restart that replays the log sample store, a maintenance plan fixed
through the broker simulator's process, and the Prometheus sampler); then
the platform layers at BASELINE #3 (``main.build_app`` with the warmup
daemon on, the lane-chunk planner, the memory ledger and its headroom guard,
one injected device failover; the service's persistent kernel-build cache is
started twice in the ``main`` phase); the
resident steady state of bench config #6 at 1M replicas; multi-process solves at
BASELINE #3 (``parallel``: ``propose_multihost`` and a what-if batch at world
size 1 over NCCL, with the collectives counted and timed, and at world size 2
over gloo in two processes on the one card); and the scenario fuzzer
(``fuzz``: the fixed-seed corpus with every invariant, one storm cycle, bench
config #9's execution).  With ``--cards N`` it runs only the sharded solve
over NCCL, one rank a card, at world size 2 and N.  Each phase counts the kernel's launches.  Prints one JSON object
per phase; the last line is ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, when CUDA is unavailable or the port's package
is not beside this script, and whenever a check fails.
"""

import base64
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
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
# The monitor phase at BASELINE #3: windows of synthetic samples (window
# length, windows kept, windows bootstrapped), the completeness asked for,
# and the capacities' headroom: the mean broker's synthetic load is this
# share of each capacity.
MONITOR_WINDOW_MS = 1000
MONITOR_WINDOWS = 5
MONITOR_BOOTSTRAP_WINDOWS = 6
MONITOR_MIN_WINDOWS = 3
MONITOR_MIN_PARTITIONS = 0.9
MONITOR_MEAN_LOAD_SHARE = 0.4
# The soft goals whose no-worsen verdict the monitor phase accepts from the
# default stack on the synthetic loads: the JAX package gives these verdicts on
# the phase's model too (tests/test_torch_monitor.py, scripts/monitor_verdicts.py).
MONITOR_NO_WORSEN_GOALS = ("NetworkOutboundUsageDistributionGoal", "CpuUsageDistributionGoal")
# Bench config #6 (bench.py:849-1016): the resident steady state on the
# healthy north-star cluster, its six hard goals, 64 partitions' loads
# changed a round, three timed rounds after one untimed.
# The executor phases on the monitor's cluster: progress polled every
# millisecond, a bounded wait for each execution, and the share of the
# solve's proposals sent through the broker simulator's process (with this
# replication throttle).
EXECUTE_POLL_S = 0.001
EXECUTE_TIMEOUT_S = 300
EXECUTE_MAX_MOVES = 100_000
SUBPROCESS_PROPOSALS = 500
SUBPROCESS_THROTTLE_BYTES_PER_S = 50_000_000
# The facade phase: CruiseControl built from the port's CruiseControlConfig
# on a fresh monitored BASELINE #3 cluster.  Its default goals are the hard
# goals and replica distribution (no load-distribution goal, whose no-worsen
# verdict the synthetic loads can fail); the precompute daemon ticks every
# second; the first anomaly-detection round comes after operations (a)-(e),
# self-healing is on for broker failures only, with zero grace; a delta may
# the executor polls every millisecond with no cap on a batch.  The monitor
# tick of (b) completes one window in which FACADE_HOT_PARTITIONS partitions
# carry FACADE_HOT_FACTOR times their load (the synthetic sampler's loads are
# otherwise the same every window).
FACADE_CONFIG = {
    "default.goals": ",".join(["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
                               "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal",
                               "CpuCapacityGoal", "ReplicaDistributionGoal"]),
    "anomaly.detection.goals": "RackAwareGoal",
    "proposal.expiration.ms": "1000",
    "anomaly.detection.interval.ms": "30000",
    "broker.failure.alert.threshold.ms": "0",
    "broker.failure.self.healing.threshold.ms": "0",
    "execution.progress.check.interval.ms": "1",
    "max.num.cluster.movements": str(EXECUTE_MAX_MOVES),
    "solver.shutdown.grace.ms": "5000",
    # No phase reads the sensor history rings (the SLO evaluator's input).
    "obs.history.enabled": "false",
    # The warmup daemon only where a phase is about it (``platform``): the
    # phases built on this config ran without one while compile.* was inert.
    "compile.warmup.enabled": "false",
}
FACADE_WAIT_S = 120
FACADE_HOT_PARTITIONS = 64
FACADE_HOT_FACTOR = 1.5
# The servlet phase: FACADE_CONFIG without the precompute daemon (so each
# request's kernel launches are its own) and without an anomaly-detection
# round inside the phase; one ADMIN user for basic security; the default
# goals' rebalance carries a deadline it should not reach; the profile
# window holds one dry-run rebalance.
SERVLET_CONFIG = dict(FACADE_CONFIG, **{"proposal.expiration.ms": "0",
                                        "anomaly.detection.interval.ms": "600000"})
SERVLET_USER = ("smoke-admin", "smoke-password")
SERVLET_DEADLINE_MS = 60_000
SERVLET_PROFILE_S = 2.0
# The main phase: the demo service's properties (small windows, so the
# model is ready seconds after start; the hard goals and replica
# distribution, as in FACADE_CONFIG), how long its start and first
# successful rebalance may take, and how soon SIGTERM must end it.
MAIN_PROPERTIES = {
    "partition.metrics.window.ms": "400",
    "metric.sampling.interval.ms": "150",
    "default.goals": FACADE_CONFIG["default.goals"],
    "compile.warmup.enabled": "false",
}
# The main phase's second and third starts: the persistent kernel-build
# cache on, under this directory (git-ignored with the rest of ops/_build/).
MAIN_CACHE_DIR = os.path.join(REPO, "cruise_control_tpu_torch", "ops", "_build",
                              "smoke-compile-cache")
MAIN_TIMEOUT_S = 120
MAIN_EXIT_S = 30
# The ingest phase: the service main.build_app wires in reporter mode over
# BASELINE #3's cluster, with FACADE_CONFIG's executor settings and its hard
# goals as the default goals (a maintenance fix then moves what the removal
# needs, not a rebalance's thousands of moves through the simulator).
# The reporter and sampling threads never fire (an hour's interval): the
# phase's clock drives INGEST_ROUNDS reporting rounds, one a 1-s window, into
# INGEST_WINDOWS windows, each round drained by sampling ticks inside its
# window (a tick polls at most 10,000 records a bus partition).  A child
# process publishes INGEST_TCP_SHARE of the brokers' records over
# authenticated TCP; the log store replays with num.metric.fetchers loaders.
INGEST_WINDOW_MS = 1000
INGEST_WINDOWS = 2
INGEST_ROUNDS = 3
INGEST_TCP_SHARE = 0.05
INGEST_MAX_TICKS = 10
INGEST_CONFIG = dict(FACADE_CONFIG, **{
    "default.goals": FACADE_CONFIG["default.goals"].replace(",ReplicaDistributionGoal", ""),
    "metric.sampler.mode": "reporter", "num.metric.fetchers": "4",
    "metric.sampling.interval.ms": "3600000",
    "partition.metrics.window.ms": str(INGEST_WINDOW_MS),
    "broker.metrics.window.ms": str(INGEST_WINDOW_MS),
    "num.partition.metrics.windows": str(INGEST_WINDOWS),
    "num.broker.metrics.windows": str(INGEST_WINDOWS),
    "min.samples.per.partition.metrics.window": "1",
    "proposal.expiration.ms": "0", "anomaly.detection.interval.ms": "600000"})
# The child publisher: refused with a wrong secret, then, for each staged
# segment-file directory named on its stdin, every record appended over TCP
# to the same bus partition; one JSON line a directory.
INGEST_CHILD = r"""
import json, sys, time
from cruise_control_tpu_torch.reporter.transport import FileTransport, SocketTransport
from cruise_control_tpu_torch.utils.netsec import read_secret_file
addr, secret = sys.argv[1], read_secret_file(sys.argv[2])
try:
    SocketTransport(addr, auth_secret=secret + "-wrong").num_partitions
    refused = False
except ConnectionError:
    refused = True
bus = SocketTransport(addr, auth_secret=secret)
print(json.dumps({"wrong_secret_refused": refused, "partitions": bus.num_partitions}),
      flush=True)
for line in sys.stdin:
    staged = FileTransport(line.strip(), bus.num_partitions)
    t0, n = time.perf_counter(), 0
    for p in range(bus.num_partitions):
        offset = 0
        while True:
            recs, offset = staged.poll(p, offset)
            if not recs:
                break
            for rec in recs:
                bus.append(p, rec)
                n += 1
    print(json.dumps({"records": n, "seconds": time.perf_counter() - t0}), flush=True)
bus.close()
"""
# The platform phase: the servlet phase's service (no precompute daemon, no
# anomaly round inside the phase) with the warmup daemon on, warming the
# 4-lane width; the remove batch's lanes (a broker each); how long the warmup
# may take; the injected device-loss and kernel-fault errors (the CUDA
# runtime's error string and enum name, worded as torch words a real error)
# and the goal of the solves they hit.
PLATFORM_CONFIG = dict(SERVLET_CONFIG, **{"compile.warmup.enabled": "true",
                                          "compile.warmup.lanes": "4"})
PLATFORM_LANES = 16
PLATFORM_PADDED_LANES = 6       # on 4-lane blocks: 4 + (2 real, 2 padding)
PLATFORM_WARMUP_S = 600
PLATFORM_DEVICE_LOSS = ("uncorrectable ECC error encountered", "cudaErrorECCUncorrectable")
PLATFORM_KERNEL_FAULT = ("an illegal memory access was encountered", "cudaErrorIllegalAddress")
PLATFORM_FAILOVER_GOAL = "RackAwareGoal"
# The parallel phase at BASELINE #3: removal lanes of its what-if batch, and
# the bound on the two gloo ranks' child processes.
PARALLEL_LANES = 4
PARALLEL_CHILD_TIMEOUT_S = 600
PARALLEL_CHILD = r"""
import hashlib, json, sys, time
import torch, torch.distributed as dist
rank, addr = int(sys.argv[1]), sys.argv[2]
props, pads, lanes, width = (json.loads(sys.argv[3]), json.loads(sys.argv[4]),
                             int(sys.argv[5]), int(sys.argv[6]))
device, world, backend = sys.argv[7], int(sys.argv[8]), sys.argv[9]
compare = sys.argv[10] == "1"
from cruise_control_tpu_torch.parallel import mesh, multihost
if backend == "nccl":       # one rank a card
    multihost.initialize(addr, world, rank, device="cuda")
else:
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", world_size=world, rank=rank)
from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS, DEFAULT_HARD_GOALS
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.ops import aggregate
from cruise_control_tpu_torch.testing import random_cluster as rc
from cruise_control_tpu_torch.testing.verifier import verify_placement
st, pl, mt = rc.generate(rc.ClusterProperties(**props), *pads, device=device)
given = pl if rank == 0 else pl.replace(broker=torch.zeros_like(pl.broker))
out = {"rank": rank, "card": str(st.valid.device)}
calls = [("propose", lambda: multihost.propose_multihost(st, given, mt, goal_names=DEFAULT_GOALS))]
if compare:     # warm: the sharded propose again, then the unsharded one on this card
    calls += [("propose_warm", calls[0][1]),
              ("unsharded", lambda: GoalOptimizer(goal_names=DEFAULT_GOALS).optimizations(
                  st, pl, mt))]
calls.append(("lanes", lambda: multihost.batch_remove_scenarios_multihost(
    st, given, mt, [[b] for b in mt.broker_ids[:lanes]],
    goal_names=DEFAULT_HARD_GOALS, scenario_parallelism=2, num_candidates=width)))
for name, call in calls:
    mesh.reset_calls()
    aggregate.LAUNCHES = 0
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic()
    res = call()
    if device == "cuda":
        torch.cuda.synchronize()
    out[name] = {"wall_s": time.monotonic() - t0, "kernel_launches": aggregate.LAUNCHES,
                 "collectives": dict(mesh.CALLS)}
    if name != "lanes":
        fin = res.final_placement
        failures = verify_placement(st, pl, mt, fin, goal_names=DEFAULT_HARD_GOALS,
                                    goal_infos=res.goal_infos)
        out[name].update(
            violated_goals_after=res.violated_goals_after, proposals=len(res.proposals),
            balancedness=res.balancedness_score, verifier=[str(f) for f in failures],
            digest=hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in (
                fin.broker, fin.disk, fin.is_leader))).hexdigest())
    else:
        valid = st.valid
        out[name].update(
            stranded_after=res.stranded_after.tolist(),
            violated_after=res.violated_after.tolist(),
            evacuated=[not bool(torch.isin(res.placement_for(s).broker[valid], torch.tensor(
                [mt.broker_index[b] for b in ids], device=valid.device)).any())
                for s, ids in enumerate(res.scenario_sets)],
            digest=hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in (
                res.final_placements.broker, res.final_placements.disk,
                res.final_placements.is_leader))).hexdigest())
print("RESULT " + json.dumps(out), flush=True)
dist.destroy_process_group()
"""
# The fuzz phase: the fixed-seed corpus (one scenario a kind from this seed),
# the storm's scenario, and bench config #9's stack (bench.py:800-830).
FUZZ_BASE_SEED = 100
FUZZ_STORM_SEED = 205
FUZZ_BENCH9_SEED = 3146
FUZZ_BENCH9_PARTITIONS = 48
FUZZ_IDLE_S = 120
RESIDENT = dict(HEALTHY, seed=3143)
RESIDENT_MUTATIONS = 64
RESIDENT_ROUNDS = 3
RESIDENT_MUTATION_SEED = 314159
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
    graphs = round_graph_counts()
    if graphs is not None:
        kw["round_graphs"] = graphs
    print(json.dumps({"phase": phase, **kw}), flush=True)


_GRAPH_COUNTS = {}


def round_graph_counts():
    """The solver's round-graph counters in this process since the last
    call: captures, replays, eager rounds and failed captures; None before
    the solver is loaded, or where it keeps no round graphs."""
    solver = sys.modules.get("cruise_control_tpu_torch.analyzer.solver")
    sensors = getattr(solver, "ROUND_GRAPH_SENSORS", None)
    if sensors is None:
        return None
    from cruise_control_tpu_torch.common.metrics import registry
    out = {}
    for name in sensors:
        now = registry().counter(name).count
        out[name.rsplit(".", 1)[1]] = now - _GRAPH_COUNTS.get(name, 0)
        _GRAPH_COUNTS[name] = now
    return out


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
    # The solver's round graphs (where it keeps them): how many, and the
    # bytes of their static buffers and pools.
    graphs = [g for g in getattr(optimizer.solver, "_graphs", {}).values()
              if g.graph is not None]
    return dict(
        replicas=mt.num_replicas, brokers=mt.num_brokers, wall_s=wall,
        round_graphs=len(graphs), round_graph_bytes=sum(g.nbytes for g in graphs),
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


def span_ms(rollup, name):
    """(count, total ms) of one span name in a tracer rollup."""
    row = rollup.get(name, {"count": 0, "total_ms": 0.0})
    return row["count"], row["total_ms"]


def packed_equal(a, b):
    """Two packed dicts of arrays equal in names, dtypes, shapes and bytes."""
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in b)


def metadata_backend(builder):
    """The port's fake metadata backend for a built cluster: brokers with
    their rack and host, partitions with leader, replicas (in replica-list
    order) and ISR."""
    from cruise_control_tpu_torch.monitor.metadata import (BrokerInfo, FakeMetadataBackend,
                                                           PartitionInfo)
    brokers = [BrokerInfo(b.broker_id, rack=b.rack, host=b.host, alive=b.alive)
               for b in builder.brokers()]
    parts = []
    for (t, p), reps in builder.partitions().items():
        ids = tuple(r.broker_id for r in reps)
        leader = next((r.broker_id for r in reps if r.is_leader), None)
        parts.append(PartitionInfo(topic=t, partition=p, leader=leader, replicas=ids,
                                   in_sync=ids))
    return FakeMetadataBackend(brokers, parts)


def synthetic_capacity(sampler, replicas, partitions, brokers):
    """Capacities at which the mean broker's synthetic load (the sampler's
    mean rates at jitter 1, every partition led once, followers at the CPU
    model's follower share) is MONITOR_MEAN_LOAD_SHARE of each resource."""
    from cruise_control_tpu_torch.common.resources import Resource
    from cruise_control_tpu_torch.model.cpu_model import follower_cpu_from_leader_load
    follower_cpu = follower_cpu_from_leader_load(sampler.mean_bytes_in, sampler.mean_bytes_out,
                                                 sampler.cpu_per_partition)
    followers = replicas - partitions
    mean = {Resource.CPU: partitions * sampler.cpu_per_partition + followers * follower_cpu,
            Resource.NW_IN: replicas * sampler.mean_bytes_in,
            Resource.NW_OUT: partitions * sampler.mean_bytes_out,
            Resource.DISK: replicas * sampler.mean_size}
    return {r: v / brokers / MONITOR_MEAN_LOAD_SHARE for r, v in mean.items()}


def solve_summary(aggregate, res, wall, hard):
    """The checks and numbers of one propose: hard goals met, proposals
    well formed, the kernel launched."""
    launches = aggregate.LAUNCHES
    check(launches > 0, "the aggregate kernel launched 0 times")
    check(not set(res.violated_goals_after) & hard,
          f"hard goals violated after: {res.violated_goals_after}")
    check_proposals([p.to_dict() for p in res.proposals])
    return dict(wall_s=wall, kernel_launches=launches,
                violated_goals_after=res.violated_goals_after,
                balancedness=res.balancedness_score, proposals=len(res.proposals))


def monitored_cluster(props):
    """A generated cluster behind the port's load monitor: the fake metadata
    backend, capacities from ``synthetic_capacity``, and
    MONITOR_BOOTSTRAP_WINDOWS windows of synthetic samples bootstrapped
    through the task runner (completeness checked)."""
    from cruise_control_tpu_torch.model.builder import builder_from_snapshot
    from cruise_control_tpu_torch.monitor.capacity import FixedBrokerCapacityResolver
    from cruise_control_tpu_torch.monitor.load_monitor import (LoadMonitor,
                                                               ModelCompletenessRequirements)
    from cruise_control_tpu_torch.monitor.metadata import MetadataClient
    from cruise_control_tpu_torch.monitor.sampler import SyntheticWorkloadSampler
    from cruise_control_tpu_torch.monitor.task_runner import LoadMonitorTaskRunner
    from cruise_control_tpu_torch.testing import random_cluster as rc
    st, pl, mt = rc.generate(rc.ClusterProperties(**props), device="cpu")
    backend = metadata_backend(builder_from_snapshot(st, pl, mt))
    del st, pl
    sampler = SyntheticWorkloadSampler()
    capacity = synthetic_capacity(sampler, mt.num_replicas, mt.num_partitions, mt.num_brokers)
    lm = LoadMonitor(MetadataClient(backend, ttl_ms=0),
                     capacity_resolver=FixedBrokerCapacityResolver(capacity),
                     num_windows=MONITOR_WINDOWS, window_ms=MONITOR_WINDOW_MS,
                     min_samples_per_window=1)
    runner = LoadMonitorTaskRunner(lm, sampler, sampling_interval_ms=MONITOR_WINDOW_MS)
    t0 = time.monotonic()
    ingested = runner.bootstrap(0, MONITOR_BOOTSTRAP_WINDOWS * MONITOR_WINDOW_MS)
    bootstrap_s = time.monotonic() - t0
    check(lm.meet_completeness_requirements(ModelCompletenessRequirements(
        MONITOR_MIN_WINDOWS, MONITOR_MIN_PARTITIONS)), "monitor: completeness not met")
    return SimpleNamespace(lm=lm, backend=backend, runner=runner, meta=mt, capacity=capacity,
                           ingested=ingested, bootstrap_s=bootstrap_s)


def monitor_phase(aggregate, props, device="cuda"):
    """The load monitor on a generated cluster: windows of synthetic samples
    bootstrapped through the task runner, the model frozen onto ``device``
    and onto the CPU (equal bit for bit), a propose on the default stack and
    one on the hard goals, then the resident path: the kept builder and the
    resident service give the same tensors when nothing changed, and one
    delta apply, equal to a fresh freeze, when a broker dies; the default
    stack's re-propose empties that broker.  Returns the phase's numbers and
    its cluster (the monitor, the fake metadata backend, the dead broker)
    for the phases that follow."""
    from cruise_control_tpu_torch.analyzer.goals.registry import (DEFAULT_GOALS,
                                                                   DEFAULT_HARD_GOALS)
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.common.exceptions import OptimizationFailureError
    from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
    from cruise_control_tpu_torch.model.resident import ResidentModelService
    from cruise_control_tpu_torch.model.state import state_to_numpy
    from cruise_control_tpu_torch.obsvc.tracer import tracer
    hard = hard_names(DEFAULT_GOALS)
    pad = ShapeBucketPolicy().pad_targets
    cluster = monitored_cluster(props)
    lm, backend, mt, capacity = cluster.lm, cluster.backend, cluster.meta, cluster.capacity
    ingested, bootstrap_s = cluster.ingested, cluster.bootstrap_s
    t0 = time.monotonic()
    agg_res = lm.partition_aggregator.aggregate(-float("inf"), float("inf"))
    aggregate_ms = (time.monotonic() - t0) * 1e3
    out = dict(replicas=mt.num_replicas, partitions=mt.num_partitions, brokers=mt.num_brokers,
               capacity={r.name: v for r, v in capacity.items()}, samples_ingested=ingested,
               bootstrap_s=bootstrap_s, aggregate_ms=aggregate_ms,
               valid_windows=agg_res.completeness.valid_windows,
               valid_partition_ratio=agg_res.completeness.valid_entity_ratio)
    frozen = {}
    for dev in (device, "cpu"):
        t0 = time.monotonic()
        frozen[dev] = lm.cluster_model(pad_fn=pad, device=dev)
        sync(dev)
        out[f"cluster_model_s_{'card' if dev == device else 'cpu'}"] = time.monotonic() - t0
    cs, cp, cm = frozen[device]
    same = packed_equal(state_to_numpy(cs, cp), state_to_numpy(*frozen["cpu"][:2]))
    out["card_and_cpu_freezes_equal"] = same
    check(same, "monitor: the card's freeze differs from the CPU's")
    check(cs.device.type == str(device).split(":")[0], "monitor: the model is not on the device")
    # The default stack on the healthy model.  On the synthetic sampler's
    # loads both packages' no-worsen verdict can fail a goal of
    # MONITOR_NO_WORSEN_GOALS (a partition's replicas share one load vector,
    # only leaders carry NW_OUT): that outcome is recorded; any other failure
    # fails the phase.  The hard goals' propose is checked.
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    try:
        res = GoalOptimizer().optimizations(cs, cp, cm, model_generation=lm.model_generation)
        sync(device)
        out["propose_default_stack"] = solve_summary(aggregate, res, time.monotonic() - t0, hard)
    except OptimizationFailureError as e:
        sync(device)
        check(any(str(e).startswith(f"[{g}] optimized result is worse than before")
                  for g in MONITOR_NO_WORSEN_GOALS), f"monitor: the default stack failed: {e}")
        check(aggregate.LAUNCHES > 0, "monitor: the aggregate kernel launched 0 times")
        out["propose_default_stack"] = dict(raised=str(e), wall_s=time.monotonic() - t0,
                                            kernel_launches=aggregate.LAUNCHES)
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    res = GoalOptimizer(goal_names=DEFAULT_HARD_GOALS).optimizations(
        cs, cp, cm, model_generation=lm.model_generation)
    sync(device)
    out["propose_hard_goals"] = solve_summary(aggregate, res, time.monotonic() - t0, hard)
    check(len(res.proposals) > 0, "monitor: no proposals")

    # The resident path: full freeze, an unchanged request, a dead broker.
    trc = tracer()
    trc.configure(enabled=True, ring_size=32)
    trc.rollup(reset=True)
    svc = ResidentModelService(device=device)
    t0 = time.monotonic()
    builder, fresh = lm.resident_model_builder()
    first = svc.snapshot(builder, pad, pin=True)
    svc.release()
    full_snapshot_s = time.monotonic() - t0
    rollup = trc.rollup()
    before = svc.stats()
    builder2, fresh2 = lm.resident_model_builder()
    again = svc.snapshot(builder2, pad, pin=True)
    svc.release()
    after = svc.stats()
    check(fresh and not fresh2 and builder2 is builder and again[0] is first[0]
          and after["fullFreezes"] == before["fullFreezes"]
          and after["deltaApplies"] == before["deltaApplies"],
          "monitor: an unchanged request did not return the resident tensors")
    dead = cm.broker_ids[0]
    backend.kill_broker(dead)
    builder3, fresh3 = lm.resident_model_builder()
    s3, p3, m3 = svc.snapshot(builder3, pad, pin=True)
    killed = svc.stats()
    rollup = trc.rollup()
    try:
        applies = killed["deltaApplies"] - after["deltaApplies"]
        freezes = killed["fullFreezes"] - after["fullFreezes"]
        check(not fresh3 and applies == 1 and freezes == 0,
              f"monitor: the dead broker took {applies} applies, {freezes} full freezes")
        fresh_arrays = state_to_numpy(*lm.cluster_model(pad_fn=pad, device="cpu")[:2])
        equal = packed_equal(state_to_numpy(s3, p3), fresh_arrays)
        check(equal, "monitor: the delta-applied tensors differ from a fresh freeze")
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        res2 = GoalOptimizer().optimizations(s3, p3, m3, model_generation=lm.model_generation)
        sync(device)
        summary = solve_summary(aggregate, res2, time.monotonic() - t0, hard)
    finally:
        svc.release()
    valid = s3.valid.cpu().numpy()
    left = int((res2.final_placement.broker.cpu().numpy()[valid] == m3.broker_index[dead]).sum())
    on_dead = int((p3.broker.cpu().numpy()[valid] == m3.broker_index[dead]).sum())
    check(on_dead > 0 and left == 0, f"monitor: {left} of {on_dead} replicas left on the "
          f"dead broker {dead}")
    freeze_n, freeze_ms = span_ms(rollup, "model.freeze")
    transfer_n, transfer_ms = span_ms(rollup, "model.transfer")
    apply_n, apply_ms = span_ms(rollup, "model.delta_apply")
    out["resident"] = dict(
        full_snapshot_s=full_snapshot_s, freeze_ms=freeze_ms / max(freeze_n, 1),
        transfer_ms=transfer_ms / max(transfer_n, 1),
        freeze_transfer_ms=(freeze_ms + transfer_ms) / max(freeze_n, 1),
        delta_apply_ms=apply_ms / max(apply_n, 1),
        freeze_transfer_over_delta_apply=(freeze_ms + transfer_ms) / max(apply_ms, 1e-9),
        unchanged_request_same_tensors=True, dead_broker=dead,
        dead_broker_replicas=on_dead, delta_applies=applies, full_freezes_after_kill=freezes,
        equal_to_fresh_freeze=equal, stats=svc.stats(), repropose=summary,
        replicas_left_on_dead_broker=left)
    trc.configure(enabled=False, ring_size=32)
    return out, SimpleNamespace(lm=lm, backend=backend, dead=dead)


def revive_broker(backend, broker_id):
    """Bring a broker the monitor phase killed back to life in the fake
    metadata backend (a restart: it keeps its replicas)."""
    from cruise_control_tpu_torch.monitor.metadata import BrokerInfo
    backend.brokers = [BrokerInfo(b.broker_id, b.rack, b.host, alive=True)
                       if b.broker_id == broker_id else b for b in backend.brokers]


def partition_placement(state, placement, meta):
    """{(topic, partition): (sorted broker ids, leader id)} of a snapshot."""
    import numpy as np
    n = meta.num_replicas
    part = state.partition[:n].cpu().numpy().tolist()
    ids = np.asarray(meta.broker_ids)[placement.broker[:n].cpu().numpy()].tolist()
    lead = placement.is_leader[:n].cpu().numpy().tolist()
    out = {}
    for p, b, is_leader in zip(part, ids, lead):
        t, num = meta.partitions[p]
        reps, leader = out.get((meta.topics[t], num), ((), None))
        out[(meta.topics[t], num)] = (reps + (b,), b if is_leader else leader)
    return {k: (tuple(sorted(reps)), leader) for k, (reps, leader) in out.items()}


def metadata_placement(partitions):
    """The same view of a fake backend's (or the simulator's) partitions."""
    return {(p.topic, p.partition): (tuple(sorted(p.replicas)), p.leader)
            for p in partitions}


def task_counts(tracker):
    """Tasks by state, summed over the task types."""
    out = {}
    for by_state in tracker.summary().values():
        for state, n in by_state.items():
            out[state] = out.get(state, 0) + n
    return out


def run_execution(executor, proposals, what):
    """Execute in the executor's thread with a bounded join; (wall s, tasks
    by state).  Every task must complete."""
    t0 = time.monotonic()
    executor.execute_proposals(proposals, wait=False)
    executor._thread.join(timeout=EXECUTE_TIMEOUT_S)
    wall = time.monotonic() - t0
    check(not executor._thread.is_alive(), f"{what}: the execution did not end in "
          f"{EXECUTE_TIMEOUT_S} s")
    tasks = task_counts(executor.tracker)
    check(set(tasks) == {"completed"} and tasks["completed"] >= len(proposals),
          f"{what}: tasks {tasks} for {len(proposals)} proposals")
    return wall, tasks


def goal_violations(aggregate, detector, device="cuda"):
    """One GoalViolationDetector run (a solve per anomaly-detection goal on
    a fresh model on the card): its goals, score and kernel launches."""
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    found = detector.detect()
    sync(device)
    wall = time.monotonic() - t0
    check(aggregate.LAUNCHES > 0, "detect: the goal-violation solves launched 0 times")
    gv = found[0] if found else None
    return dict(wall_s=wall, solves=len(detector.goal_names),
                fixable=gv.fixable_violated_goals if gv else [],
                unfixable=gv.unfixable_violated_goals if gv else [],
                balancedness=detector.last_balancedness_score,
                kernel_launches=aggregate.LAUNCHES)


def judge(aggregate, what, state, placement, meta, final, device="cuda", **kw):
    """``verify_placement`` of ``final`` on the tensors' device: no failure,
    and the aggregate kernel launched."""
    from cruise_control_tpu_torch.testing.verifier import verify_placement
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    failures = verify_placement(state, placement, meta, final, **kw)
    sync(device)
    ms = (time.monotonic() - t0) * 1e3
    check(not failures, f"{what}: the verifier failed: {[str(f) for f in failures]}")
    check(aggregate.LAUNCHES > 0, f"{what}: the verifier launched the kernel 0 times")
    return dict(ms=ms, kernel_launches=aggregate.LAUNCHES, failures=[])


def execute_phase(aggregate, mon, device="cuda"):
    """The hard goals solved on the card from the monitor's model, judged by
    the verifier on the card, every proposal executed through the executor
    over ``FakeClusterBackend`` with a journal, then the monitor refreshed and
    the model frozen again: each partition on the solve's replicas and
    leader, and the verifier finds nothing.  Returns the numbers and the
    solve (with the topology before it) for the phases that follow."""
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_HARD_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
    from cruise_control_tpu_torch.executor.backend import FakeClusterBackend
    from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
    from cruise_control_tpu_torch.executor.journal import ExecutionJournal
    from cruise_control_tpu_torch.obsvc.execution import execution
    pad = ShapeBucketPolicy().pad_targets
    lm, backend = mon.lm, mon.backend
    t0 = time.monotonic()
    cs, cp, cm = lm.cluster_model(pad_fn=pad, device=device)
    sync(device)
    out = dict(replicas=cm.num_replicas, brokers=cm.num_brokers,
               cluster_model_s=time.monotonic() - t0)
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    res = GoalOptimizer(goal_names=DEFAULT_HARD_GOALS).optimizations(cs, cp, cm)
    sync(device)
    out["solve"] = solve_summary(aggregate, res, time.monotonic() - t0, set(DEFAULT_HARD_GOALS))
    check(len(res.proposals) > 0, "execute: no proposals")
    judged = dict(before=judge(aggregate, "execute (the solve)", cs, cp, cm,
                               res.final_placement, device, goal_names=DEFAULT_HARD_GOALS,
                               goal_infos=res.goal_infos))
    before = backend.fetch().partitions
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "journal.jsonl")
        ex = Executor(FakeClusterBackend(backend, polls_to_finish=2), ExecutorConfig(
            progress_check_interval_s=EXECUTE_POLL_S,
            max_num_cluster_movements=len(res.proposals)))
        ex.set_journal(ExecutionJournal(path))
        wall, tasks = run_execution(ex, res.proposals, "execute")
        with open(path, encoding="utf-8") as f:
            journal = [json.loads(line) for line in f]
    batch = execution().state_summary()["lastBatch"] or {}
    check(journal[0]["event"] == "batch_start" and journal[-1]["event"] == "batch_end"
          and journal[-1]["outcome"] == {"completed": tasks["completed"], "dead": 0,
                                         "aborted": 0},
          f"execute: the journal does not close the batch: {journal[-1]}")
    out.update(proposals=len(res.proposals), tasks=dict(
        completed=tasks["completed"], dead=tasks.get("dead", 0),
        aborted=tasks.get("aborted", 0)), execution_wall_s=wall,
        recorder_duration_ms=batch.get("durationMs"),
        recorder_moves_per_second=batch.get("movesPerSecond"),
        journal_lines=len(journal), executor_state=ex.state_summary())
    t0 = time.monotonic()
    s2, p2, m2 = lm.cluster_model(pad_fn=pad, device=device)
    sync(device)
    out["refreeze_s"] = time.monotonic() - t0
    want = partition_placement(cs, res.final_placement, cm)
    got = partition_placement(s2, p2, m2)
    wrong = sorted(k for k in want if got.get(k) != want[k])
    check(not wrong and set(got) == set(want),
          f"execute: {len(wrong)} partitions differ from the solve, e.g. "
          f"{[(k, got.get(k), want[k]) for k in wrong[:3]]}")
    check(metadata_placement(backend.fetch().partitions) == want,
          "execute: the metadata differs from the solve")
    judged["after"] = judge(aggregate, "execute (the executed model)", s2, p2, m2, p2, device,
                            goal_names=DEFAULT_HARD_GOALS)
    out.update(partitions_equal_to_solve=len(want), verifier=judged,
               kernel_launches=out["solve"]["kernel_launches"]
               + judged["before"]["kernel_launches"] + judged["after"]["kernel_launches"])
    return out, SimpleNamespace(res=res, before=before, state=cs, placement=cp, meta=cm)


def execute_subprocess_phase(aggregate, done, limit, device="cuda"):
    """The first ``limit`` proposals of the execute phase's solve, executed
    through ``SubprocessClusterBackend`` against the port's broker simulator
    in a separate process (bootstrapped with the topology before the solve),
    with replication throttles: every task completes, the throttles are set
    and then cleared, and the child ends where those proposals put it; the
    placement they give is judged by the verifier on the card."""
    import torch
    from cruise_control_tpu_torch.executor.broker_simulator import (
        FOLLOWER_THROTTLED_RATE, FOLLOWER_THROTTLED_REPLICAS, LEADER_THROTTLED_RATE,
        LEADER_THROTTLED_REPLICAS)
    from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
    from cruise_control_tpu_torch.executor.subprocess_backend import SubprocessClusterBackend
    from cruise_control_tpu_torch.model.state import Placement
    proposals = done.res.proposals[:limit]
    parts = [{"topic": p.topic, "partition": p.partition, "replicas": list(p.replicas),
              "leader": p.leader} for p in done.before]
    # The child runs ``python -m cruise_control_tpu_torch.executor.broker_simulator``.
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x])
    t0 = time.monotonic()
    backend = SubprocessClusterBackend.spawn(parts, polls_to_finish=2)
    out = dict(proposals=len(proposals), partitions=len(parts),
               spawn_and_bootstrap_s=time.monotonic() - t0)
    requests = [0]
    real = backend.request

    def counted(op, **kw):
        requests[0] += 1
        return real(op, **kw)
    backend.request = counted
    try:
        ex = Executor(backend, ExecutorConfig(
            progress_check_interval_s=EXECUTE_POLL_S, max_num_cluster_movements=len(proposals),
            replication_throttle_bytes_per_s=SUBPROCESS_THROTTLE_BYTES_PER_S))
        wall, tasks = run_execution(ex, proposals, "execute_subprocess")
        exec_requests = requests[0]
        stats = backend.stats()
        set_ops = [e for e in stats["config_log"] if e.get("op", "set") != "delete"]
        deletes = [e for e in stats["config_log"] if e.get("op") == "delete"]
        brokers = sorted({r.broker_id for p in proposals
                          for r in p.old_replicas + p.new_replicas})
        topics = sorted({p.topic_partition.topic for p in proposals})
        left = [("broker", b) for b in brokers if {LEADER_THROTTLED_RATE, FOLLOWER_THROTTLED_RATE}
                & set(backend.request("describe_configs", entity_type="broker",
                                      entity=b)["configs"])]
        left += [("topic", t) for t in topics if {LEADER_THROTTLED_REPLICAS,
                                                  FOLLOWER_THROTTLED_REPLICAS}
                 & set(backend.request("describe_configs", entity_type="topic",
                                       entity=t)["configs"])]
        check(set_ops and deletes and not left, f"execute_subprocess: throttles set "
              f"{len(set_ops)}, deleted {len(deletes)}, left on {left[:5]}")
        final = {(d["topic"], d["partition"]): (tuple(sorted(d["replicas"])), d["leader"])
                 for d in backend.describe_topics()}
    finally:
        backend.close()
    check(backend.proc.poll() is not None, "execute_subprocess: the simulator did not exit")
    # The placement the first ``limit`` proposals give: their partitions
    # at the solve's final placement, every other one as before.
    st, pl, mt, fin = done.state, done.placement, done.meta, done.res.final_placement
    index = {(mt.topics[t], num): pid for pid, (t, num) in enumerate(mt.partitions)}
    pids = torch.tensor([index[(p.topic_partition.topic, p.topic_partition.partition)]
                         for p in proposals])
    moved = torch.isin(st.partition.cpu(), pids).to(st.partition.device) & st.valid
    partial = Placement(broker=torch.where(moved, fin.broker, pl.broker),
                        disk=torch.where(moved, fin.disk, pl.disk),
                        is_leader=torch.where(moved, fin.is_leader, pl.is_leader))
    want = partition_placement(st, partial, mt)
    check(set(final) == set(want) and all(final[k][0] == want[k][0] for k in want),
          "execute_subprocess: the simulator's replicas differ from the proposals'")
    # Leadership moves with a reassignment only where the old leader leaves
    # (the simulator keeps a current leader, as Kafka does); leadership-only
    # proposals elect the proposal's leader.
    by_tp = {(p.topic_partition.topic, p.topic_partition.partition): p for p in proposals}
    kept = [k for k, p in by_tp.items() if final[k][1] != want[k][1]]
    check(all(by_tp[k].has_replica_action and by_tp[k].old_leader.broker_id in
              {r.broker_id for r in by_tp[k].new_replicas}
              and final[k][1] == by_tp[k].old_leader.broker_id for k in kept)
          and all(final[k][1] == want[k][1] for k in want if k not in by_tp),
          "execute_subprocess: a leader differs from the proposals'")
    judged = judge(aggregate, "execute_subprocess", st, pl, mt, partial, device,
                   verifications=())
    out.update(tasks=tasks, execution_wall_s=wall, requests=exec_requests,
               requests_per_s=exec_requests / wall, throttle_configs_set=len(set_ops),
               throttle_configs_deleted=len(deletes), throttles_left=len(left),
               max_inflight=stats["max_inflight"], leaders_kept_by_reassignment=len(kept),
               verify_ms=judged["ms"], kernel_launches=judged["kernel_launches"])
    return out


def detect_phase(aggregate, mon, detector, violations_before, device="cuda"):
    """The detectors on the monitor's cluster after ``execute``: the goal-
    violation solves again (no hard goal fixable now), one broker killed and
    reported by ``BrokerFailureDetector``, then one ``AnomalyDetectorManager``
    round on a second thread with self-healing on, zero thresholds and an
    injected clock.  Its fixer is the facade's ``_fix_anomaly``: a
    ``remove_brokers`` of the dead broker on the six hard goals, frozen and
    solved on the card and executed over ``FakeClusterBackend``.  The broker
    must end empty and the audit log must hold the FIX, its FIX_STARTED
    outcome and the execution's outcome."""
    import threading
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_HARD_GOALS
    from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType
    from cruise_control_tpu_torch.detector.detectors import BrokerFailureDetector
    from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager
    from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
    from cruise_control_tpu_torch.executor.backend import FakeClusterBackend
    from cruise_control_tpu_torch.executor.executor import Executor, ExecutorConfig
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.obsvc.audit import audit_log
    pad = ShapeBucketPolicy().pad_targets
    lm, backend = mon.lm, mon.backend
    after = goal_violations(aggregate, detector, device)
    fixable_hard = set(after["fixable"]) & set(DEFAULT_HARD_GOALS)
    check(not fixable_hard, f"detect: hard goals still fixable after execute: {fixable_hard}")
    out = dict(goal_violations_before_execute=violations_before,
               goal_violations_after_execute=after)

    victim = next(b.broker_id for b in backend.brokers if b.alive)
    on_victim = sum(victim in p.replicas for p in backend.partitions)
    check(on_victim > 0, f"detect: broker {victim} holds no replica")
    backend.kill_broker(victim)
    clock = {"ms": 1e9}
    failure_detector = BrokerFailureDetector(lm.metadata_client, clock=lambda: clock["ms"])
    found = failure_detector.detect()
    check(len(found) == 1 and set(found[0].failed_brokers) == {victim},
          f"detect: BrokerFailureDetector reported {[a.describe() for a in found]}")

    executor = Executor(FakeClusterBackend(backend, polls_to_finish=2), ExecutorConfig(
        progress_check_interval_s=EXECUTE_POLL_S, max_num_cluster_movements=EXECUTE_MAX_MOVES))
    facade = CruiseControl(lm, executor, default_goals=DEFAULT_HARD_GOALS, device=device)
    notifier = SelfHealingNotifier(self_healing_enabled=True, clock=lambda: clock["ms"],
                                   broker_failure_alert_threshold_ms=0,
                                   broker_failure_self_healing_threshold_ms=0)
    manager = AnomalyDetectorManager({AnomalyType.BROKER_FAILURE: failure_detector},
                                     notifier=notifier, fixer=facade._fix_anomaly)
    audit_log().clear()
    aggregate.LAUNCHES = 0
    t_detect = time.monotonic()
    worker = threading.Thread(target=manager.run_detection_once, name="anomaly-round")
    worker.start()
    worker.join(timeout=EXECUTE_TIMEOUT_S)
    check(not worker.is_alive(), "detect: the manager round did not end")
    fix_round_s = time.monotonic() - t_detect
    fix_launches = aggregate.LAUNCHES
    check(fix_launches > 0, "detect: the facade's fix launched the kernel 0 times")
    check(executor._thread is not None, "detect: the facade's fix started no execution")
    t_exec = time.monotonic()
    executor._thread.join(timeout=EXECUTE_TIMEOUT_S)
    check(not executor._thread.is_alive(), "detect: the fix's execution did not end")
    tasks = task_counts(executor.tracker)
    execute_s = time.monotonic() - t_exec
    check(set(tasks) == {"completed"}, f"detect: the fix's tasks {tasks}")
    t0 = time.monotonic()
    st, pl, mt = lm.cluster_model(pad_fn=pad, device=device)
    sync(device)
    refreeze_s = time.monotonic() - t0
    detected_to_empty = time.monotonic() - t_detect
    dead = mt.broker_index[victim]
    left_model = int((pl.broker[st.valid] == dead).sum())
    left_metadata = sum(victim in p.replicas for p in backend.partitions)
    check(left_model == 0 and left_metadata == 0, f"detect: broker {victim} still holds "
          f"{left_metadata} replicas in the metadata, {left_model} in the model")
    entries = [e for e in audit_log().entries() if e["anomalyType"] == "BROKER_FAILURE"]
    check(entries and entries[-1]["decision"] == "FIX" and entries[-1]["action"] == "remove_broker"
          and entries[-1]["outcome"] == "FIX_STARTED"
          and (entries[-1]["executionOutcome"] or {}).get("completed") == tasks["completed"],
          f"detect: the audit log holds {entries}")
    summary = manager.state_summary()
    out.update(killed_broker=victim, replicas_on_killed_broker=on_victim,
               broker_failure_reported=sorted(found[0].failed_brokers),
               fix=dict(fixer="CruiseControl._fix_anomaly", tasks=tasks,
                        fix_round_s=fix_round_s, kernel_launches=fix_launches,
                        execute_s=execute_s, refreeze_s=refreeze_s,
                        resident=facade.resident.stats()),
               detection_to_broker_empty_s=detected_to_empty,
               audit=dict(decision=entries[-1]["decision"], action=entries[-1]["action"],
                          outcome=entries[-1]["outcome"],
                          execution_outcome=entries[-1]["executionOutcome"]),
               manager_metrics=summary["metrics"],
               kernel_launches=after["kernel_launches"] + fix_launches)
    audit_log().clear()
    return out


class HotPartitionSampler:
    """A sampler whose ``hot`` partitions carry ``factor`` times the inner
    sampler's load: a monitor window in which a few partitions' traffic
    grows."""

    def __init__(self, inner, hot, factor):
        self.inner, self.hot, self.factor = inner, set(hot), factor

    def get_samples(self, metadata, start_ms, end_ms):
        result = self.inner.get_samples(metadata, start_ms, end_ms)
        for ps in result.partition_samples:
            if (ps.topic, ps.partition) in self.hot:
                ps.metrics *= self.factor
        return result


def wait_until(cond, what, timeout=FACADE_WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"facade: {what} within {timeout} s")
        time.sleep(0.01)


def facade_phase(aggregate, props, device="cuda"):
    """``CruiseControl`` built from ``CruiseControlConfig`` on a fresh
    monitored cluster (``FakeClusterBackend``, the resident service, the
    precompute daemon), started with ``start_up()``:

    (a) the daemon warms the proposal cache, then ``proposals()`` is a hit
        with 0 launches;
    (b) a monitor window is ingested; the daemon's refresh takes one delta
        apply and no full freeze, and ``proposals()`` is a hit again;
    (c) ``rebalance`` of the hard goals executes: every task completes and the
        verifier finds nothing on the re-frozen model;
    (d) ``remove_brokers([b])``: b ends empty in the metadata and the model;
    (e) ``demote_brokers([b2])``: b2 leads nothing;
    (f) a killed broker is found by the detector ``start_up()`` started and
        fixed by the facade: the audit holds FIX / FIX_STARTED and the
        execution's outcome;
    (g) ``shutdown()`` while a solve with a deadline is in flight drains
        within ``solver.shutdown.grace.ms``.

    Each operation's kernel launches are counted over its synchronous call
    (freeze and solve; the execution it starts runs on)."""
    import threading
    from cruise_control_tpu_torch import obsvc
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS
    from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType
    from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
    from cruise_control_tpu_torch.executor.backend import FakeClusterBackend
    from cruise_control_tpu_torch.executor.executor import Executor
    from cruise_control_tpu_torch.facade import CruiseControl
    from cruise_control_tpu_torch.model.resident import ResidentModelService
    from cruise_control_tpu_torch.obsvc.audit import audit_log
    from cruise_control_tpu_torch.obsvc.tracer import tracer
    cfg = CruiseControlConfig(FACADE_CONFIG)
    obsvc.configure(cfg)
    pad = ShapeBucketPolicy().pad_targets
    cluster = monitored_cluster(props)
    lm, backend = cluster.lm, cluster.backend
    hard = cfg.goal_names("hard.goals")
    notifier = SelfHealingNotifier(
        self_healing_enabled=cfg["self.healing.enabled"],
        broker_failure_alert_threshold_ms=cfg["broker.failure.alert.threshold.ms"],
        broker_failure_self_healing_threshold_ms=cfg["broker.failure.self.healing.threshold.ms"])
    notifier.set_self_healing_for(AnomalyType.BROKER_FAILURE, True)
    executor = Executor(FakeClusterBackend(backend, polls_to_finish=2), cfg.executor_config())
    resident = ResidentModelService(enabled=cfg["model.resident.enabled"],
                                    max_delta_slots=cfg["model.resident.max.delta.slots"],
                                    max_delta_chain=cfg["model.resident.max.delta.chain"],
                                    device=device)
    cc = CruiseControl(
        lm, executor, constraint=cfg.balancing_constraint(), default_goals=cfg.goal_names(),
        notifier=notifier, self_healing_goals=cfg.goal_names("anomaly.detection.goals"),
        anomaly_detection_interval_s=cfg["anomaly.detection.interval.ms"] / 1000.0,
        proposal_precompute_interval_s=cfg["proposal.expiration.ms"] / 1000.0,
        resident_service=resident, default_deadline_ms=cfg["solver.default.deadline.ms"],
        shutdown_grace_ms=float(cfg["solver.shutdown.grace.ms"]), device=device)
    out = dict(replicas=cluster.meta.num_replicas, brokers=cluster.meta.num_brokers,
               bootstrap_s=cluster.bootstrap_s, default_goals=cc.default_goals)
    trc = tracer()
    trc.configure(enabled=True, ring_size=32)
    trc.rollup(reset=True)
    threads_before = set(threading.enumerate())
    audit_log().clear()

    tasks_before = {}

    def settled():
        return cc._precomputed_generation == lm.model_generation

    def execute_and_wait(r, what, before):
        """Wait for the execution an operation started; its tasks by state
        (the tracker keeps every batch's, so ``before`` is subtracted)."""
        check(r.executed, f"facade: {what} executed nothing")
        cc.executor._thread.join(timeout=EXECUTE_TIMEOUT_S)
        check(not cc.executor.has_ongoing_execution, f"facade: {what}: execution did not end")
        after = task_counts(cc.executor.tracker)
        tasks = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        check(set(tasks) == {"completed"} and tasks["completed"] == len(
            r.optimizer_result.proposals), f"facade: {what}: tasks {tasks}")
        return tasks

    def settle(timeout=30.0):
        """Wait for the precompute daemon to catch up with the monitor, so
        an operation's launch count is its own; False if it did not."""
        deadline = time.monotonic() + timeout
        while not settled() and time.monotonic() < deadline:
            time.sleep(0.01)
        return settled()

    def operation(what, call):
        nonlocal tasks_before
        quiet = settle()
        tasks_before = task_counts(cc.executor.tracker)
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        r = call()
        sync(device)
        return r, dict(wall_s=time.monotonic() - t0, kernel_launches=aggregate.LAUNCHES,
                       daemon_quiet=quiet, proposals=len(r.optimizer_result.proposals),
                       violated_goals_after=r.optimizer_result.violated_goals_after)

    # The resident sensors are process-wide: count from here.
    stats_start = resident.stats()
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    cc.start_up()
    try:
        # (a) the daemon warms the cache; proposals() is a hit.
        wait_until(settled, "the first precompute")
        warm = dict(start_to_warm_s=time.monotonic() - t0, kernel_launches=aggregate.LAUNCHES,
                    full_freezes=resident.stats()["fullFreezes"] - stats_start["fullFreezes"])
        check(warm["kernel_launches"] > 0 and warm["full_freezes"] == 1,
              f"facade (a): the precompute took {warm}")
        cached = next(iter(cc.optimizer._cached.values()))
        r, hit = operation("proposals", cc.proposals)
        check(r.optimizer_result is cached and hit["kernel_launches"] == 0,
              f"facade (a): proposals() was not a cache hit: {hit}")
        warm.update(precompute_solve_s=cached.elapsed_s, proposals_hit=hit)
        out["a_precompute"] = warm

        # (b) a monitor window in which a few partitions' traffic grows; the
        # daemon's refresh is one delta apply.
        stats0 = resident.stats()
        generation0 = lm.model_generation
        end_ms = MONITOR_BOOTSTRAP_WINDOWS * MONITOR_WINDOW_MS
        hot = [(p.topic, p.partition) for p in backend.partitions[:FACADE_HOT_PARTITIONS]]
        runner, synthetic = cluster.runner, cluster.runner.sampler
        runner.sampler = HotPartitionSampler(synthetic, hot, FACADE_HOT_FACTOR)
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        # Two windows: the first completes (an average's input), the second
        # is the active one.
        runner.bootstrap(end_ms, end_ms + 2 * MONITOR_WINDOW_MS)
        tick_s = time.monotonic() - t0
        runner.sampler = synthetic
        check(lm.model_generation != generation0, "facade (b): the window moved no generation")
        wait_until(settled, "the precompute refresh after the window")
        refresh_s = time.monotonic() - t0
        refresh_launches = aggregate.LAUNCHES
        stats1 = resident.stats()
        applies = stats1["deltaApplies"] - stats0["deltaApplies"]
        freezes = stats1["fullFreezes"] - stats0["fullFreezes"]
        check(applies == 1 and freezes == 0,
              f"facade (b): the refresh took {applies} delta applies, {freezes} full freezes")
        cached = next(iter(cc.optimizer._cached.values()))
        r, hit = operation("proposals", cc.proposals)
        check(r.optimizer_result is cached and hit["kernel_launches"] == 0,
              f"facade (b): proposals() was not a cache hit: {hit}")
        apply_n, apply_ms = span_ms(trc.rollup(), "model.delta_apply")
        out["b_monitor_tick"] = dict(
            hot_partitions=len(hot), ingest_s=tick_s, tick_to_refreshed_s=refresh_s,
            refresh_kernel_launches=refresh_launches,
            refresh_solve_s=cached.elapsed_s, delta_applies=applies, full_freezes=freezes,
            delta_apply_ms=apply_ms / max(apply_n, 1), proposals_hit=hit)

        # (c) rebalance on the hard goals, executed; the verifier on the re-freeze.
        r, op = operation("rebalance", lambda: cc.rebalance(hard, dryrun=False))
        t0 = time.monotonic()
        op["tasks"] = execute_and_wait(r, "rebalance", tasks_before)
        op["execution_s"] = time.monotonic() - t0
        s2, p2, m2 = lm.cluster_model(pad_fn=pad, device=device)
        op["verifier"] = judge(aggregate, "facade (c) the re-frozen model", s2, p2, m2, p2,
                               device, goal_names=hard)
        out["c_rebalance"] = op

        # (d) remove a broker.
        b = next(x.broker_id for x in backend.brokers
                 if x.alive and any(x.broker_id in p.replicas for p in backend.partitions))
        r, op = operation("remove_brokers", lambda: cc.remove_brokers([b], dryrun=False))
        t0 = time.monotonic()
        op["tasks"] = execute_and_wait(r, "remove_brokers", tasks_before)
        op["execution_s"] = time.monotonic() - t0
        s3, p3, m3 = lm.cluster_model(pad_fn=pad, device=device)
        left_model = int((p3.broker[s3.valid] == m3.broker_index[b]).sum())
        left_metadata = sum(b in p.replicas for p in backend.partitions)
        check(left_model == 0 and left_metadata == 0, f"facade (d): broker {b} holds "
              f"{left_metadata} replicas in the metadata, {left_model} in the model")
        op.update(broker=b, replicas_left=0)
        out["d_remove_brokers"] = op

        # (e) demote a broker that leads.
        b2 = next(x.broker_id for x in backend.brokers
                  if x.broker_id != b and any(p.leader == x.broker_id for p in backend.partitions))
        led = sum(p.leader == b2 for p in backend.partitions)
        r, op = operation("demote_brokers", lambda: cc.demote_brokers([b2], dryrun=False))
        t0 = time.monotonic()
        op["tasks"] = execute_and_wait(r, "demote_brokers", tasks_before)
        op["execution_s"] = time.monotonic() - t0
        still = sum(p.leader == b2 for p in backend.partitions)
        check(still == 0, f"facade (e): broker {b2} still leads {still} of {led} partitions")
        op.update(broker=b2, partitions_led_before=led)
        out["e_demote_brokers"] = op

        # (f) a broker dies; the detector start_up() started finds it, and
        # the facade's fix empties it.  The launches counted here are every
        # thread's: the detection round, the fix and the daemon's refreshes.
        settle()
        victim = next(x.broker_id for x in backend.brokers if x.alive and x.broker_id not in
                      (b, b2) and any(x.broker_id in p.replicas for p in backend.partitions))
        on_victim = sum(victim in p.replicas for p in backend.partitions)
        aggregate.LAUNCHES = 0
        t_kill = time.time()
        backend.kill_broker(victim)

        def fixed():
            return [e for e in audit_log().entries()
                    if e["anomalyType"] == "BROKER_FAILURE" and e["outcome"] == "FIX_STARTED"]
        wait_until(fixed, "the broker failure's fix", timeout=3 * FACADE_WAIT_S)
        wait_until(lambda: not any(victim in p.replicas for p in backend.partitions),
                   "the dead broker emptied", timeout=EXECUTE_TIMEOUT_S)
        t_empty = time.time()
        fix_launches = aggregate.LAUNCHES
        cc.executor._thread.join(timeout=EXECUTE_TIMEOUT_S)
        entry = fixed()[-1]
        wait_until(lambda: fixed()[-1]["executionOutcome"] is not None,
                   "the fix's execution outcome in the audit")
        entry = fixed()[-1]
        outcome = entry["executionOutcome"]
        check(entry["decision"] == "FIX" and entry["action"] == "remove_broker"
              and outcome["completed"] >= on_victim and outcome["dead"] == 0
              and outcome["aborted"] == 0, f"facade (f): audit {entry}")
        s4, p4, m4 = lm.cluster_model(pad_fn=pad, device=device)
        left_model = int((p4.broker[s4.valid] == m4.broker_index[victim]).sum())
        check(left_model == 0, f"facade (f): {left_model} replicas on {victim} in the model")
        out["f_self_healing"] = dict(
            broker=victim, replicas=on_victim, kill_to_empty_s=t_empty - t_kill,
            detection_to_empty_s=t_empty - entry["timestampMs"] / 1000.0,
            kernel_launches_all_threads=fix_launches,
            audit=dict(decision=entry["decision"], action=entry["action"],
                       outcome=entry["outcome"], execution_outcome=outcome))

        # (g) shutdown() with a deadline-carrying solve in flight.
        settle()
        result = {}

        def solve():
            try:
                result["r"] = cc.rebalance(DEFAULT_GOALS, dryrun=True, deadline_ms=60_000.0)
            except Exception as e:  # noqa: BLE001 — checked below
                result["error"] = e
            result["returned"] = time.monotonic()
        aggregate.LAUNCHES = 0
        solver = threading.Thread(target=solve, name="deadline-solve")
        solver.start()
        wait_until(lambda: cc.active_solves() == 1 or not solver.is_alive(),
                   "the deadline solve registered")
    finally:
        t0 = time.monotonic()
        cc.shutdown()
        shutdown_s = time.monotonic() - t0
        trc.configure(enabled=False, ring_size=32)
    solver.join(timeout=EXECUTE_TIMEOUT_S)
    check("error" not in result and not solver.is_alive(),
          f"facade (g): the in-flight solve ended with {result.get('error')}")
    partial = result["r"].optimizer_result
    drain_s = result["returned"] - t0
    check(partial.partial and partial.preempt_reason == "shutdown" and cc.active_solves() == 0
          and drain_s * 1000.0 < cc.shutdown_grace_ms,
          f"facade (g): drained in {drain_s} s, partial {partial.partial}, "
          f"reason {partial.preempt_reason}")
    leaked = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    check(not leaked, f"facade: threads left after shutdown: {leaked}")
    out["g_shutdown"] = dict(drain_s=drain_s, shutdown_s=shutdown_s,
                             grace_ms=cc.shutdown_grace_ms,
                             partial=partial.partial, preempt_reason=partial.preempt_reason,
                             goals_preempted=sum(i.preempted for i in partial.goal_infos),
                             kernel_launches=aggregate.LAUNCHES)
    end = resident.stats()
    out["resident"] = dict(end, fullFreezes=end["fullFreezes"] - stats_start["fullFreezes"],
                           deltaApplies=end["deltaApplies"] - stats_start["deltaApplies"])
    out["state_keys"] = {k: sorted(v) for k, v in cc.state().items()}
    out["health"] = cc.health()["status"]
    audit_log().clear()
    return out


def http_call(aggregate, responder, spec, params, device):
    """One request through the port's CLI client (202 polling included):
    (body, wall s, the kernel's launches during it)."""
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    body = responder.request(spec, params)
    sync(device)
    return body, time.monotonic() - t0, aggregate.LAUNCHES


def cli_call(base, argv, user=None):
    """``cccli.main`` as a user runs it: (exit code, the JSON it printed)."""
    from cruise_control_tpu_torch.client import cccli
    login = ["--username", user[0], "--password", user[1]] if user else []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cccli.main(["-a", base, *login, *argv])
    return rc, json.loads(buf.getvalue())


def servlet_phase(aggregate, props, device="cuda"):
    """The service that ``main.build_app`` wires from SERVLET_CONFIG with
    basic security, on a fresh monitored cluster, driven over HTTP by the
    port's CLI client (``cccli.main`` where the JAX package's client has the
    endpoint and its parameters, its ``Responder`` otherwise):

    - reads: state, load, kafka_cluster_state, proposals, user_tasks,
      health, metrics?json=true;
    - ``rebalance?dryrun=true&explain=true`` on the hard goals, then the
      default goals with ``deadline_ms``, then ``remove_broker?dryrun=true``;
    - ``rebalance?dryrun=false``, ``execution_progress`` while it runs, and
      ``stop_proposal_execution``;
    - ``POST/GET profile`` over a window holding one dry-run rebalance.

    Every body validates against the port's schemas, no hard goal is left
    violated, every explained proposal names a requested goal and a known
    path, the kernel launches inside every solving request, and a request
    without credentials gets 401.  The precompute daemon is off, so each
    request's launch count is its own."""
    import threading
    from cruise_control_tpu_torch.client import cccli
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.main import build_app
    from cruise_control_tpu_torch.obsvc import profiler
    from cruise_control_tpu_torch.obsvc.execution import PATHS
    from cruise_control_tpu_torch.servlet.schemas import (ENDPOINT_SCHEMAS,
                                                          PROFILE_STATUS_SCHEMA, validate)

    tmp = tempfile.mkdtemp(prefix="servlet-phase-")
    creds = os.path.join(tmp, "realm.properties")
    with open(creds, "w") as f:
        f.write(f"{SERVLET_USER[0]}: {SERVLET_USER[1]},ADMIN\n")
    cfg = CruiseControlConfig(dict(SERVLET_CONFIG, **{
        "trace.profile.dir": tmp, "webserver.security.enable": "true",
        "webserver.security.provider": "basic", "webserver.auth.credentials.file": creds}))
    cluster = monitored_cluster(props)
    backend = cluster.backend
    hard = cfg.goal_names("hard.goals")
    default = cfg.goal_names()
    threads_before = set(threading.enumerate())
    app = build_app(cfg, port=0, device=device, metadata_backend=backend,
                    monitor=(cluster.lm, cluster.runner))
    cc = app.cc
    app.start()
    base = f"http://127.0.0.1:{app.port}"
    auth = "Basic " + base64.b64encode(":".join(SERVLET_USER).encode()).decode()
    responder = cccli.Responder(base, poll_interval_s=0.05, auth_header=auth)
    out = dict(replicas=cluster.meta.num_replicas, brokers=cluster.meta.num_brokers,
               bootstrap_s=cluster.bootstrap_s, default_goals=default)
    requests = {}

    def request(name, endpoint, method, params=None, schema=None):
        spec = cccli.ENDPOINTS.get(endpoint) or cccli.EndpointSpec(endpoint, method)
        check(spec.method == method, f"servlet: {endpoint} is a {spec.method}")
        body, wall, launches = http_call(aggregate, responder, spec, params or {}, device)
        status = body.pop("httpStatus")
        check(status < 400, f"servlet: {name} answered {status}: {str(body)[:300]}")
        validate(body, schema or ENDPOINT_SCHEMAS[endpoint])
        requests[name] = dict(status=status, http_wall_s=wall, kernel_launches=launches)
        return body

    def solved(name, body, goals, explain=False):
        result = body["result"]
        check(not set(result["violatedGoalsAfter"]) & set(hard),
              f"servlet: {name} left hard goals violated: {result['violatedGoalsAfter']}")
        check(requests[name]["kernel_launches"] > 0,
              f"servlet: {name} launched the kernel 0 times")
        requests[name].update(replica_moves=result["numInterBrokerReplicaMovements"],
                              leader_moves=result["numLeaderMovements"],
                              partial=body.get("partial", False))
        if explain:
            paths = result["provenancePaths"]
            bad = [p["topicPartition"] for p in result["proposals"]
                   if (p.get("provenance") or {}).get("path") not in PATHS
                   or p["provenance"]["goal"] not in goals]
            check(not bad and "unknown" not in paths and result["proposals"],
                  f"servlet: {name}: {len(bad)} proposals without a known provenance; "
                  f"paths {paths}")
            requests[name].update(explained_proposals=len(result["proposals"]),
                                  provenance_paths=paths)

    try:
        # A request without credentials is refused.
        anon = cccli.Responder(base).request(cccli.ENDPOINTS["state"], {})
        check(anon["httpStatus"] == 401, f"servlet: anonymous state got {anon['httpStatus']}")
        # Reads, the CLI's own way first.
        rc, body = cli_call(base, ["state"], SERVLET_USER)
        check(rc == 0 and body["httpStatus"] == 200, f"servlet: cccli state exited {rc}")
        request("state", "state", "GET")
        request("load", "load", "GET")
        request("kafka_cluster_state", "kafka_cluster_state", "GET")
        body = request("proposals", "proposals", "GET")
        solved("proposals", body, default)
        request("user_tasks", "user_tasks", "GET")
        request("health", "health", "GET")
        request("metrics", "metrics", "GET", {"json": "true"})

        # The north star's request, explained, beside the facade's own call.
        params = {"dryrun": "true", "explain": "true", "goals": ",".join(hard)}
        body = request("rebalance_explain", "rebalance", "POST", params)
        solved("rebalance_explain", body, hard, explain=True)
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        r = cc.rebalance(hard, dryrun=True)
        sync(device)
        facade_s = time.monotonic() - t0
        t0 = time.perf_counter()
        rendered = json.dumps(r.to_dict(explain=True)).encode()
        render_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        plain = json.dumps(r.to_dict()).encode()
        plain_render_ms = (time.perf_counter() - t0) * 1e3
        requests["rebalance_explain"].update(
            facade_wall_s=facade_s, facade_kernel_launches=aggregate.LAUNCHES,
            explain_bytes=len(rendered), explain_render_ms=render_ms,
            plain_bytes=len(plain), plain_render_ms=plain_render_ms)

        params = {"dryrun": "true", "deadline_ms": str(SERVLET_DEADLINE_MS)}
        body = request("rebalance_deadline", "rebalance", "POST", params)
        solved("rebalance_deadline", body, default)
        check(not body.get("partial"), "servlet: the default goals' solve came back partial")
        victim = next(b.broker_id for b in backend.brokers
                      if any(b.broker_id in p.replicas for p in backend.partitions))
        body = request("remove_broker", "remove_broker", "POST",
                       {"dryrun": "true", "brokerid": str(victim)})
        solved("remove_broker", body, default)
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        cc.remove_brokers([victim], dryrun=True)
        sync(device)
        requests["remove_broker"].update(facade_wall_s=time.monotonic() - t0,
                                         facade_kernel_launches=aggregate.LAUNCHES)

        # An execution, watched and stopped over HTTP.
        body = request("rebalance_execute", "rebalance", "POST",
                       {"dryrun": "false", "goals": ",".join(hard)})
        solved("rebalance_execute", body, hard)
        check(body["executed"], "servlet: rebalance?dryrun=false executed nothing")
        progress = request("execution_progress", "execution_progress", "GET")
        request("stop_proposal_execution", "stop_proposal_execution", "POST")
        check("unknown" not in (progress.get("batch") or {}).get("pathHistogram", {}),
              f"servlet: execution_progress counts moves under unknown: {progress.get('batch')}")
        cc.executor._thread.join(timeout=EXECUTE_TIMEOUT_S)
        check(not cc.executor.has_ongoing_execution, "servlet: the execution did not stop")
        tasks = task_counts(cc.executor.tracker)
        requests["execution_progress"].update(
            active=progress.get("active"),
            path_histogram=(progress.get("batch") or {}).get("pathHistogram"),
            tasks_in_view=len(progress.get("tasks") or []),
            with_provenance=sum(1 for t in progress.get("tasks") or [] if t.get("provenance")))
        out["execution_tasks"] = tasks

        # A profile window holding one dry-run solve.  POST /profile answers
        # 202 at once and is not polled (a re-POST would answer 409).
        req = urllib.request.Request(
            f"{base}/kafkacruisecontrol/profile?duration_s={SERVLET_PROFILE_S}",
            method="POST", headers={"Authorization": auth})
        with urllib.request.urlopen(req) as resp:
            prof = json.load(resp)
            check(resp.status == 202, f"servlet: POST profile answered {resp.status}")
        validate(prof, ENDPOINT_SCHEMAS["profile"])
        body = request("rebalance_profiled", "rebalance", "POST",
                       {"dryrun": "true", "goals": ",".join(hard)})
        solved("rebalance_profiled", body, hard)
        deadline = time.monotonic() + SERVLET_PROFILE_S + 60
        while True:
            st = request("profile_status", "profile", "GET", schema=PROFILE_STATUS_SCHEMA)
            if not st["busy"] or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        check(st["done"] and not st.get("error"), f"servlet: the profile capture {st}")
        trace = os.path.join(st["trace_dir"], profiler.TRACE_FILE)
        out["profile"] = dict(window_s=SERVLET_PROFILE_S, trace_dir=prof["trace_dir"],
                              trace_bytes=os.path.getsize(trace))
    finally:
        app.stop()
        cc.shutdown()
    deadline = time.monotonic() + 10
    while True:
        leaked = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
        if not leaked or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    check(not leaked, f"servlet: threads left after shutdown: {leaked}")
    shutil.rmtree(tmp, ignore_errors=True)
    out["requests"] = requests
    return out


def main_phase(timeout_s=MAIN_TIMEOUT_S, device="cuda"):
    """``python -m cruise_control_tpu_torch.main --demo --port 0`` on the
    card: the time to its listening line, one ``cccli rebalance --dryrun
    true`` against it, then SIGTERM, which must end the process with exit
    code 0 within MAIN_EXIT_S (a thread left running would hold it).  Then
    twice more with the persistent kernel-build cache on under
    MAIN_CACHE_DIR (emptied first): the first of these starts builds the
    aggregate kernel into the cache's versioned directory, the second loads
    it from there (``GET /compile_cache`` shows the entry, warm, and the
    library is not rebuilt).  Then the same command with no visible card
    must exit non-zero without listening."""
    tmp = tempfile.mkdtemp(prefix="main-phase-")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "cruise_control_tpu_torch.main", "--demo", "--port", "0",
           "--config"]
    shutil.rmtree(MAIN_CACHE_DIR, ignore_errors=True)
    cached = dict(MAIN_PROPERTIES, **{"compile.persistent.cache.enabled": "true",
                                      "compile.persistent.cache.path": MAIN_CACHE_DIR})
    out = serve_once(cmd, env, write_properties(tmp, "demo", MAIN_PROPERTIES), device, tmp,
                     timeout_s)
    caches = {}
    for start in ("cache_build", "cache_load"):
        got = serve_once(cmd, env, write_properties(tmp, start, cached), device, tmp,
                         timeout_s, read_cache=True)
        cache = got.pop("persistent_cache")
        libs = [os.path.join(cache["active_dir"] or "", f)
                for f in os.listdir(cache["active_dir"] or tmp) if f.endswith(".so")]
        check(cache["enabled"] and (cache["active_dir"] or "").startswith(MAIN_CACHE_DIR)
              and cache["applies_to"] == "this process" and len(libs) == 1
              and cache["entries"] == 1,
              f"main: {start}: the persistent cache holds no library: {cache}")
        got.update(warm=cache["warm"], entries=cache["entries"], bytes=cache["bytes"],
                   library_mtime=os.stat(libs[0]).st_mtime,
                   versioned_dir=os.path.relpath(cache["active_dir"], MAIN_CACHE_DIR))
        caches[start] = got
    build, load = caches["cache_build"], caches["cache_load"]
    check(not build["warm"] and load["warm"], f"main: cache warm flags {build['warm']}, "
          f"{load['warm']} (cold build, then warm load expected)")
    check(load["library_mtime"] == build["library_mtime"],
          "main: the second start rebuilt the cached library")
    out.update(caches)
    no_card = subprocess.run(cmd + [write_properties(tmp, "demo", MAIN_PROPERTIES), "--device",
                                    "cuda"], cwd=REPO, env=dict(env, CUDA_VISIBLE_DEVICES=""),
                             capture_output=True, text=True, timeout=timeout_s)
    check(no_card.returncode != 0 and "listening" not in no_card.stdout,
          f"main: --device cuda without a card exited {no_card.returncode}")
    out["no_card"] = dict(exit_code=no_card.returncode, stderr=no_card.stderr.strip()[-200:])
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(MAIN_CACHE_DIR, ignore_errors=True)
    return out


def write_properties(tmp, name, props):
    path = os.path.join(tmp, f"{name}.properties")
    with open(path, "w") as f:
        f.write("".join(f"{k}={v}\n" for k, v in props.items()))
    return path


def serve_once(cmd, env, props, device, tmp, timeout_s, read_cache=False):
    """One start of the service: listening line, the first 200 of ``cccli
    rebalance --dryrun true`` (no hard goal violated), with ``read_cache``
    the ``persistent_cache`` block of ``GET /compile_cache``, then SIGTERM
    and exit code 0."""
    import queue
    import signal
    import threading
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_HARD_GOALS
    from cruise_control_tpu_torch.main import LISTENING
    out = {}
    with open(os.path.join(tmp, "stderr.log"), "w+") as err:
        t0 = time.monotonic()
        proc = subprocess.Popen(cmd + [props, "--device", device], cwd=REPO, env=env,
                                stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            lines = queue.Queue()
            threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                             daemon=True).start()
            try:
                line = lines.get(timeout=timeout_s)
            except queue.Empty:
                line = ""
            out["to_listening_s"] = time.monotonic() - t0
            url = re.search(r"https?://\S+", line)
            check(line.startswith(LISTENING) and url,
                  f"main: no listening line ({line!r})")
            base = url.group(0)
            # The demo windows fill in a few seconds; until then the
            # operation answers 500 (not enough valid windows).
            t0 = time.monotonic()
            while True:
                t1 = time.monotonic()
                rc, body = cli_call(base, ["rebalance", "--dryrun", "true"])
                if body["httpStatus"] == 200 or time.monotonic() - t0 > timeout_s:
                    break
                time.sleep(0.5)
            check(rc == 0 and body["httpStatus"] == 200,
                  f"main: cccli rebalance exited {rc}: {str(body)[:300]}")
            violated = set(body["result"]["violatedGoalsAfter"])
            check(not violated & set(DEFAULT_HARD_GOALS),
                  f"main: hard goals violated after the rebalance: {sorted(violated)}")
            out.update(first_200_after_s=time.monotonic() - t0, request_wall_s=time.monotonic() - t1,
                       goals=len(body["result"]["goals"]),
                       replica_moves=body["result"]["numInterBrokerReplicaMovements"])
            if read_cache:
                with urllib.request.urlopen(f"{base.rstrip('/')}/kafkacruisecontrol/"
                                            "compile_cache") as resp:
                    out["persistent_cache"] = json.load(resp)["persistent_cache"]
            t0 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=MAIN_EXIT_S)
            out["sigterm_to_exit_s"] = time.monotonic() - t0
            check(rc == 0, f"main: exit code {rc} after SIGTERM")
        except SmokeFailure as e:
            err.seek(0)
            raise SmokeFailure(f"{e}; the service's log ends: {err.read()[-2000:]}") from None
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        out["exit_code"] = proc.returncode
    return out


def free_port():
    """A port free now on the loopback (the bus listener's key must be
    non-zero: 0 turns it off)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def capacity_file(path, capacity):
    """A capacity file (``capacity.config.file``) giving every broker
    ``capacity``."""
    with open(path, "w") as f:
        json.dump({"brokerCapacities": [{"brokerId": -1, "capacity": {
            r.name: str(v) for r, v in capacity.items()}}]}, f)
    return path


def ingest_round(runner, collect_s, now_ms, stage_dir, child):
    """One reporting round at ``now_ms``: the in-process reporters report,
    the child publishes the first INGEST_TCP_SHARE of the brokers over TCP
    (their records staged in ``stage_dir``), then
    sampling ticks inside the window drain the bus.  Returns the round's
    numbers."""
    from cruise_control_tpu_torch.reporter import FileTransport, MetricsReporter
    reporters = [r for r in runner.reporters if isinstance(r, MetricsReporter)]
    tcp_brokers = max(1, int(len(reporters) * INGEST_TCP_SHARE))
    bus = runner.sampler.transport
    before = sum(os.path.getsize(os.path.join(bus._dir, n)) for n in os.listdir(bus._dir))
    out = dict(records=0, tcp_records=0)
    collect_s[0] = 0.0
    t0 = time.perf_counter()
    for rep in reporters[tcp_brokers:]:
        out["records"] += rep.report_once(time_ms=now_ms)
    out["in_process_s"] = time.perf_counter() - t0
    out["collect_s"] = collect_s[0]
    staged = FileTransport(stage_dir, bus.num_partitions)
    t0 = time.perf_counter()
    for rep in reporters[:tcp_brokers]:
        out["tcp_records"] += MetricsReporter(rep.broker_id, rep.source,
                                              staged).report_once(time_ms=now_ms)
    out["stage_s"] = time.perf_counter() - t0
    child.stdin.write(stage_dir + "\n")
    child.stdin.flush()
    done = json.loads(child.stdout.readline())
    check(done["records"] == out["tcp_records"],
          f"ingest: the child published {done['records']} of {out['tcp_records']} records")
    out["tcp_s"] = done["seconds"]
    after = sum(os.path.getsize(os.path.join(bus._dir, n)) for n in os.listdir(bus._dir))
    records = out["records"] + out["tcp_records"]
    out["bytes"] = after - before - 4 * records      # without the length prefixes
    ticks, samples = 0, 0
    t0 = time.perf_counter()
    while ticks < INGEST_MAX_TICKS:
        ticks += 1
        n = runner.run_sampling_once(now_ms + ticks)
        samples += n
        if not n:
            break
    out.update(sampling_s=time.perf_counter() - t0, ticks=ticks, samples=samples)
    return out


def append_costs(tmp, n=2000):
    """Microseconds a record: one ``FileTransport.append`` of a 32-byte
    record in ``tmp`` (it opens the segment file every time), and one
    ``serialize_metric``."""
    from cruise_control_tpu_torch.monitor.samples import CruiseControlMetric, RawMetricType
    from cruise_control_tpu_torch.reporter import FileTransport, serialize_metric
    bus = FileTransport(os.path.join(tmp, "append-probe"), num_partitions=1)
    rec = bytes(32)
    t0 = time.perf_counter()
    for _ in range(n):
        bus.append(0, rec)
    append_us = (time.perf_counter() - t0) / n * 1e6
    m = CruiseControlMetric(raw_type=RawMetricType.PARTITION_SIZE, time_ms=1.0, broker_id=1,
                            topic="topic0", partition=0, value=1.0)
    t0 = time.perf_counter()
    for _ in range(n):
        serialize_metric(m)
    return append_us, (time.perf_counter() - t0) / n * 1e6


def ingest_service(cfg, backend, device, now):
    """``main.build_app`` on ``backend`` with the phase's clock: the task
    runner reads ``now`` (ms) and its reporters share one timed source."""
    from cruise_control_tpu_torch.main import build_app
    app = build_app(cfg, port=0, device=device, metadata_backend=backend)
    runner = app.cc.task_runner
    runner._clock = lambda: now[0] / 1000.0
    collect_s = [0.0]
    source = next(r.source for r in runner.reporters if hasattr(r, "source"))
    collect = source.collect

    def timed(broker_id, time_ms):
        t0 = time.perf_counter()
        try:
            return collect(broker_id, time_ms)
        finally:
            collect_s[0] += time.perf_counter() - t0
    source.collect = timed
    return app, collect_s


def prometheus_server(meta):
    """A stdlib HTTP server answering the query API for ``meta``'s brokers
    and partitions (series for PrometheusMetricSampler's default queries:
    partition sizes, per-topic and per-broker rates at the demo workload's
    means), and a counter of the series it served."""
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from cruise_control_tpu_torch.monitor import sampler as demo
    host = {b.broker_id: b.host for b in meta.brokers}
    led = {}
    for p in meta.partitions:
        if p.leader is not None:
            led.setdefault(p.leader, {}).setdefault(p.topic, []).append(p)
    served = [0]

    def series(promql):
        if "topic, partition" in promql:
            return [({"instance": f"{host[p.leader]}:9092", "topic": p.topic,
                      "partition": str(p.partition)}, demo.DEMO_MEAN_SIZE)
                    for p in meta.partitions if p.leader is not None]
        rate = demo.DEMO_MEAN_BYTES_OUT if "BytesOut" in promql else demo.DEMO_MEAN_BYTES_IN
        if "topic" in promql:
            return [({"instance": f"{host[b]}:9092", "topic": t}, rate * len(ps))
                    for b, topics in led.items() for t, ps in topics.items()]
        if "cpu" in promql:
            return [({"instance": f"{host[b]}:9092"},
                     demo.DEMO_CPU_PER_LEADER * max(len(sum(led.get(b, {}).values(), [])), 1))
                    for b in host]
        return [({"instance": f"{host[b]}:9092"},
                 rate * len(sum(led.get(b, {}).values(), []))) for b in host]

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
            end = float(q["end"][0])
            result = [{"metric": labels, "values": [[end, str(v)]]}
                      for labels, v in series(q["query"][0])]
            served[0] += len(result)
            body = json.dumps({"status": "success", "data": {
                "resultType": "matrix", "result": result}}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, served


def ingest_phase(aggregate, props, device="cuda"):
    """The ingestion edge at BASELINE #3, through ``main.build_app`` in
    reporter mode with a store directory (the metrics bus and the log sample
    store are segment-file logs), four fetchers, the bus listener on a free
    port with a shared secret, and capacities at which the mean broker
    carries MONITOR_MEAN_LOAD_SHARE of each resource:

    (a) INGEST_ROUNDS reporting rounds on the phase's clock; a child process
        publishes INGEST_TCP_SHARE of the brokers' records over
        authenticated TCP (a wrong secret refused first);
    (b) the model on the card, then a dry-run rebalance of the hard goals
        over HTTP by the port's CLI client: the kernel launched, the hard
        goals met, the verifier clean on the solve's placement;
    (c) the service shut down and a second one built on the same directory:
        the log store's replay gives the same windows and valid partitions,
        its generation is not back near 0, and the committed offsets keep
        the bus from being ingested again;
    (d) on that service, a ``remove_broker`` maintenance plan published to an
        authenticated ``TransportServer``: the reader, the detection round
        and the facade's fix, executed through the broker simulator's process
        over authenticated TCP, until the broker is empty there;
    (e) the service in Prometheus mode against a query server in this
        process: one window to samples."""
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.detector.anomalies import AnomalyType
    from cruise_control_tpu_torch.detector.maintenance_reader import serialize_plan
    from cruise_control_tpu_torch.executor.subprocess_backend import SocketClusterBackend
    from cruise_control_tpu_torch.main import build_app
    from cruise_control_tpu_torch.model.builder import builder_from_snapshot
    from cruise_control_tpu_torch.monitor.load_monitor import ModelCompletenessRequirements
    from cruise_control_tpu_torch.monitor.sampler import SyntheticWorkloadSampler
    from cruise_control_tpu_torch.obsvc.audit import audit_log
    from cruise_control_tpu_torch.reporter import (InProcessTransport, SocketTransport,
                                                   TransportServer)
    from cruise_control_tpu_torch.testing import random_cluster as rc
    tmp = tempfile.mkdtemp(prefix="ingest-phase-")
    store = os.path.join(tmp, "store")
    secret = os.path.join(tmp, "bus.secret")
    with open(secret, "w") as f:
        f.write("ingest-bus-secret\n")
    st, pl, mt = rc.generate(rc.ClusterProperties(**props), device="cpu")
    backend = metadata_backend(builder_from_snapshot(st, pl, mt))
    del st, pl
    capacity = synthetic_capacity(SyntheticWorkloadSampler(), mt.num_replicas,
                                  mt.num_partitions, mt.num_brokers)
    bus_port = free_port()
    cfg = CruiseControlConfig(dict(INGEST_CONFIG, **{
        "sample.store.dir": store, "metrics.transport.listen.port": str(bus_port),
        "metrics.transport.auth.secret.file": secret,
        "capacity.config.file": capacity_file(os.path.join(tmp, "capacity.json"), capacity)}))
    hard = cfg.goal_names("hard.goals")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = dict(replicas=mt.num_replicas, partitions=mt.num_partitions, brokers=mt.num_brokers)
    now = [0.0]
    procs = []
    try:
        # ---- (a) reporting rounds, a share of them over TCP.
        app, collect_s = ingest_service(cfg, backend, device, now)
        cc, runner = app.cc, app.cc.task_runner
        check(type(runner.sampler).__name__ == "ConsumingMetricSampler"
              and type(runner.sample_store).__name__ == "LogSampleStore"
              and runner.reporters[-1].port == bus_port,
              "ingest: build_app did not wire the reporter pipeline")
        runner.start()
        app.start()
        child = subprocess.Popen([sys.executable, "-c", INGEST_CHILD,
                                  f"127.0.0.1:{bus_port}", secret], cwd=REPO, env=env,
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        procs.append(child)
        hello = json.loads(child.stdout.readline())
        check(hello["wrong_secret_refused"], "ingest: the bus took a wrong secret")
        append_us, serde_us = append_costs(tmp)
        rounds = []
        t_first = time.monotonic()
        for w in range(INGEST_ROUNDS):
            now[0] = w * INGEST_WINDOW_MS + INGEST_WINDOW_MS / 2
            rounds.append(ingest_round(runner, collect_s, now[0],
                                       os.path.join(tmp, f"stage-{w}"), child))
        child.stdin.close()
        check(child.wait(timeout=60) == 0, "ingest: the TCP publisher failed")
        lm = cc.load_monitor
        check(lm.meet_completeness_requirements(ModelCompletenessRequirements(
            INGEST_WINDOWS, MONITOR_MIN_PARTITIONS)), "ingest: the model is not complete")
        state, placement, meta = lm.cluster_model(device=device)
        sync(device)
        check(state.leader_load.device.type == "cuda" or device == "cpu",
              "ingest: the model is not on the card")
        to_model_s = time.monotonic() - t_first
        last = rounds[-1]
        total = last["records"] + last["tcp_records"]
        out["a_reporting"] = dict(
            rounds=rounds, round_records=total, round_bytes=last["bytes"],
            in_process_records_per_s=last["records"] / last["in_process_s"],
            tcp_records_per_s=last["tcp_records"] / last["tcp_s"],
            collect_share=last["collect_s"] / (last["in_process_s"] + last["stage_s"]),
            wrong_secret_refused=hello["wrong_secret_refused"],
            segment_append_us=append_us, serialize_us=serde_us)

        # ---- (b) the model on the card; the hard goals' dry run over HTTP.
        before = lm.state().to_dict()
        solves = []
        orig = GoalOptimizer.optimizations

        def recorded(opt, s, p, m, *args, **kwargs):
            res = orig(opt, s, p, m, *args, **kwargs)
            solves.append((s, p, m, res))
            return res
        GoalOptimizer.optimizations = recorded
        try:
            aggregate.LAUNCHES = 0
            t0 = time.monotonic()
            rc_, body = cli_call(f"http://127.0.0.1:{app.port}",
                                 ["rebalance", "--dryrun", "true", "--goals", ",".join(hard)])
            sync(device)
            http_s, launches = time.monotonic() - t0, aggregate.LAUNCHES
        finally:
            GoalOptimizer.optimizations = orig
        check(rc_ == 0 and body["httpStatus"] == 200,
              f"ingest: cccli rebalance exited {rc_}: {str(body)[:300]}")
        check(launches > 0, "ingest: the rebalance launched the kernel 0 times")
        violated = set(body["result"]["violatedGoalsAfter"])
        check(not violated & set(hard), f"ingest: hard goals violated after: {violated}")
        check(len(solves) == 1, f"ingest: the rebalance ran {len(solves)} solves")
        s, p, m, res = solves[0]
        judged = judge(aggregate, "ingest (b)", s, p, m, res.final_placement, device,
                       goal_names=hard)
        out["b_model"] = dict(first_report_to_model_s=to_model_s, monitor=before,
                              rebalance_http_s=http_s, kernel_launches=launches,
                              replica_moves=body["result"]["numInterBrokerReplicaMovements"],
                              violated_goals_after=sorted(violated), verifier=judged)

        # ---- (c) shut down; a second service on the same store directory.
        app.stop()
        cc.shutdown()
        maint = TransportServer(InProcessTransport(num_partitions=4),
                                auth_secret="ingest-maintenance-secret")
        maint.start()
        token = os.path.join(tmp, "admin.secret")
        with open(token, "w") as f:
            f.write("ingest-admin-token\n")
        msecret = os.path.join(tmp, "maintenance.secret")
        with open(msecret, "w") as f:
            f.write("ingest-maintenance-secret\n")
        sim = subprocess.Popen(
            [sys.executable, "-m", "cruise_control_tpu_torch.executor.broker_simulator",
             "--listen", "0", "--polls-to-finish", "1", "--auth-token-file", token],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        procs.append(sim)
        sim_port = int(json.loads(sim.stdout.readline())["listening"])
        admin = SocketClusterBackend("127.0.0.1", sim_port, auth_secret="ingest-admin-token")
        admin.request("bootstrap", partitions=[
            {"topic": q.topic, "partition": q.partition, "replicas": list(q.replicas),
             "leader": q.leader, "logdirs": {str(b): 0 for b in q.replicas}}
            for q in backend.partitions])
        cfg2 = CruiseControlConfig(dict(cfg.originals, **{
            "maintenance.event.transport.address": f"127.0.0.1:{maint.port}",
            "maintenance.event.transport.auth.secret.file": msecret,
            "maintenance.event.offsets.path": os.path.join(tmp, "maintenance-offsets.json"),
            "executor.admin.backend.address": f"127.0.0.1:{sim_port}",
            "executor.admin.backend.auth.secret.file": token}))
        app, _ = ingest_service(cfg2, backend, device, now)
        cc, runner = app.cc, app.cc.task_runner
        lm = cc.load_monitor
        t0 = time.monotonic()
        runner.start()
        replay_s = time.monotonic() - t0
        after = lm.state().to_dict()
        state, placement, meta = lm.cluster_model(device=device)
        sync(device)
        restart_to_model_s = time.monotonic() - t0
        now[0] += INGEST_WINDOW_MS / 4
        reingested = runner.run_sampling_once(now[0])
        check((after["numValidWindows"], after["monitoredPartitionsPercentage"]) ==
              (before["numValidWindows"], before["monitoredPartitionsPercentage"]),
              f"ingest: the restart's monitor {after} differs from the first's {before}")
        check(after["generation"] >= before["generation"] and after["generation"] > 1000,
              f"ingest: the restart's generation {after['generation']} is back near 0")
        check(reingested == 0, f"ingest: the restart ingested {reingested} samples again")
        out["c_restart"] = dict(replay_s=replay_s, replayed_samples=after["generation"],
                                restart_to_model_s=restart_to_model_s, monitor=after,
                                reingested_samples=reingested)

        # ---- (d) a maintenance plan through the detector, the fix and the
        # simulator's process.
        cc.set_self_healing(AnomalyType.MAINTENANCE_EVENT, True)
        victim = next(b.broker_id for b in backend.brokers
                      if any(b.broker_id in q.replicas for q in backend.partitions))
        producer = SocketTransport(f"127.0.0.1:{maint.port}",
                                   auth_secret="ingest-maintenance-secret")
        t0 = time.monotonic()
        producer.append(victim % 4, serialize_plan("remove_broker", time_ms=time.time() * 1000,
                                                   broker_ids=(victim,)))
        producer.close()
        check(cc.maintenance_reader.poll_once() == (1, 0), "ingest: the plan was not read")
        aggregate.LAUNCHES = 0
        cc.anomaly_detector.run_detection_once()
        thread = cc.executor._thread
        check(thread is not None, "ingest: the maintenance fix started no execution")
        thread.join(timeout=EXECUTE_TIMEOUT_S)
        check(not thread.is_alive(), "ingest: the fix's execution did not end")
        left = [d for d in admin.describe_topics() if victim in d["replicas"]]
        empty_s = time.monotonic() - t0
        check(not left, f"ingest: broker {victim} keeps {len(left)} replicas in the simulator")
        tasks = task_counts(cc.executor.tracker)
        check(set(tasks) == {"completed"}, f"ingest: the fix's tasks {tasks}")
        out["d_maintenance"] = dict(broker=victim, publish_to_empty_s=empty_s, tasks=tasks,
                                    kernel_launches=aggregate.LAUNCHES)
        cc.maintenance_reader._transport.close()
        # This app's HTTP server was never started (stop() would wait on it).
        app.user_tasks.shutdown()
        app.server.server_close()
        cc.shutdown()
        maint.stop()
        admin.close()
        sim.wait(timeout=30)
        audit_log().clear()

        # ---- (e) Prometheus mode: one window to samples.
        server, served = prometheus_server(backend.fetch())
        try:
            props = {k: v for k, v in cfg.originals.items()
                     if not k.startswith(("metrics.transport.", "sample.store."))}
            app = build_app(CruiseControlConfig(dict(props, **{
                "metric.sampler.mode": "prometheus",
                "prometheus.server.endpoint": f"http://127.0.0.1:{server.server_port}"})),
                port=0, device=device, metadata_backend=backend)
            runner = app.cc.task_runner
            runner._clock = lambda: now[0] / 1000.0
            runner.start()
            now[0] += INGEST_WINDOW_MS
            t0 = time.monotonic()
            samples = runner.run_sampling_once(now[0])
            prom_s = time.monotonic() - t0
            leaders = sum(1 for q in backend.partitions if q.leader is not None)
            check(samples == leaders + len(backend.brokers),
                  f"ingest: Prometheus gave {samples} samples for {leaders} partitions and "
                  f"{len(backend.brokers)} brokers")
            out["e_prometheus"] = dict(window_to_samples_s=prom_s, series=served[0],
                                       samples=samples)
            app.user_tasks.shutdown()
            app.server.server_close()
            app.cc.shutdown()
        finally:
            server.shutdown()
            server.server_close()
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def real_cuda_error():
    """A CUDA error that torch raises on the card and that leaves its context
    usable: a device ordinal past the last card.  None when torch does not
    word it as the CUDA runtime's error."""
    import torch
    try:
        torch.empty(1, device=f"cuda:{torch.cuda.device_count()}")
    except RuntimeError as e:
        if str(e).startswith("CUDA error: "):
            return e
    return None


def like_real(real, error):
    """An error of ``real``'s type and wording with the CUDA runtime's
    ``error`` (error string, enum name) in place of its own: torch's hint and
    device-side-assertion lines stay as the card's torch wrote them."""
    text, name = error
    lines = str(real).split("\n")
    lines[0] = "CUDA error: " + text
    if len(lines) > 1 and lines[1].startswith(("Search for `", "GPU device may be out of range")):
        lines[1] = (f"Search for `{name}' in https://docs.nvidia.com/cuda/cuda-runtime-api/"
                    "group__CUDART__TYPES.html for more information.")
    return type(real)("\n".join(lines))


def platform_phase(aggregate, props, device="cuda"):
    """The platform layers at BASELINE #3, through ``main.build_app`` on a
    fresh monitored cluster (sampling paused after ``start_up``, so the model
    holds still):

    (a) a cold app (warmup off): its first dry-run rebalance over HTTP;
    (b) the app of PLATFORM_CONFIG, warmup on at ``compile.warmup.lanes=4``:
        the daemon ends ``done`` with every task warmed, no error and kernel
        launches counted (per task, with its wall);
    (c) a dry-run rebalance over HTTP adds hits and 0 compiles;
    (d) ``GET /compile_cache`` and ``GET /memory`` answer 200 (schema-valid),
        the ``resident-model`` live bytes are > 0, and ``verify_balanced``
        holds against ``torch.cuda.memory_stats``; ``/state`` carries
        ``memoryState``;
    (e) a PLATFORM_LANES-lane remove batch on the 4-lane width the warmup ran
        goes as 4-lane blocks, every lane judged by the verifier; then the
        headroom fraction is set from the 4-lane cost row so that the guard
        shrinks the batch onto 2-lane blocks (judged again), then so that it
        refuses it (``memory_refused``, ``Memory.headroom-refusals`` + 1);
        between them, PLATFORM_PADDED_LANES lanes go as two 4-lane blocks, the
        second padded; each batch solves its real lanes only;
    (f) one injected device-loss error: the response is ``degraded``,
        ``Resilience.solver-cpu-failovers`` + 1 and ``/health``'s device probe
        degraded; the next solve on the card clears it and launches the
        kernel; one injected illegal-address error raises.  Both are worded
        as a real CUDA error that torch raised on the card, which is itself
        not device loss."""
    import dataclasses
    import threading
    import torch
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.client import cccli
    from cruise_control_tpu_torch.common.metrics import registry
    from cruise_control_tpu_torch.compilesvc.telemetry import telemetry
    from cruise_control_tpu_torch.config import CruiseControlConfig
    from cruise_control_tpu_torch.main import build_app
    from cruise_control_tpu_torch.obsvc import memory
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
    from cruise_control_tpu_torch.resilience import SOLVER_FAILOVER_SENSOR, is_device_failure
    from cruise_control_tpu_torch.servlet.schemas import ENDPOINT_SCHEMAS, validate

    cluster = monitored_cluster(props)
    out = dict(replicas=cluster.meta.num_replicas, brokers=cluster.meta.num_brokers,
               bootstrap_s=cluster.bootstrap_s)
    tel = telemetry()

    def serve(config):
        cfg = CruiseControlConfig(config)
        app = build_app(cfg, port=0, device=device, metadata_backend=cluster.backend,
                        monitor=(cluster.lm, cluster.runner))
        app.start()
        return cfg, app, cccli.Responder(f"http://127.0.0.1:{app.port}", poll_interval_s=0.05)

    def request(responder, endpoint, method="GET", params=None):
        spec = cccli.ENDPOINTS.get(endpoint) or cccli.EndpointSpec(endpoint, method)
        body, wall, launches = http_call(aggregate, responder, spec, params or {}, device)
        status = body.pop("httpStatus")
        check(status == 200, f"platform: {endpoint} answered {status}: {str(body)[:300]}")
        if endpoint in ENDPOINT_SCHEMAS:
            validate(body, ENDPOINT_SCHEMAS[endpoint])
        return body, dict(wall_s=wall, kernel_launches=launches)

    # (a) the cold app: no warmup, no start_up (its monitor stays the
    # phase's); the first rebalance of a fresh facade and solver.
    _, app, responder = serve(dict(PLATFORM_CONFIG, **{"compile.warmup.enabled": "false"}))
    try:
        body, out["cold_rebalance"] = request(responder, "rebalance", "POST",
                                              {"dryrun": "true"})
    finally:
        app.stop()
    check(out["cold_rebalance"]["kernel_launches"] > 0, "platform: the cold rebalance "
          "launched the kernel 0 times")

    # (b) the warm app: a fresh ledger, the daemon's tasks timed.
    memory.set_memory_ledger(None)
    cfg, app, responder = serve(PLATFORM_CONFIG)
    cc = app.cc
    tasks = {}

    def build_timed(orig=cc._build_warmup_daemon):
        daemon = orig()

        def timed(key, fn):
            def run():
                aggregate.LAUNCHES = 0
                t0 = time.monotonic()
                fn()
                sync(device)
                tasks[str(key[0]) + ("" if len(key) < 3 else f"-{key[2]}")] = dict(
                    wall_s=time.monotonic() - t0, kernel_launches=aggregate.LAUNCHES)
            return run

        daemon._tasks = [(k, timed(k, fn)) for k, fn in daemon._tasks]
        return daemon

    cc._build_warmup_daemon = build_timed
    failovers0 = registry().counter(SOLVER_FAILOVER_SENSOR).count
    try:
        t0 = time.monotonic()
        cc.start_up()
        cc.pause_sampling("platform phase")
        cc.warmup_daemon.join(timeout=PLATFORM_WARMUP_S)
        snap = cc.warmup_daemon.snapshot()
        check(snap["state"] == "done" and snap["warmed"] == snap["tasks"] == 4
              and not snap["errors"], f"platform: warmup {snap}")
        # The solving tasks launch the kernel (the delta applies' warm task
        # runs index kernels only, the relaxation's is a no-op while it is off).
        check(all(tasks[k]["kernel_launches"] > 0 for k in ("proposals", "whatif-4")),
              f"platform: a warm solve launched the kernel 0 times: {tasks}")
        out["warmup"] = dict(wall_s=time.monotonic() - t0, tasks=tasks)

        # (c) the first rebalance after warmup: hits, no compile.
        compiles, hits = tel.compile_count(), tel.hit_count()
        body, out["warm_rebalance"] = request(responder, "rebalance", "POST", {"dryrun": "true"})
        check(tel.compile_count() == compiles and tel.hit_count() > hits,
              f"platform: the warm rebalance compiled {tel.compile_count() - compiles}, "
              f"hit {tel.hit_count() - hits}")
        check(not set(body["result"]["violatedGoalsAfter"]) & set(cfg.goal_names("hard.goals")),
              f"platform: hard goals violated {body['result']['violatedGoalsAfter']}")
        out["warm_rebalance"]["hits"] = tel.hit_count() - hits

        # (d) the admin views and the ledger against the card's allocator.
        cache, _ = request(responder, "compile_cache")
        check(cache["warmup"]["state"] == "done", f"platform: compile_cache {cache['warmup']}")
        mem, _ = request(responder, "memory")
        live = mem["subsystems"]["resident-model"]["liveBytes"]
        ledger = memory.memory_ledger()
        problems = ledger.verify_balanced()
        check(live > 0 and not problems, f"platform: ledger {problems}, resident {live} B")
        state, _ = request(responder, "state")
        check("memoryState" in state["AnalyzerState"], "platform: /state has no memoryState")
        out["memory"] = dict(resident_live_bytes=live, tracked_bytes=mem["reconcile"]["trackedBytes"],
                             drift_bytes=mem["reconcile"]["driftBytes"],
                             backend_in_use_bytes=(mem["reconcile"]["backend"] or {}).get(
                                 "bytes_in_use"),
                             device_budget_bytes=mem["deviceBudgetBytes"],
                             cost_rows=len(mem["costs"]))
        out["compile_cache"] = dict(buckets=cache["telemetry"]["buckets"],
                                    compiled_lane_widths=cache["compiled_lane_widths"])

        # (e) the lane batch: 4-lane blocks, then shrunk, then refused.
        snap_state, snap_pl, snap_meta = cc.cluster_model_snapshot()
        hard = cfg.goal_names("hard.goals")
        sets = [[int(b)] for b in snap_meta.broker_ids[:PLATFORM_LANES]]
        r_pad = snap_state.num_replicas_padded
        base = f"R{r_pad}-C{min(512, r_pad)}"

        blocks = []
        lane_solves = []
        run_block = cc.optimizer._run_lane_block
        solve_goal = cc.optimizer.solver.optimize_goal

        def counted_block(gctx, seed, goals, num_candidates, alive_s, *rest):
            blocks.append(int(alive_s.shape[0]))
            return run_block(gctx, seed, goals, num_candidates, alive_s, *rest)

        def counted_solve(*args, **kwargs):
            if threading.get_ident() == batch_thread:       # not a detector's solve
                lane_solves.append(1)
            return solve_goal(*args, **kwargs)

        batch_thread = threading.get_ident()

        cc.optimizer._run_lane_block = counted_block
        cc.optimizer.solver.optimize_goal = counted_solve

        def batch(what, lane_sets=sets):
            blocks.clear()
            lane_solves.clear()
            aggregate.LAUNCHES = 0
            t0 = time.monotonic()
            res = cc.remove_brokers_batch(lane_sets)
            sync(device)
            summary = dict(wall_s=time.monotonic() - t0, kernel_launches=aggregate.LAUNCHES,
                           blocks=list(blocks), lane_goal_solves=len(lane_solves),
                           refused=res.memory_refused,
                           lane_bytes_after=ledger.live_bytes("lane-batch"))
            launches = summary["kernel_launches"]
            check(summary["lane_bytes_after"] == 0, f"platform: {what}: lane posts unbalanced")
            if res.memory_refused:
                return res, summary
            check(launches > 0, f"platform: {what}: 0 launches")
            # Padding lanes are planned, never solved.
            check(len(lane_solves) == len(lane_sets) * len(res.goal_names),
                  f"platform: {what}: {len(lane_solves)} lane solves for {len(lane_sets)} "
                  f"lanes of {len(res.goal_names)} goals")
            check_removal(res, snap_state, snap_meta, hard, f"platform {what}")
            judged = []
            for s, ids in enumerate(res.scenario_sets):
                row = snap_meta.broker_index[ids[0]]
                alive = snap_state.alive.clone()
                alive[row] = False
                lane_state = dataclasses.replace(snap_state, alive=alive)
                excluded = frozenset(ids)
                judged.append(judge(aggregate, f"platform {what}, lane {s}", lane_state,
                                    snap_pl, snap_meta, res.placement_for(s), device,
                                    goal_names=hard,
                                    options=OptimizationOptions(
                                        excluded_brokers_for_replica_move=excluded,
                                        excluded_brokers_for_leadership=excluded),
                                    verifications=("GOAL_VIOLATION", "DEAD_BROKERS"))["ms"])
            summary["verifier_ms_mean"] = sum(judged) / len(judged)
            return res, summary

        _, lanes4 = batch("4-lane blocks")
        check(lanes4["blocks"] == [4] * (PLATFORM_LANES // 4),
              f"platform: blocks {lanes4['blocks']} for {PLATFORM_LANES} lanes on width 4")
        _, padded = batch("padded 4-lane blocks", sets[:PLATFORM_PADDED_LANES])
        check(padded["blocks"] == [4, 4],
              f"platform: blocks {padded['blocks']} for {PLATFORM_PADDED_LANES} lanes on width 4")
        row = ledger.costs.row(f"{base}-L4")
        check(row is not None and row["peak_bytes"] > 0, f"platform: no cost row {base}-L4")
        budget = ledger.device_budget_bytes()
        shrinks, refusals = ledger._shrinks.count, ledger._refusals.count

        def headroom(share):
            ledger.configure(enabled=True, headroom_fraction=share * row["peak_bytes"] / budget,
                             budget_bytes=0, analysis_mode=ledger.analysis_mode)

        headroom(0.75)      # 2-lane blocks fit, 4-lane ones do not
        _, lanes2 = batch("shrunk to 2-lane blocks")
        check(ledger._shrinks.count == shrinks + 1 and lanes2["blocks"] == [2] * (
            PLATFORM_LANES // 2), f"platform: the guard did not shrink the batch: {lanes2}")
        headroom(0.2)       # not even one lane fits
        refused, lanes0 = batch("refused")
        check(refused.memory_refused and refused.preempted
              and ledger._refusals.count == refusals + 1 and lanes0["kernel_launches"] == 0
              and not lanes0["blocks"], f"platform: the guard did not refuse the batch: {lanes0}")
        ledger.configure(enabled=True, headroom_fraction=cfg["memory.headroom.fraction"],
                         budget_bytes=0, analysis_mode=ledger.analysis_mode)
        cc.optimizer._run_lane_block = run_block
        cc.optimizer.solver.optimize_goal = solve_goal
        out["lanes"] = dict(lanes=PLATFORM_LANES, cost_row=row, budget_bytes=budget,
                            four_lane_blocks=lanes4, padded=padded, shrunk=lanes2,
                            refused=lanes0)

        # (f) device failover, and a fault of the port's own.
        real_error = real_cuda_error()
        check(real_error is not None and not is_device_failure(real_error),
              f"platform: torch's own CUDA error on the card: {real_error!r}")
        device_loss = like_real(real_error, PLATFORM_DEVICE_LOSS)
        kernel_fault = like_real(real_error, PLATFORM_KERNEL_FAULT)
        real = GoalOptimizer.optimizations
        injected = []

        def inject(error):
            def flaky(self, *args, **kwargs):
                if not injected:
                    injected.append(error)
                    raise error
                return real(self, *args, **kwargs)
            return flaky

        GoalOptimizer.optimizations = inject(device_loss)
        try:
            body, failover = request(responder, "rebalance", "POST",
                                     {"dryrun": "true", "goals": PLATFORM_FAILOVER_GOAL})
        finally:
            GoalOptimizer.optimizations = real
        health, _ = request(responder, "health")
        check(body.get("degraded") is True and injected
              and registry().counter(SOLVER_FAILOVER_SENSOR).count == failovers0 + 1
              and health["probes"]["device"]["status"] == "degraded",
              f"platform: the failover: degraded={body.get('degraded')}, health {health}")
        body, clean = request(responder, "rebalance", "POST",
                              {"dryrun": "true", "goals": PLATFORM_FAILOVER_GOAL})
        health, _ = request(responder, "health")
        check("degraded" not in body and clean["kernel_launches"] > 0
              and health["probes"]["device"]["status"] == "ready",
              f"platform: the next card solve: {clean}, health {health['probes']['device']}")
        injected.clear()
        GoalOptimizer.optimizations = inject(kernel_fault)
        try:
            cc.rebalance([PLATFORM_FAILOVER_GOAL], dryrun=True)
            raised = None
        except RuntimeError as e:
            raised = str(e)
        finally:
            GoalOptimizer.optimizations = real
        check(raised == str(kernel_fault)
              and registry().counter(SOLVER_FAILOVER_SENSOR).count == failovers0 + 1,
              f"platform: the illegal-address error did not raise ({raised})")
        out["failover"] = dict(torch_cuda_error=str(real_error),
                               degraded_wall_s=failover["wall_s"],
                               degraded_kernel_launches=failover["kernel_launches"],
                               next_card_solve=clean, kernel_fault_raised=True)
    finally:
        app.stop()
        cc.shutdown()
    out["cuda_memory_allocated_bytes"] = torch.cuda.memory_allocated() if device == "cuda" else 0
    return out


def resident_phase(aggregate, props, mutations, rounds, device="cuda"):
    """Bench config #6: one full freeze seeds the resident service from a
    builder of the generated cluster; a base solve of the six hard goals;
    then rounds that each change ``mutations`` partitions' loads on the
    same builder and re-propose through a delta apply (one untimed round
    first).  No steady round may full-freeze, and the resident tensors after
    the last round equal a fresh freeze of the builder."""
    import numpy as np
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_HARD_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
    from cruise_control_tpu_torch.model.builder import builder_from_snapshot
    from cruise_control_tpu_torch.model.resident import ResidentModelService
    from cruise_control_tpu_torch.model.state import state_to_numpy
    from cruise_control_tpu_torch.obsvc.tracer import tracer
    from cruise_control_tpu_torch.testing import random_cluster as rc
    t0 = time.monotonic()
    st, pl, mt = rc.generate(rc.ClusterProperties(**props), device="cpu")
    builder = builder_from_snapshot(st, pl, mt)
    del st, pl
    build_s = time.monotonic() - t0
    hard = set(DEFAULT_HARD_GOALS)
    pad = ShapeBucketPolicy().pad_targets
    trc = tracer()
    trc.configure(enabled=True, ring_size=32)
    trc.rollup(reset=True)
    svc = ResidentModelService(device=device)
    t0 = time.monotonic()
    r_state, r_placement, r_meta = svc.snapshot(builder, pad)
    full_freeze_s = time.monotonic() - t0
    rollup = trc.rollup()
    freeze_ms = span_ms(rollup, "model.freeze")[1]
    transfer_ms = span_ms(rollup, "model.transfer")[1]
    opt = GoalOptimizer(goal_names=DEFAULT_HARD_GOALS)
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    base = opt.optimizations(r_state, r_placement, r_meta)
    sync(device)
    base_summary = solve_summary(aggregate, base, time.monotonic() - t0, hard)
    del base, r_state, r_placement
    rng = np.random.default_rng(RESIDENT_MUTATION_SEED)
    pairs = list(builder.partitions().keys())

    def mutate():
        # bench.py's drift: whole partitions' loads times U(0.85, 1.2).
        for _ in range(mutations):
            t, p = pairs[int(rng.integers(len(pairs)))]
            for r in builder.partition(t, p):
                builder.set_replica_load(t, p, r.broker_id,
                                         r.leader_load * float(rng.uniform(0.85, 1.2)))

    def propose():
        s, p, m = svc.snapshot(builder, pad)
        return opt.optimizations(s, p, m)

    mutate()
    propose()
    before = svc.stats()
    applies0 = span_ms(trc.rollup(), "model.delta_apply")
    steady = []
    for _ in range(rounds):
        mutate()
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        res = propose()
        sync(device)
        steady.append(solve_summary(aggregate, res, time.monotonic() - t0, hard))
        del res
    after = svc.stats()
    applies1 = span_ms(trc.rollup(), "model.delta_apply")
    trc.configure(enabled=False, ring_size=32)
    full_steady = after["fullFreezes"] - before["fullFreezes"]
    delta_applies = after["deltaApplies"] - before["deltaApplies"]
    apply_mean = (applies1[1] - applies0[1]) / max(applies1[0] - applies0[0], 1)
    s, p, _ = svc.snapshot(builder, pad)
    check(svc.stats() == after, "resident: a request with no change moved the sensors")
    fresh, _ = builder.freeze_packed(*pad(*builder.counts()))
    equal = packed_equal(state_to_numpy(s, p), fresh)
    out = dict(replicas=mt.num_replicas, brokers=mt.num_brokers, padded=list(pad(*builder.counts())),
               builder_s=build_s, full_freeze_s=full_freeze_s, freeze_ms=freeze_ms,
               transfer_ms=transfer_ms, freeze_transfer_ms=freeze_ms + transfer_ms,
               delta_apply_ms_mean=apply_mean,
               freeze_transfer_reduction=(freeze_ms + transfer_ms) / max(apply_mean, 1e-9),
               full_freezes_steady_state=full_steady, delta_applies=delta_applies,
               rounds=rounds, mutations_per_round=mutations, base_solve=base_summary,
               steady=steady, steady_propose_wall_s=sum(r["wall_s"] for r in steady) / rounds,
               equal_to_fresh_freeze=equal,
               cut="config #6's 16-lane decommission pair is left out (the whatif phase)")
    check(full_steady == 0, f"resident: {full_steady} full freezes in the steady rounds")
    check(delta_applies == rounds, f"resident: {delta_applies} delta applies in {rounds} rounds")
    check(equal, "resident: the resident tensors differ from a fresh freeze")
    return out


def collective_wall(fn):
    """(result, wall s, {kind: s inside it}): ``fn`` run with every
    ``torch.distributed`` all-reduce, all-gather and broadcast timed between
    two synchronizes of the card (so each kind's share is its own time)."""
    import torch
    import torch.distributed as dist
    kinds = ("all_reduce", "all_gather", "broadcast")
    spent = dict.fromkeys(kinds, 0.0)
    saved = {n: getattr(dist, n) for n in kinds}

    def timed(kind, real):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.monotonic()
            got = real(*args, **kwargs)
            torch.cuda.synchronize()
            spent[kind] += time.monotonic() - t
            return got
        return call

    for n, real in saved.items():
        setattr(dist, n, timed(n, real))
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        return res, time.monotonic() - t0, spent
    finally:
        for n, real in saved.items():
            setattr(dist, n, real)


def parallel_phase(aggregate, props, lanes, device="cuda"):
    """Multi-process solves at ``props`` (``parallel/``): (a) the default
    stack unsharded, then through ``propose_multihost`` at world size 1 over
    NCCL (``multihost.initialize``) with its collectives counted, again with
    each collective timed between synchronizes (the first run also sets up
    the communicator), and a ``lanes``-lane
    ``batch_remove_scenarios_multihost`` of the hard goals; (b) world size 2
    over gloo on the one card (NCCL takes one rank a card): two processes
    whose rank 1 passes a zeroed placement, each proposing and running the
    lanes on a (scenario 2) mesh, with identical results on both.  The
    snapshot is padded to the service's shape bucket, whose replica axis
    every world size here divides."""
    import torch
    import torch.distributed as dist
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS, DEFAULT_HARD_GOALS
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
    from cruise_control_tpu_torch.parallel import mesh, multihost
    from cruise_control_tpu_torch.testing import random_cluster as rc
    hard = hard_names(DEFAULT_GOALS)
    _, _, mt = rc.generate(rc.ClusterProperties(**props), device="cpu")
    pads = list(ShapeBucketPolicy().pad_targets(mt.num_replicas, mt.num_brokers))
    st, pl, mt = rc.generate(rc.ClusterProperties(**props), *pads, device=device)
    out = {"padded": pads}
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    plain = GoalOptimizer(goal_names=DEFAULT_GOALS).optimizations(st, pl, mt)
    sync(device)
    out["unsharded"] = dict(wall_s=time.monotonic() - t0, kernel_launches=aggregate.LAUNCHES,
                            violated_goals_after=plain.violated_goals_after,
                            balancedness=plain.balancedness_score)
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=device)
    try:
        multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=device)  # a no-op
        out["world1"] = dict(backend=dist.get_backend(), world_size=dist.get_world_size())
        mesh.reset_calls()
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        res = multihost.propose_multihost(st, pl, mt, goal_names=DEFAULT_GOALS)
        sync(device)
        wall = time.monotonic() - t0
        launches, calls = aggregate.LAUNCHES, dict(mesh.CALLS)
        check(launches > 0, "parallel: the sharded propose launched the kernel 0 times")
        check(calls["all_reduce"] > 0 and calls["all_gather"] > 0,
              f"parallel: the sharded propose issued no collectives {calls}")
        check(not set(res.violated_goals_after) & hard,
              f"parallel: hard goals violated after: {res.violated_goals_after}")
        check_proposals([p.to_dict() for p in res.proposals])
        judged = judge(aggregate, "parallel propose", st, pl, mt, res.final_placement, device,
                       goal_names=sorted(hard), goal_infos=res.goal_infos)
        _, timed_wall, in_collectives = collective_wall(
            lambda: multihost.propose_multihost(st, pl, mt, goal_names=DEFAULT_GOALS))
        in_all = sum(in_collectives.values())
        out["world1"].update(
            propose_wall_s=wall, kernel_launches=launches, collectives=calls,
            violated_goals_after=res.violated_goals_after,
            unsharded_violated_goals_after=plain.violated_goals_after,
            balancedness=res.balancedness_score, proposals=len(res.proposals),
            rounds=[i.rounds for i in res.goal_infos], verifier=judged,
            timed_wall_s=timed_wall, collectives_s=in_all, collectives_s_by_kind=in_collectives,
            collectives_share=in_all / timed_wall)
        sets = [[b] for b in mt.broker_ids[:lanes]]
        mesh.reset_calls()
        lres, lwall, llaunches = run_lanes(aggregate, lambda: (
            multihost.batch_remove_scenarios_multihost(
                st, pl, mt, sets, goal_names=DEFAULT_HARD_GOALS, scenario_parallelism=1,
                num_candidates=LANE_WIDTH)), device)
        check(llaunches > 0, "parallel lanes: the kernel launched 0 times")
        check_removal(lres, st, mt, DEFAULT_HARD_GOALS, "parallel lanes")
        out["world1_lanes"] = dict(collectives=dict(mesh.CALLS),
                                   **lane_summary(lres, lwall, llaunches))
    finally:
        dist.destroy_process_group()
    del st, pl, plain, res, lres

    # (b) two ranks over gloo on the card.
    ranks, wall = run_ranks(aggregate, props, pads, lanes, 2, "gloo", device)
    out["world2_gloo"] = dict(processes_wall_s=wall, equal_on_all_ranks=True,
                              propose_wall_s=[r["propose"]["wall_s"] for r in ranks],
                              lanes_wall_s=[r["lanes"]["wall_s"] for r in ranks])
    return out


def run_ranks(aggregate, props, pads, lanes, world, backend, device="cuda", compare=False):
    """``world`` processes of ``PARALLEL_CHILD`` over ``backend`` (gloo: all
    on one card or the CPU; NCCL: one a card), rank 1 and up passing a
    zeroed placement; each proposes the default stack through
    ``propose_multihost`` (``compare``: again warm, then unsharded on its
    card) and runs ``lanes`` removal lanes of the hard goals on a
    (scenario 2) mesh.  Checks every rank's results and that the ranks'
    are identical; returns (each rank's results, the processes' wall s)."""
    what = f"parallel world {world} ({backend})"
    with tempfile.TemporaryDirectory() as tmp:
        script = os.path.join(tmp, "rank.py")
        with open(script, "w") as f:
            f.write(PARALLEL_CHILD)
        # Ranks that share the host's cores: one compute thread each, or
        # their spinning threads starve each other's collectives.
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        addr = f"127.0.0.1:{free_port()}"
        t0 = time.monotonic()
        procs = [subprocess.Popen([sys.executable, script, str(r), addr, json.dumps(props),
                                   json.dumps(pads), str(lanes), str(LANE_WIDTH), device,
                                   str(world), backend, "1" if compare else "0"],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env)
                 for r in range(world)]
        try:
            outs = [p.communicate(timeout=PARALLEL_CHILD_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.monotonic() - t0
    ranks = []
    for p, text in zip(procs, outs):
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        check(p.returncode == 0 and line, f"{what}: a rank failed: {text[-2000:]}")
        ranks.append(json.loads(line[-1][len("RESULT "):]))
    # The ranks' own lines, before any check reads them.
    emit(f"parallel_world{world}_{backend}", processes_wall_s=wall, ranks=ranks)
    from cruise_control_tpu_torch.analyzer.goals.registry import DEFAULT_GOALS
    hard = hard_names(DEFAULT_GOALS)
    solves = [n for n in ("propose", "propose_warm", "unsharded") if n in ranks[0]]
    for r in ranks:
        check(all(r[n]["kernel_launches"] > 0 for n in solves + ["lanes"]),
              f"{what}, rank {r['rank']}: the kernel launched 0 times")
        for n in solves:
            check(not set(r[n]["violated_goals_after"]) & hard,
                  f"{what} {n}: hard goals violated: {r[n]['violated_goals_after']}")
            check(not r[n]["verifier"], f"{what} {n}: the verifier failed: {r[n]['verifier']}")
        check(all(r["lanes"]["evacuated"]) and not any(r["lanes"]["stranded_after"]),
              f"{what} lanes: not evacuated: {r['lanes']}")
    for n in [n for n in solves if n != "unsharded"] + ["lanes"]:
        check(len({r[n]["digest"] for r in ranks}) == 1, f"{what}: the ranks' {n} differ")
    return ranks, wall


def cards_main(cards):
    """``--cards N``: the sharded propose and the scenario-parallel lanes at
    BASELINE #3 over NCCL, one rank a card, at world size 2 and N, each rank
    also timing its warm sharded propose against the unsharded one."""
    import torch
    have = torch.cuda.device_count()
    if have < cards:
        print(f"chip_smoke: --cards {cards} but {have} cards", file=sys.stderr)
        return 2
    from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
    from cruise_control_tpu_torch.ops import aggregate
    from cruise_control_tpu_torch.testing import random_cluster as rc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, device_count=have,
         nvidia_smi=smi)
    emit("build", seconds=aggregate.load_seconds())
    _, _, mt = rc.generate(rc.ClusterProperties(**BASELINE3), device="cpu")
    pads = list(ShapeBucketPolicy().pad_targets(mt.num_replicas, mt.num_brokers))
    for world in sorted({2, cards}):
        ranks, wall = run_ranks(aggregate, BASELINE3, pads, PARALLEL_LANES, world, "nccl",
                                compare=True)
        emit("cards", world=world, backend="nccl", padded=pads, processes_wall_s=wall,
             **{n: [r[n]["wall_s"] for r in ranks]
                for n in ("propose", "propose_warm", "unsharded", "lanes")},
             collectives=ranks[0]["propose_warm"]["collectives"],
             launches=ranks[0]["propose_warm"]["kernel_launches"])
    print(smi[0] if smi else "not measured", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": have}}), flush=True)
    return 0


def fuzz_phase(aggregate, device="cuda"):
    """The scenario fuzzer on the card (``fuzzsvc/``): (a) the fixed-seed
    corpus, one scenario a kind (seeds 100-107), every invariant of its kind,
    each invariant's kernel launches counted on its own (the shared base
    solve's apart); (b) one storm cycle; (c) bench config #9: the storm
    stack's rebalance executed, its execution wall and moves a second."""
    from cruise_control_tpu_torch.fuzzsvc import (
        SCENARIO_KINDS, Materialized, build_storm_stack, generate_scenario, run_invariants,
        run_storm)
    from cruise_control_tpu_torch.fuzzsvc.storm import _wait_idle
    from cruise_control_tpu_torch.obsvc.execution import execution
    out = {"corpus": []}
    for i, kind in enumerate(SCENARIO_KINDS):
        sc = generate_scenario(FUZZ_BASE_SEED + i, kind=kind)
        m = Materialized(sc, device=device)
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        base = m.base
        sync(device)
        row = dict(scenario=sc.name, base_s=time.monotonic() - t0,
                   base_launches=aggregate.LAUNCHES,
                   base_violated_after=base.violated_goals_after, invariants={})
        for name in sc.invariants:
            aggregate.LAUNCHES = 0
            r = run_invariants(sc, which=[name], materialized=m)[0]
            sync(device)
            row["invariants"][name] = dict(ok=r.ok, s=r.elapsed_s,
                                           kernel_launches=aggregate.LAUNCHES)
            check(r.ok, f"fuzz {sc.name}: {r}")
        check(row["base_launches"] > 0, f"fuzz {sc.name}: the base solve launched 0 times")
        out["corpus"].append(row)
    aggregate.LAUNCHES = 0
    t0 = time.monotonic()
    rep = run_storm(generate_scenario(FUZZ_STORM_SEED, kind="maintenance_window"), cycles=1,
                    device=device)
    out["storm"] = dict(wall_s=time.monotonic() - t0, kernel_launches=aggregate.LAUNCHES,
                        cycles=rep.cycles_run, anomalies=rep.anomalies_detected,
                        fixes_started=rep.fixes_started, audit_entries=len(rep.audit),
                        problems=rep.problems)
    check(rep.ok, f"fuzz storm: {rep.problems}")
    check(aggregate.LAUNCHES > 0, "fuzz storm: the fixer's solve launched 0 times")

    rec = execution()
    prev = rec.enabled
    rec.configure(enabled=True)
    rec.drain()
    stack = build_storm_stack(generate_scenario(FUZZ_BENCH9_SEED, kind="exp_skew"),
                              num_brokers=6, partitions=FUZZ_BENCH9_PARTITIONS, rf=2,
                              polls_to_finish=2, device=device)
    try:
        aggregate.LAUNCHES = 0
        t0 = time.monotonic()
        res = stack.cc.rebalance(dryrun=False)
        idle = _wait_idle(stack.cc, FUZZ_IDLE_S)
        wall = time.monotonic() - t0
        batches = rec.drain()
        check(idle, f"fuzz config #9: the executor never went idle in {FUZZ_IDLE_S} s")
        check(batches, "fuzz config #9: no execution batch recorded")
        b = batches[-1]
        out["bench_config_9"] = dict(
            wall_s=wall, kernel_launches=aggregate.LAUNCHES, executed=bool(res.executed),
            execute_ms=b["durationMs"], moves_per_s=b["movesPerSecond"], moves=b["moves"],
            completed=b["completed"], dead=b["dead"], aborted=b["aborted"],
            provenance_paths=b["pathHistogram"])
        check(aggregate.LAUNCHES > 0, "fuzz config #9: the solve launched 0 times")
        check(res.executed and b["completed"] == b["moves"] > 0,
              f"fuzz config #9: not every move completed: {out['bench_config_9']}")
    finally:
        stack.cc.anomaly_detector.shutdown()
        rec.configure(enabled=prev)
        rec.reset()
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

    # ---- the load monitor at BASELINE #3, then the resident steady state
    # (bench config #6) at 1M replicas.
    out, mon = monitor_phase(aggregate, BASELINE3)
    emit("monitor", **out)

    # ---- on the monitor's cluster (its dead broker restarted): the goal-
    # violation solves, the execution of a hard-goal solve through the fake
    # admin backend and through the broker simulator's process, then a broker
    # failure detected and fixed by self-healing.
    from cruise_control_tpu_torch.detector.detectors import GoalViolationDetector
    revive_broker(mon.backend, mon.dead)
    detector = GoalViolationDetector(mon.lm, device="cuda")
    violations_before = goal_violations(aggregate, detector)
    out, done = execute_phase(aggregate, mon)
    emit("execute", **out)
    emit("execute_subprocess", **execute_subprocess_phase(aggregate, done,
                                                          SUBPROCESS_PROPOSALS))
    emit("detect", **detect_phase(aggregate, mon, detector, violations_before))
    del mon, done, detector

    # ---- CruiseControl on a fresh monitored BASELINE #3 cluster: every
    # operation, the precompute daemon, self-healing and the shutdown drain.
    emit("facade", **facade_phase(aggregate, BASELINE3))

    # ---- the REST server in front of the facade at BASELINE #3, driven over
    # HTTP by the CLI client; then the service's own entry point as a process.
    emit("servlet", **servlet_phase(aggregate, BASELINE3))
    emit("main", **main_phase())
    # ---- the ingestion edge at BASELINE #3: reporters, the bus (in process
    # and over TCP), the log store's restart, a maintenance plan, Prometheus.
    emit("ingest", **ingest_phase(aggregate, BASELINE3))
    # ---- the platform layers at BASELINE #3: warmup, lane chunks, the memory
    # ledger and its guard, device failover.
    emit("platform", **platform_phase(aggregate, BASELINE3))
    emit("resident", **resident_phase(aggregate, RESIDENT, RESIDENT_MUTATIONS,
                                      RESIDENT_ROUNDS))
    # ---- multi-process solves at BASELINE #3 (NCCL at world size 1, gloo at
    # 2 on the one card), then the scenario fuzzer and its storm.
    emit("parallel", **parallel_phase(aggregate, BASELINE3, PARALLEL_LANES))
    emit("fuzz", **fuzz_phase(aggregate))
    # The one CPU rerun of the whole run is the platform phase's injected one.
    from cruise_control_tpu_torch.common.metrics import registry
    from cruise_control_tpu_torch.resilience import SOLVER_FAILOVER_SENSOR
    failovers = registry().counter(SOLVER_FAILOVER_SENSOR).count
    check(failovers == 1, f"{failovers} solver CPU failovers in the run, 1 injected")
    emit("failovers", solver_cpu_failovers=failovers)

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
        if sys.argv[1:2] == ["--cards"]:
            import torch
            if not torch.cuda.is_available():
                print("chip_smoke: torch.cuda.is_available() is false; nothing run",
                      file=sys.stderr)
                sys.exit(2)
            sys.path.insert(0, REPO)
            sys.exit(cards_main(int(sys.argv[2])))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
