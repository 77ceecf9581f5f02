"""The port's compile service (``compilesvc/``) against the JAX package's.

Counterparts of ``tests/test_compilesvc.py``: the lane-chunk planner's
plans equal the JAX planner's over a grid of batch widths, ladders, compiled
sets and caps; the persistent cache's versioned layout, manifest, quarantine
and eviction (the port keeps the aggregate kernel's library where JAX keeps
XLA executables); the warmup daemon's lifecycle; ``configure`` from the same
properties; the telemetry bucket table after the same three solves (cold,
warm at the same bucket, a new bucket); a 6-lane remove batch chunked on a
ladder with width 4 already run; and a facade's warmup daemon on the CPU.
Each test puts the process-wide compile service and telemetry it touches
back (``_fresh`` below).
"""

from __future__ import annotations

import importlib
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
from cruise_control_tpu.analyzer.solver import GoalSolver as JSolver
from cruise_control_tpu.common.metrics import MetricRegistry as JRegistry
from cruise_control_tpu.compilesvc import cache as jcache
from cruise_control_tpu.compilesvc import chunking as jchunking
from cruise_control_tpu.compilesvc import service as jservice
from cruise_control_tpu.compilesvc import warmup as jwarmup
from cruise_control_tpu.config import CruiseControlConfig as JConfig
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
from cruise_control_tpu_torch.analyzer.solver import GoalSolver
from cruise_control_tpu_torch.common.metrics import MetricRegistry
from cruise_control_tpu_torch.compilesvc import cache, chunking, service, warmup
from cruise_control_tpu_torch.config import CruiseControlConfig
from cruise_control_tpu_torch.ops import aggregate
from cruise_control_tpu_torch.servlet.schemas import ENDPOINT_SCHEMAS, validate
from cruise_control_tpu_torch.testing import random_cluster as trc

# The packages' ``compilesvc`` exports a ``telemetry()`` function under the
# module's name.
telemetry = importlib.import_module("cruise_control_tpu_torch.compilesvc.telemetry")
jtelemetry = importlib.import_module("cruise_control_tpu.compilesvc.telemetry")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Fresh process-wide compile services and telemetry in both packages
    for each test, put back afterwards."""
    monkeypatch.setattr(service, "_GLOBAL", None)
    monkeypatch.setattr(jservice, "_GLOBAL", None)
    monkeypatch.setattr(telemetry, "_GLOBAL", telemetry.CompileTelemetry(MetricRegistry()))
    monkeypatch.setattr(jtelemetry, "_GLOBAL", jtelemetry.CompileTelemetry(JRegistry()))
    yield


# ---------------------------------------------------------------- chunking

LADDERS = [(1, 2, 4, 8, 16, 32, 64), (1, 4, 16), (2, 8), (4,), (3, 5, 7)]
COMPILED = [(), (4,), (16,), (4, 16), (2, 8, 32), (1,), (64,)]


def _plan(mod, *args, **kw):
    try:
        return [(c.size, c.start, c.n_real) for c in mod.plan_lane_chunks(*args, **kw)]
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("ladder", LADDERS, ids=lambda ld: "-".join(map(str, ld)))
def test_lane_plans_equal_jax(ladder):
    for n in range(0, 71):
        for compiled in COMPILED:
            for cap in (None, 16, 4, 2):
                got = _plan(chunking, n, ladder, compiled=compiled, max_chunk=cap)
                want = _plan(jchunking, n, ladder, compiled=compiled, max_chunk=cap)
                assert got == want, (n, ladder, compiled, cap)
                if isinstance(got, list):
                    chunks = chunking.plan_lane_chunks(n, ladder, compiled, cap)
                    jchunks = jchunking.plan_lane_chunks(n, ladder, compiled, cap)
                    assert chunking.plan_is_identity(chunks, n) == \
                        jchunking.plan_is_identity(jchunks, n)
                    assert [c.padded for c in chunks] == [c.padded for c in jchunks]
    assert _plan(chunking, 4, ()) == _plan(jchunking, 4, ())


def test_plan_lanes_through_the_service_equal_jax():
    for chunking_on in (True, False):
        svc, jsvc = (service.CompileService(chunking_enabled=chunking_on),
                     jservice.CompileService(chunking_enabled=chunking_on))
        key = svc.lane_key(["RackAwareGoal"], 256, 8, 64)
        jkey = jsvc.lane_key(["RackAwareGoal"], 256, 8, 64)
        assert key == jkey
        for width in (4, 8):
            svc.note_lanes_compiled(key, width)
            jsvc.note_lanes_compiled(jkey, width)
        for n in (1, 6, 13, 64, 70):
            assert [tuple(vars(c).values()) for c in svc.plan_lanes(n, key)] == \
                [tuple(vars(c).values()) for c in jsvc.plan_lanes(n, jkey)]
        assert svc.snapshot()["compiled_lane_widths"] == \
            jsvc.snapshot()["compiled_lane_widths"]


# ------------------------------------------------------------------ cache

@pytest.fixture
def build_dir(monkeypatch):
    """The aggregate kernel's build directory, put back afterwards."""
    monkeypatch.setattr(aggregate, "_BUILD_DIR", aggregate._BUILD_DIR)
    return aggregate


def test_cache_layout_manifest_and_warm_start(tmp_path, build_dir):
    c = cache.PersistentCompileCache(root=str(tmp_path), enabled=True)
    assert c.activate(platform_name="cuda") is False
    want = tmp_path / f"v{cache.SCHEMA_VERSION}" / f"cuda-{cache.machine_fingerprint()}" \
        / f"torch-{cache.toolchain_version()}"
    # The JAX package's versioned prefix, with torch+CUDA for jaxlib; its
    # goal-stack and bucket levels key executables, not the kernel library.
    jwant = jcache.PersistentCompileCache(root=str(tmp_path)).cache_dir("cuda", "abc", "R64")
    jparts = os.path.relpath(jwant, tmp_path).split(os.sep)
    assert jparts[:2] == os.path.relpath(want, tmp_path).split(os.sep)[:2]
    assert jparts[2].startswith("jaxlib-") and jparts[3:] == ["abc", "R64"]
    assert c.active_dir == str(want) and aggregate._BUILD_DIR == want
    with open(want / "cc-cache-manifest.json") as f:
        assert json.load(f) == {"schema": cache.SCHEMA_VERSION,
                                "torch": cache.toolchain_version(),
                                "fingerprint": cache.machine_fingerprint()}
    stats = c.stats()
    assert (stats["warm"], stats["entries"], stats["applies_to"]) == (False, 0, "this process")
    # A library built there makes the next process's activation warm.
    (want / "libcc_aggregate_0123.so").write_bytes(b"x" * 10)
    again = cache.PersistentCompileCache(root=str(tmp_path), enabled=True)
    assert again.activate(platform_name="cuda") is True
    assert again.stats()["entries"] == 1 and again.stats()["bytes"] == 10


def test_cache_after_load_serves_later_processes(tmp_path, build_dir, monkeypatch):
    before = aggregate._BUILD_DIR
    monkeypatch.setattr(aggregate, "_fn", object())     # the library is loaded
    c = cache.PersistentCompileCache(root=str(tmp_path), enabled=True)
    c.activate(platform_name="cuda")
    assert aggregate._BUILD_DIR == before
    assert c.stats()["applies_to"] == "later processes" and c.active_dir is not None


def test_cache_off_on_cpu_and_when_disabled(tmp_path, build_dir):
    before = aggregate._BUILD_DIR
    c = cache.PersistentCompileCache(root=str(tmp_path), enabled=True)
    assert c.activate(platform_name="cpu") is False
    assert c.stats()["inactive_reason"] == "nothing is compiled for the CPU"
    off = cache.PersistentCompileCache(root=str(tmp_path))
    assert off.activate(platform_name="cuda") is False and off.active_dir is None
    assert aggregate._BUILD_DIR == before and not os.listdir(tmp_path)


def test_hermetic_cache_is_the_cache_activation(tmp_path, build_dir, monkeypatch):
    """``hermetic.enable_persistent_compilation_cache`` activates the
    persistent cache (its versioned entry under the per-user root by
    default): off without a card, and "warm" once a library is there."""
    from cruise_control_tpu_torch.utils import hermetic

    before = aggregate._BUILD_DIR
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert hermetic.enable_persistent_compilation_cache() is False
    assert aggregate._BUILD_DIR == before and not os.listdir(tmp_path)
    monkeypatch.setattr(cache, "_default_platform", lambda: "cuda")
    assert hermetic.enable_persistent_compilation_cache() is False
    want = cache.PersistentCompileCache().cache_dir("cuda")
    assert want.startswith(cache.default_root()) and aggregate._BUILD_DIR == Path(want)
    (Path(want) / "libcc_aggregate_0123.so").write_bytes(b"x")
    assert hermetic.enable_persistent_compilation_cache(str(tmp_path / "elsewhere")) is False
    assert hermetic.enable_persistent_compilation_cache() is True


def test_hermetic_force_cpu_hides_the_cards(monkeypatch):
    import torch

    from cruise_control_tpu_torch.utils import hermetic

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    hermetic.force_cpu()
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    assert hermetic.probe_cuda() is False        # hidden: not even probed
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="after CUDA was initialized"):
        hermetic.force_cpu()


def test_hermetic_probe_cuda_in_a_subprocess(monkeypatch):
    import torch

    from cruise_control_tpu_torch.utils import hermetic

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert hermetic.probe_cuda(timeout_s=120) is torch.cuda.is_available()
    assert hermetic.probe_cuda(timeout_s=0.001) is False     # a probe that hangs


def test_broken_cache_deactivates_never_raises(tmp_path, build_dir):
    root = tmp_path / "not-a-dir"
    root.write_text("a file where the root should be")
    c = cache.PersistentCompileCache(root=str(root), enabled=True)
    assert c.activate(platform_name="cuda") is False
    assert c.active_dir is None and c.stats()["inactive_reason"].startswith("error")


@pytest.mark.parametrize("manifest", ["{not json", json.dumps({"schema": 0})],
                         ids=["unreadable", "mismatch"])
def test_cache_quarantine_equals_jax(tmp_path, build_dir, manifest):
    """A bad manifest moves the directory aside in both packages."""
    for name, mod in (("port", cache), ("jax", jcache)):
        d = tmp_path / name / "entry"
        d.mkdir(parents=True)
        (d / "cc-cache-manifest.json").write_text(manifest)
        (d / "blob").write_bytes(b"1")
        mod.PersistentCompileCache(root=str(tmp_path))._validate_or_quarantine(str(d))
        assert sorted(os.listdir(d.parent)) == ["entry.quarantined"], name
    # Activation recreates the directory, empty, and is cold.
    c = cache.PersistentCompileCache(root=str(tmp_path / "act"), enabled=True)
    path = c.cache_dir("cuda")
    os.makedirs(path)
    with open(os.path.join(path, "cc-cache-manifest.json"), "w") as f:
        f.write(manifest)
    open(os.path.join(path, "lib.so"), "wb").close()
    assert c.activate(platform_name="cuda") is False
    assert os.path.isdir(path + ".quarantined") and os.listdir(path) == ["cc-cache-manifest.json"]


def test_cache_eviction_equals_jax(tmp_path):
    now = time.time()
    removed = {}
    for name, mod in (("port", cache), ("jax", jcache)):
        d = tmp_path / name
        d.mkdir()
        for i, size in enumerate((50, 40, 30, 20, 10)):
            f = d / f"e{i}"
            f.write_bytes(b"x" * size)
            os.utime(f, (now - 100 + i, now - 100 + i))
        (d / "cc-cache-manifest.json").write_text("{}")
        got = mod.PersistentCompileCache(root=str(tmp_path), max_bytes=45).evict(str(d))
        removed[name] = (got, sorted(os.listdir(d)))
    assert removed["port"] == removed["jax"] == (120, ["cc-cache-manifest.json", "e3", "e4"])


# ----------------------------------------------------------------- warmup

def _lifecycle(mod):
    calls, ran = [], []
    d = mod.WarmupDaemon()
    d.add_task("k1", lambda: calls.append(1))
    d.add_task("k1", lambda: calls.append(2))

    def boom():
        raise RuntimeError("no model yet")

    d.add_task("bad", boom)
    d.add_task("k2", lambda: calls.append(3))
    d.start()
    d.join(timeout=10)
    d.start()                       # a restart skips what is warmed
    d.join(timeout=10)
    snap = d.snapshot()
    release = threading.Event()
    d2 = mod.WarmupDaemon()
    d2.add_task("slow", lambda: release.wait(10))
    d2.add_task("never", lambda: ran.append(1))
    d2.start()
    d2.stop(timeout=0)              # stop while the first task is in flight
    release.set()
    d2.join(timeout=10)
    return (calls, sorted(d.warmed_keys()), snap["state"], snap["tasks"], snap["warmed"],
            [e.split(":")[0] for e in snap["errors"]], d2.snapshot()["state"], ran,
            d2.should_abort())


def test_warmup_lifecycle_equals_jax():
    got, want = _lifecycle(warmup), _lifecycle(jwarmup)
    assert got == want
    assert got[:3] == ([1, 3], ["k1", "k2"], "done") and got[6] == "stopped"


# ---------------------------------------------------------------- service

PROPS = [
    {},
    {"compile.replica.pad.floor": "128", "compile.broker.pad.floor": "16",
     "compile.bucket.growth": "1.5", "compile.max.lane.bucket": "8",
     "compile.warmup.enabled": "false", "compile.warmup.lanes": "2,8,4",
     "compile.lane.chunking.enabled": "false",
     "compile.persistent.cache.max.bytes": "1024"},
    {"compile.warmup.lanes": "16", "compile.persistent.cache.enabled": "true",
     "compile.persistent.cache.path": "/nonexistent/cc-root"},
]


def _policy_fields(snap):
    return {k: snap[k] for k in ("policy", "chunking_enabled", "warmup_enabled",
                                 "warmup_lane_ladder", "compiled_lane_widths")}


@pytest.mark.parametrize("env", [None, "1", "/tmp/cc-env-root"])
@pytest.mark.parametrize("props", PROPS, ids=["defaults", "every-key", "cache-on"])
def test_configure_equals_jax(props, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("CC_TPU_PERSIST_CACHE", raising=False)
    else:
        monkeypatch.setenv("CC_TPU_PERSIST_CACHE", env)
    svc = service.configure(CruiseControlConfig(props))
    jsvc = jservice.configure(JConfig(props))
    assert svc is service.compile_service() and jsvc is jservice.compile_service()
    assert _policy_fields(svc.snapshot()) == _policy_fields(jsvc.snapshot())
    assert (svc.cache.enabled, svc.cache.max_bytes) == (jsvc.cache.enabled, jsvc.cache.max_bytes)
    if jsvc.cache.root != jcache.default_root():
        assert svc.cache.root == jsvc.cache.root
    else:
        assert svc.cache.root == cache.default_root()
    validate({**svc.snapshot(), "warmup": None}, ENDPOINT_SCHEMAS["compile_cache"])
    assert service.goal_stack_hash(["A", "B"]) == jservice.goal_stack_hash(["A", "B"])


# -------------------------------------------------------------- telemetry

# One hard goal and one soft goal after it (no polish pass), so each JAX
# side compiles two goal families a bucket.
GOALS = ["RackAwareGoal", "ReplicaDistributionGoal"]
SMALL = dict(num_brokers=8, num_racks=4, num_topics=12, num_replicas=256, seed=11)
LARGER = dict(SMALL, num_replicas=600, seed=12)


def test_bucket_table_equal_after_cold_warm_and_new_bucket():
    """The same three solves through both packages (cold, warm at the same
    bucket, a new bucket) leave the same labels, hits, misses and compiles;
    the warm solve adds no compile in either."""
    runs = {}
    for name in ("port", "jax"):
        if name == "port":
            opt, tel = GoalOptimizer(goal_names=GOALS), telemetry.telemetry()
            gen = lambda p: trc.generate(trc.ClusterProperties(**p), device="cpu")  # noqa: E731
        else:
            opt, tel = JOptimizer(goal_names=GOALS), jtelemetry.telemetry()
            gen = lambda p: jrc.generate(jrc.ClusterProperties(**p))  # noqa: E731
        tables = []
        for props in (SMALL, SMALL, LARGER):
            state, placement, meta = gen(props)
            opt.optimizations(state, placement, meta)
            tables.append((tel.bucket_table(), tel.compile_count(), tel.hit_count(),
                           tel.miss_count()))
        runs[name] = tables
    assert runs["port"] == runs["jax"]
    table, compiles, hits, misses = runs["port"][0]
    assert compiles == misses == len(GOALS) and hits == 0
    assert runs["port"][1][1] == compiles          # warm: 0 compiles
    assert len(runs["port"][2][0]) == 2            # a second bucket label


def test_cost_rows_follow_the_bucket_table(monkeypatch):
    from cruise_control_tpu_torch.obsvc import memory
    monkeypatch.setattr(memory, "_LEDGER", memory.DeviceMemoryLedger())
    memory.memory_ledger().configure(enabled=True)
    state, placement, meta = trc.generate(trc.ClusterProperties(**SMALL), device="cpu")
    GoalOptimizer(goal_names=GOALS).optimizations(state, placement, meta)
    rows = memory.cost_ledger().rows()
    compiled = {k for k, v in telemetry.telemetry().bucket_table().items() if v["compiles"]}
    assert set(rows) == compiled
    for row in rows.values():
        assert row["mode"] == "lowered" and row["flops"] == 0.0 and row["arg_bytes"] > 0
        assert row["peak_bytes"] == row["arg_bytes"] + row["out_bytes"]


# ------------------------------------------------------------ lane chunks

REMOVE_GOALS = GOALS
SETS = [[0], [1], [2], [3], [4], [5]]
WIDTH = 64


def test_six_lane_batch_chunked_on_width_four_equals_jax():
    """A 6-lane remove batch with width 4 already run on a (1, 2, 4, 8)
    ladder runs as two 4-lane blocks (the second rides 4 with two padding
    lanes) in both packages; jitter off, every lane's outcome is equal.  The
    port solves only the six real lanes."""
    got = {}
    solves = []
    for name in ("port", "jax"):
        if name == "port":
            svc = service.CompileService(policy=service.ShapeBucketPolicy(
                lane_ladder=(1, 2, 4, 8), max_lane_bucket=8))
            service.set_compile_service(svc)
            st, pl, mt = trc.generate(trc.ClusterProperties(**SMALL), device="cpu")
            opt = GoalOptimizer(goal_names=REMOVE_GOALS, solver=GoalSolver(dst_jitter_frac=0.0))
            tel = telemetry.telemetry()
            solve_goal = opt.solver.optimize_goal
            opt.solver.optimize_goal = lambda *a, **kw: solves.append(a[0].name) or solve_goal(
                *a, **kw)
        else:
            svc = jservice.CompileService(policy=jservice.ShapeBucketPolicy(
                lane_ladder=(1, 2, 4, 8), max_lane_bucket=8))
            jservice.set_compile_service(svc)
            st, pl, mt = jrc.generate(jrc.ClusterProperties(**SMALL))
            opt = JOptimizer(goal_names=REMOVE_GOALS, solver=JSolver(dst_jitter_frac=0.0))
            tel = jtelemetry.telemetry()
        key = svc.lane_key(REMOVE_GOALS, st.num_replicas_padded, int(np.asarray(st.alive).shape[0]),
                           WIDTH)
        svc.note_lanes_compiled(key, 4)
        plan = [(c.size, c.start, c.n_real) for c in svc.plan_lanes(len(SETS), key)]
        res = opt.batch_remove_scenarios(st, pl, mt, SETS, num_candidates=WIDTH)
        got[name] = dict(plan=plan, stranded=np.asarray(res.stranded_after).tolist(),
                         violated=np.asarray(res.violated_after).tolist(),
                         goals=res.goal_names, refused=res.memory_refused,
                         widths=sorted(svc.compiled_lane_widths(key)),
                         table=tel.bucket_table(),
                         lanes=int(np.asarray(res.final_placements.broker).shape[0]))
    assert got["port"] == got["jax"]
    assert got["port"]["plan"] == [(4, 0, 4), (4, 4, 2)] and got["port"]["lanes"] == 6
    assert len(solves) == len(SETS) * len(got["port"]["goals"])


# ------------------------------------------------------- facade warmup

def test_facade_warmup_daemon_on_the_cpu():
    """``start_up`` with warmup on runs every task of the default stack to
    ``done`` (proposals, a what-if per ladder width, the delta applies, the
    relaxation's no-op) and ``GET /compile_cache`` shows it; a later
    proposals call at the same bucket compiles nothing."""
    from tests.test_torch_facade import PKGS, _mods, build_stack

    service.set_compile_service(service.CompileService(warmup_enabled=True,
                                                       warmup_lanes=[2]))
    m = _mods(PKGS["torch"])
    cc, _, _ = build_stack(m)
    from cruise_control_tpu_torch.servlet.server import CruiseControlApp
    app = CruiseControlApp(cc, port=0)
    try:
        cc.start_up()
        cc.warmup_daemon.join(timeout=120)
        snap = cc.warmup_daemon.snapshot()
        assert (snap["state"], snap["tasks"], snap["warmed"], snap["errors"]) == \
            ("done", 4, 4, [])
        status, body, _ = app.handle("GET", "compile_cache", {}, None)
        assert status == 200 and body["warmup"]["state"] == "done"
        validate(body, ENDPOINT_SCHEMAS["compile_cache"])
        assert [2] in body["compiled_lane_widths"].values()
        tel = telemetry.telemetry()
        before = (tel.compile_count(), tel.hit_count())
        cc.rebalance(dryrun=True)
        assert tel.compile_count() == before[0] and tel.hit_count() > before[1]
    finally:
        app.user_tasks.shutdown()
        app.server.server_close()
        cc.shutdown()
