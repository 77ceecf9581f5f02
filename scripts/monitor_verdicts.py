#!/usr/bin/env python3
"""Both packages' default stack on the monitor phase's model, on the CPU.

    JAX_PLATFORMS=cpu python scripts/monitor_verdicts.py [--seeds 0-15] [--salted]

Builds the model that ``chip_smoke.py``'s monitor phase solves (BASELINE
config #3 as a fake metadata backend, six 1-second windows of
``SyntheticWorkloadSampler`` samples, capacities at which the mean broker
carries 40% of each resource) through the JAX package's monitor and the
port's, in this process, checks that the two freezes are equal bit for bit,
and runs each package's 15-goal default stack on its own freeze.  Prints
one JSON line per sampler seed: each package's outcome (``"ok"`` with the
goals left violated, or the ``OptimizationFailureError`` message), then a
summary line counting the outcomes.

The sampler's jitter hashes ``(topic, partition)`` with Python's ``hash``,
which is salted per process, so by default a CRC of the key takes its place
and every process draws the same loads; ``--salted`` keeps the salted hash
(set ``PYTHONHASHSEED`` to repeat a run).  CPU seconds, not device ones.
"""

import argparse
import dataclasses
import json
import os
import sys
import zlib
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def salt_free_jitter(key, seed):
    """``synthetic_jitter`` with a CRC of the key in place of Python's
    salted ``hash``."""
    rng = np.random.default_rng((zlib.crc32(repr(key).encode()) ^ seed) & 0x7FFFFFFF)
    return 0.8 + 0.4 * rng.random()


def use_salt_free_jitter(setattr_fn=setattr):
    """Install :func:`salt_free_jitter` in both packages' samplers (pass a
    pytest ``monkeypatch.setattr`` to have it undone)."""
    from cruise_control_tpu.monitor import sampler as jsampler
    from cruise_control_tpu_torch.monitor import sampler as tsampler
    for mod in (tsampler, jsampler):
        setattr_fn(mod, "synthetic_jitter", salt_free_jitter)


def label(outcome):
    """``"ok"``, or the goal named by the failure message."""
    return "ok" if "ok" in outcome else outcome["raised"][1:].split("]")[0]


def _outcome(optimize, failure):
    try:
        return {"ok": list(optimize().violated_goals_after)}
    except failure as e:
        return {"raised": str(e)}


def monitor_model_verdicts(sampler_seed=None):
    """Each package's default-stack outcome on the monitor phase's model
    (the sampler's default seed when ``sampler_seed`` is None), and whether
    the two monitors froze the same arrays."""
    import chip_smoke as smoke
    from cruise_control_tpu.analyzer.goals.registry import DEFAULT_GOALS as JDEFAULT_GOALS
    from cruise_control_tpu.analyzer.optimizer import GoalOptimizer as JOptimizer
    from cruise_control_tpu.common.exceptions import OptimizationFailureError as JFailure
    from cruise_control_tpu.common.resources import Resource as JResource
    from cruise_control_tpu.compilesvc.buckets import ShapeBucketPolicy as JBuckets
    from cruise_control_tpu.monitor import capacity as jcap
    from cruise_control_tpu.monitor import load_monitor as jlm
    from cruise_control_tpu.monitor import metadata as jmeta
    from cruise_control_tpu.monitor import sampler as jsampler
    from cruise_control_tpu.monitor import task_runner as jrunner
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.common.exceptions import OptimizationFailureError
    from cruise_control_tpu_torch.common.resources import Resource
    from cruise_control_tpu_torch.compilesvc.buckets import ShapeBucketPolicy
    from cruise_control_tpu_torch.model.builder import builder_from_snapshot
    from cruise_control_tpu_torch.model.state import state_to_numpy
    from cruise_control_tpu_torch.monitor import capacity as tcap
    from cruise_control_tpu_torch.monitor import load_monitor as tlm
    from cruise_control_tpu_torch.monitor import metadata as tmeta
    from cruise_control_tpu_torch.monitor import sampler as tsampler
    from cruise_control_tpu_torch.monitor import task_runner as trunner
    from cruise_control_tpu_torch.testing import random_cluster as trc

    st, pl, mt = trc.generate(trc.ClusterProperties(**smoke.BASELINE3), device="cpu")
    backend = smoke.metadata_backend(builder_from_snapshot(st, pl, mt))
    capacity = smoke.synthetic_capacity(tsampler.SyntheticWorkloadSampler(), mt.num_replicas,
                                        mt.num_partitions, mt.num_brokers)
    seed = {} if sampler_seed is None else {"seed": sampler_seed}
    out, packed = {}, []
    for name, meta, lm_mod, cap_mod, run_mod, samp_mod, buckets, res_of, opt, failure in (
            ("port", tmeta, tlm, tcap, trunner, tsampler, ShapeBucketPolicy, Resource,
             GoalOptimizer, OptimizationFailureError),
            ("jax", jmeta, jlm, jcap, jrunner, jsampler, JBuckets, JResource,
             lambda: JOptimizer(goal_names=JDEFAULT_GOALS), JFailure)):
        lm = lm_mod.LoadMonitor(
            meta.MetadataClient(meta.FakeMetadataBackend(
                [meta.BrokerInfo(**dataclasses.asdict(b)) for b in backend.brokers],
                [meta.PartitionInfo(**dataclasses.asdict(p)) for p in backend.partitions]),
                ttl_ms=0),
            capacity_resolver=cap_mod.FixedBrokerCapacityResolver(
                {res_of[r.name]: v for r, v in capacity.items()}),
            num_windows=smoke.MONITOR_WINDOWS, window_ms=smoke.MONITOR_WINDOW_MS,
            min_samples_per_window=1)
        run_mod.LoadMonitorTaskRunner(lm, samp_mod.SyntheticWorkloadSampler(**seed),
                                      sampling_interval_ms=smoke.MONITOR_WINDOW_MS).bootstrap(
            0, smoke.MONITOR_BOOTSTRAP_WINDOWS * smoke.MONITOR_WINDOW_MS)
        if name == "port":
            s, p, m = lm.cluster_model(pad_fn=buckets().pad_targets, device="cpu")
            packed.append(state_to_numpy(s, p))
        else:
            s, p, m = lm.cluster_model(pad_fn=buckets().pad_targets)
            arrays = {k: np.asarray(getattr(s, k)) for k in packed[0] if hasattr(s, k)}
            arrays.update(assignment=np.asarray(p.broker), disk=np.asarray(p.disk),
                          is_leader=np.asarray(p.is_leader))
            packed.append(arrays)
        out[name] = _outcome(
            lambda: opt().optimizations(s, p, m, model_generation=lm.model_generation),
            failure)
    a, b = packed
    out["freezes_equal"] = sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in b)
    return out


def _seeds(text):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0-15", help="sampler seeds, N or N-M")
    ap.add_argument("--salted", action="store_true",
                    help="keep the sampler's salted hash (set PYTHONHASHSEED)")
    args = ap.parse_args()
    from cruise_control_tpu.utils.hermetic import force_cpu
    force_cpu(n_devices=1)
    if not args.salted:
        use_salt_free_jitter()
    tally = Counter()
    for seed in _seeds(args.seeds):
        res = monitor_model_verdicts(seed)
        res["sampler_seed"] = seed
        print(json.dumps(res), flush=True)
        tally[f"port {label(res['port'])} / jax {label(res['jax'])}"] += 1
    print(json.dumps({"outcomes_port_jax": dict(tally),
                      "hash": "salted" if args.salted else "crc",
                      "PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED")}))


if __name__ == "__main__":
    main()
