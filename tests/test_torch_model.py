"""The port's tensor model against the JAX package: packed-state round trip,
the random cluster generator, the NPZ codec, and cluster stats.

Integer and boolean arrays must match exactly.  Float stats use
rtol=1e-6, atol=1e-4: both packages sum the same f32 loads, in another order.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu.model import snapshot as jsnap
from cruise_control_tpu.model.state import device_put_state
from cruise_control_tpu.model.state import pack_state_arrays as jpack
from cruise_control_tpu.model.stats import compute_stats as jstats
from cruise_control_tpu.testing import deterministic as det
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.model import snapshot as tsnap
from cruise_control_tpu_torch.model.state import (
    pack_state_arrays,
    state_from_packed,
    state_to_numpy,
)
from cruise_control_tpu_torch.model.stats import compute_stats
from cruise_control_tpu_torch.testing import random_cluster as trc

PROPS = dict(num_brokers=20, num_racks=5, num_topics=40, num_replicas=2000,
             mean_cpu=0.02, mean_disk=2300.0, mean_nw_in=2300.0,
             mean_nw_out=5000.0, seed=5)

STATE_KEYS = ("leader_load", "follower_load", "partition", "topic", "pos",
              "orig_broker", "offline", "valid", "capacity", "host", "rack",
              "alive", "new_broker", "broker_valid", "disk_capacity", "disk_alive")


def _jax_packed(state, placement):
    out = {k: np.asarray(getattr(state, k)) for k in STATE_KEYS}
    out["assignment"] = np.asarray(placement.broker)
    out["disk"] = np.asarray(placement.disk)
    out["is_leader"] = np.asarray(placement.is_leader)
    return out


def _assert_same_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_packed_round_trip_keeps_arrays_and_dtypes():
    packed, _ = det.unbalanced().freeze_packed(pad_replicas_to=16, pad_brokers_to=4)
    state, placement = state_from_packed(packed, device="cpu")
    assert state.leader_load.dtype == torch.float32
    assert state.partition.dtype == torch.int32
    assert placement.is_leader.dtype == torch.bool
    _assert_same_arrays(state_to_numpy(state, placement), packed)


@pytest.mark.parametrize("pads", [(1, 1), (64, 8)])
def test_random_cluster_bit_identical(pads):
    js, jp, jm = jrc.generate(jrc.ClusterProperties(**PROPS), *pads)
    ts, tp, tm = trc.generate(trc.ClusterProperties(**PROPS), *pads, device="cpu")
    _assert_same_arrays(state_to_numpy(ts, tp), _jax_packed(js, jp))
    assert (tm.broker_ids, tm.topics, tm.partitions, tm.racks, tm.hosts,
            tm.num_replicas, tm.num_brokers) == (
        jm.broker_ids, jm.topics, jm.partitions, jm.racks, jm.hosts,
        jm.num_replicas, jm.num_brokers)


def test_load_npz_reads_jax_written_file(tmp_path):
    js, jp, jm = jrc.generate(jrc.ClusterProperties(**PROPS), 64, 8)
    path = str(tmp_path / "snap.npz")
    jsnap.save_npz(path, js, jp, jm)
    ts, tp, tm = tsnap.load_npz(path, device="cpu")
    # load_npz trims padding in both packages.
    js2, jp2, jm2 = jsnap.load_npz(path)
    _assert_same_arrays(state_to_numpy(ts, tp), _jax_packed(js2, jp2))
    assert tm.partitions == jm2.partitions and tm.topics == jm2.topics


def test_jax_reads_port_written_file(tmp_path):
    ts, tp, tm = trc.generate(trc.ClusterProperties(**PROPS), device="cpu")
    path = str(tmp_path / "snap.npz")
    tsnap.save_npz(path, ts, tp, tm)
    js, jp, jm = jsnap.load_npz(path)
    _assert_same_arrays(_jax_packed(js, jp), state_to_numpy(ts, tp))
    assert jm.broker_ids == tm.broker_ids


def test_pack_state_arrays_matches_jax():
    packed, _ = det.unbalanced4().freeze_packed()
    arrays = dict(packed)
    arrays.pop("valid")
    arrays.pop("broker_valid")
    _assert_same_arrays(pack_state_arrays(arrays, 32, 8), jpack(arrays, 32, 8))


@pytest.mark.parametrize("fixture", ["random", "deterministic"])
def test_compute_stats_matches_jax(fixture):
    if fixture == "random":
        js, jp, _ = jrc.generate(jrc.ClusterProperties(**PROPS), 64, 8)
        packed = _jax_packed(js, jp)
    else:
        packed, _ = det.unbalanced().freeze_packed(pad_replicas_to=16, pad_brokers_to=4)
        js, jp = device_put_state(packed)
    ts, tp = state_from_packed(packed, device="cpu")
    want = jstats(js, jp)
    got = compute_stats(ts, tp)
    for name in ("avg_util", "max_util", "min_util", "std_util"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-6, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(got.num_balanced_brokers, want.num_balanced_brokers)
    for name in ("max_replicas", "min_replicas", "num_brokers", "num_replicas",
                 "num_leaders"):
        assert getattr(got, name) == getattr(want, name), name
    np.testing.assert_allclose([got.avg_replicas, got.std_replicas],
                               [want.avg_replicas, want.std_replicas],
                               rtol=1e-6, atol=1e-4)
