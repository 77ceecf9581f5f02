"""The aggregate recompute of the port against the JAX package.

``broker_channel_sums``: the port's CPU path (its plain version) against the
JAX wrapper in Pallas interpret mode, at the shapes of tests/test_ops.py.
Floats use rtol=1e-6, atol=1e-4 (test_ops.py's bar: both sum the same f32
values in another order); count channels must be exact.  The CUDA kernel
itself is held against the plain version on the card in test_torch_cuda.py.

``compute_aggregates``: all nine Aggregates fields on the same packed state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.constraint import BalancingConstraint as JConstraint
from cruise_control_tpu.analyzer.context import build_context as jbuild
from cruise_control_tpu.analyzer.context import compute_aggregates as jaggregates
from cruise_control_tpu.analyzer.options import OptimizationOptions as JOptions
from cruise_control_tpu.model.state import device_put_state
from cruise_control_tpu.ops import broker_channel_sums as jsums
from cruise_control_tpu.ops.pallas_aggregate import CHUNK
from cruise_control_tpu.testing import deterministic as det
from cruise_control_tpu.testing import random_cluster as jrc
from cruise_control_tpu_torch.analyzer.constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.context import build_context, compute_aggregates
from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
from cruise_control_tpu_torch.model.state import state_from_packed
from cruise_control_tpu_torch.ops import aggregate

TOL = dict(rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("r,k,b", [
    (256, 8, 16),
    (CHUNK, 8, 128),
    (3 * CHUNK + 77, 8, 37),
    (2048, 4, 200),
])
def test_plain_matches_jax_kernel(r, k, b):
    rng = np.random.default_rng(r + k + b)
    ch = rng.normal(size=(r, k)).astype(np.float32)
    br = rng.integers(0, b, size=r).astype(np.int32)
    want = np.asarray(jsums(jnp.asarray(ch), jnp.asarray(br), b, interpret=True))
    got = aggregate.broker_channel_sums(torch.from_numpy(ch), torch.from_numpy(br), b)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_padded_rows_do_not_perturb_broker_zero():
    rng = np.random.default_rng(7)
    r, k, b, valid_n = 1024, 8, 64, 700
    ch = rng.normal(size=(r, k)).astype(np.float32)
    br = rng.integers(0, b, size=r).astype(np.int32)
    ch[valid_n:] = 0.0
    br[valid_n:] = 0
    want = np.asarray(jsums(jnp.asarray(ch), jnp.asarray(br), b, interpret=True))
    got = aggregate.broker_channel_sums(torch.from_numpy(ch), torch.from_numpy(br), b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_out_of_range_rows_are_skipped():
    """Rows pointing outside [0, B) add nothing (the TPU kernel's -1 tail,
    segment_sum's dropped ids)."""
    rng = np.random.default_rng(9)
    r, k, b = 1613, 8, 37
    ch = rng.normal(size=(r, k)).astype(np.float32)
    br = rng.integers(-3, b + 3, size=r).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(ch), jnp.asarray(br),
                                          num_segments=b))
    got = aggregate.broker_channel_sums(torch.from_numpy(ch), torch.from_numpy(br), b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_counts_channel_exact():
    r, b = 4 * CHUNK, 333
    br = np.random.default_rng(3).integers(0, b, size=r).astype(np.int32)
    ones = np.ones((r, 1), np.float32)
    want = np.asarray(jsums(jnp.asarray(ones), jnp.asarray(br), b, interpret=True))
    got = aggregate.broker_channel_sums(torch.from_numpy(ones), torch.from_numpy(br), b)
    assert (got.numpy() == want).all()


def test_cpu_path_launches_no_kernel():
    before = aggregate.LAUNCHES
    aggregate.broker_channel_sums(torch.ones(10, 8), torch.zeros(10, dtype=torch.int32), 4)
    assert aggregate.LAUNCHES == before


def test_launch_shape_tiles_large_broker_axis():
    """A broker axis that one block holds takes one tile; a larger one is
    tiled so that each tile's accumulator fits in shared memory."""
    plan = aggregate.launch_plan(50_000, 8, 200, 132)
    assert (plan.tiles, plan.broker_slice) == (1, 200)
    plan = aggregate.launch_plan(1_000_000, 8, 8192, 132)
    assert plan.tiles == 2 and plan.tiles * plan.broker_slice >= 8192
    assert plan.smem_bytes <= aggregate.SMEM_PER_BLOCK
    plan = aggregate.launch_plan(200_000, 64, 8192, 132)
    assert plan.tiles > 2 and plan.tiles * plan.broker_slice >= 8192


PROPS = dict(num_brokers=20, num_racks=5, num_topics=40, num_replicas=2000,
             mean_cpu=0.02, mean_disk=2300.0, mean_nw_in=2300.0,
             mean_nw_out=5000.0, seed=5)


def _fixture_packed(name):
    if name == "random":
        js, jp, meta = jrc.generate(jrc.ClusterProperties(**PROPS), 64, 8)
        packed = {k: np.asarray(getattr(js, k)) for k in js.__dataclass_fields__}
        packed.update(assignment=np.asarray(jp.broker), disk=np.asarray(jp.disk),
                      is_leader=np.asarray(jp.is_leader))
        return packed, meta
    return det.unbalanced().freeze_packed(pad_replicas_to=16, pad_brokers_to=4)


@pytest.mark.parametrize("fixture", ["random", "deterministic"])
def test_compute_aggregates_matches_jax(fixture):
    packed, meta = _fixture_packed(fixture)
    js, jp = device_put_state(packed)
    want = jaggregates(jbuild(js, jp, meta, JConstraint(), JOptions()), jp)
    ts, tp = state_from_packed(packed, device="cpu")
    got = compute_aggregates(build_context(ts, tp, meta, BalancingConstraint(),
                                           OptimizationOptions()), tp)
    for name in ("replica_counts", "leader_counts", "topic_counts",
                 "topic_leader_counts"):
        g = getattr(got, name)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("broker_load", "host_load", "disk_load", "potential_nw_out",
                 "leader_bytes_in"):
        g = getattr(got, name)
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)
