"""The port on the card: the CUDA kernel against its plain version, and the
propose path launching it.  Imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test here needs a CUDA GPU and nvcc (the kernel has no CPU mode) and
skips without one.  Floats use rtol=1e-6, atol=1e-4 on normal-distributed
channels (tests/test_ops.py's bar: the same f32 values summed in another
order); count channels must be exact.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.ops import aggregate

TOL = dict(rtol=1e-6, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,b", [(1613, 8, 37), (50_000, 8, 200), (200_000, 8, 8192)])
def test_kernel_matches_plain(cuda, r, k, b):
    rng = np.random.default_rng(r)
    ch = torch.from_numpy(rng.normal(size=(r, k)).astype(np.float32)).to(cuda)
    ch[:, 4] = 1.0
    br = torch.from_numpy(rng.integers(-2, b + 2, size=r).astype(np.int32)).to(cuda)
    before = aggregate.LAUNCHES
    got = aggregate.broker_channel_sums(ch, br, b)
    want = aggregate.broker_channel_sums_plain(ch, br, b)
    torch.cuda.synchronize()
    assert aggregate.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got[:, 4], want[:, 4])


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    ch = torch.ones(64, 8, device=cuda)
    br = torch.zeros(64, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        aggregate.broker_channel_sums(ch.double(), br, 4)
    with pytest.raises(TypeError):
        aggregate.broker_channel_sums(ch, br.long(), 4)
    with pytest.raises(ValueError):
        aggregate.broker_channel_sums(ch.t(), br[:8], 4)


@pytest.mark.cuda
def test_propose_path_launches_kernel(cuda):
    from cruise_control_tpu_torch.analyzer.optimizer import GoalOptimizer
    from cruise_control_tpu_torch.testing import random_cluster as rc

    props = rc.ClusterProperties(num_brokers=20, num_racks=5, num_topics=50,
                                 num_replicas=2000, mean_cpu=0.005, mean_disk=2100.0,
                                 mean_nw_in=2000.0, mean_nw_out=2000.0, seed=11)
    state, placement, meta = rc.generate(props, device=cuda)
    aggregate.LAUNCHES = 0
    res = GoalOptimizer().optimizations(state, placement, meta)
    assert aggregate.LAUNCHES > 0
    assert res.final_placement.broker.is_cuda
    assert res.proposals
