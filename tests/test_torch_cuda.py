"""The port on the card: the CUDA kernel against its plain version, and the
propose path launching it.  Imports no JAX, so it runs where the port runs:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test here needs a CUDA GPU and nvcc (the kernel has no CPU mode) and
skips without one.  Floats use rtol=1e-6, atol=1e-4 on normal-distributed
channels (tests/test_ops.py's bar: the same f32 values summed in another
order) and lie within min(n - 1, 4 sqrt(n)) * 2^-24 * sum |x| of the
float64 sum (chip_smoke.py's zero-mean bar); count channels must be exact.
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


def _inputs(r, k, b, kind, device):
    """Normal channels (channel 4 a count when K > 4) and brokers in [-2,
    B + 2); "skewed" puts half of the rows on 26 brokers, "offset" passes
    channels as a contiguous view 4 bytes into its storage."""
    rng = np.random.default_rng(r)
    pad = 1 if kind == "offset" else 0
    flat = torch.from_numpy(rng.normal(size=r * k + pad).astype(np.float32)).to(device)
    ch = flat[pad:].view(r, k)
    if k > 4:
        ch[:, 4] = 1.0
    br = rng.integers(-2, b + 2, size=r).astype(np.int32)
    if kind == "skewed":
        hot = rng.random(r) < 0.5
        br[hot] = rng.integers(0, 26, size=int(hot.sum()))
    return ch, torch.from_numpy(br).to(device)


def _holds(got, ch, br, b, kind):
    """Counts exact; within min(n - 1, 4 sqrt(n)) * 2^-24 * sum |x| of the
    float64 sum (the worst-case rounding of an n-term sum where n is small,
    four times the typical one of a zero-mean sum where it is large; a lost
    row of a hot broker moves its sum by far more); and the rtol/atol bar
    against the plain version, except for skewed brokers (~19K rows a sum,
    where the plain version's own f32 rounding exceeds that bar)."""
    want = aggregate.broker_channel_sums_plain(ch, br, b)
    if ch.shape[1] > 4:
        assert torch.equal(got[:, 4], want[:, 4])
    if kind != "skewed":
        torch.testing.assert_close(got, want, **TOL)
    want64 = aggregate.broker_channel_sums_plain(ch.double(), br, b)
    n = aggregate.broker_channel_sums_plain(
        torch.ones(ch.shape[0], 1, dtype=torch.float64, device=ch.device), br, b)
    mag = aggregate.broker_channel_sums_plain(ch.double().abs(), br, b)
    bar = torch.minimum((n - 1).clamp(min=0), 4 * n.sqrt()) * 2.0 ** -24 * mag
    assert ((got.double() - want64).abs() <= bar + 1e-9).all()


@pytest.mark.cuda
@pytest.mark.parametrize("r,k,b,kind", [
    (1613, 8, 37, "uniform"), (50_000, 8, 200, "uniform"), (200_000, 8, 8192, "uniform"),
    (1_000_000, 8, 2600, "skewed"), (50_000, 4, 200, "uniform"), (50_000, 13, 200, "offset"),
    (50_000, 8, 200, "offset"), (0, 8, 200, "uniform"), (200_000, 64, 8192, "uniform")])
def test_kernel_matches_plain(cuda, r, k, b, kind):
    ch, br = _inputs(r, k, b, kind, cuda)
    before = aggregate.LAUNCHES
    got = aggregate.broker_channel_sums(ch, br, b)
    torch.cuda.synchronize()
    assert aggregate.LAUNCHES == before + (1 if r else 0)
    _holds(got, ch, br, b, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [aggregate.BLOCK, aggregate.GLOBAL], ids=["BLOCK", "GLOBAL"])
@pytest.mark.parametrize("r,k,b", [(2_000, 8, 200), (50_000, 8, 200), (100_000, 8, 8192),
                                   (50_000, 13, 300)])
def test_every_variant_matches_plain(cuda, r, k, b, mode, monkeypatch):
    """Either variant, forced through the row threshold, writes every
    broker (out comes from torch.empty: nothing is left unwritten)."""
    monkeypatch.setattr(aggregate, "GLOBAL_MAX_ROWS", -1 if mode == aggregate.BLOCK else r)
    monkeypatch.setattr(aggregate, "_plans", {})
    ch, br = _inputs(r, k, b, "uniform", cuda)
    assert aggregate.plan_for(r, k, b, ch.device).mode == mode
    torch.full((b, k), float("nan"), device=cuda)  # freed at once: out may reuse it
    got = aggregate.broker_channel_sums(ch, br, b)
    torch.cuda.synchronize()
    _holds(got, ch, br, b, "uniform")


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
