"""The aggregate kernel's launch plan (``ops/aggregate.launch_plan``), a pure
function of the shape and the card: the rules that keep every launch
within the card's limits and every broker written exactly once.  The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import itertools

import pytest

from cruise_control_tpu_torch.ops import aggregate
from cruise_control_tpu_torch.ops.aggregate import launch_plan

H100_SMS = 132
SHAPES = list(itertools.product(
    (0, 1, 1613, 50_000, 1_000_000),     # rows
    (1, 4, 8, 13, 64),                   # channels
    (1, 37, 200, 2600, 8192, 60_000)))   # brokers


def owned_brokers(plan, num_segments):
    """``[lo, hi)`` of the brokers each tile writes to out, as the kernel
    computes them (``blockIdx.y * slice``)."""
    out = []
    for t in range(plan.tiles):
        lo = min(t * plan.broker_slice, num_segments)
        out.append((lo, min(lo + plan.broker_slice, num_segments)))
    return out


def _check(plan, r, k, b, num_sms=H100_SMS, resident=None):
    assert plan.smem_bytes <= aggregate.SMEM_PER_BLOCK
    assert plan.threads % 32 == 0 and plan.threads <= aggregate.MAX_THREADS
    assert plan.vector == (k % 4 == 0)
    if plan.mode == aggregate.GLOBAL:
        assert (plan.tiles, plan.smem_bytes) == (1, 0)
    elif plan.grid:
        assert plan.mode == aggregate.BLOCK
        assert plan.smem_bytes == plan.broker_slice * aggregate.acc_stride(k) * 4
    # Every broker in [0, B) is owned by exactly one tile.
    owned = sorted(owned_brokers(plan, b))
    assert owned[0][0] == 0 and owned[-1][1] == b
    for (lo0, hi0), (lo1, hi1) in zip(owned, owned[1:]):
        assert lo0 <= hi0 == lo1 <= hi1
    assert sum(hi - lo for lo, hi in owned) == b
    assert plan.tiles == 1 or (plan.tiles - 1) * plan.broker_slice < b
    assert plan.grid == 0 if r == 0 else plan.grid >= 1
    # The launch is cooperative: every block resident at once.
    fit = (resident(plan.mode, plan.threads, plan.broker_slice) if resident else
           aggregate.modeled_resident(num_sms, plan.threads, plan.smem_bytes))
    assert plan.grid * plan.tiles <= fit


@pytest.mark.parametrize("r,k,b", SHAPES)
def test_plan_within_limits_and_covers_brokers_once(r, k, b):
    _check(launch_plan(r, k, b, H100_SMS), r, k, b)


@pytest.mark.parametrize("num_sms", (132, 114, 66, 16))
@pytest.mark.parametrize("mode", (aggregate.BLOCK, aggregate.GLOBAL))
@pytest.mark.parametrize("r,k,b", [(1_000_000, 8, 2600), (1_000_000, 8, 8192),
                                   (48_723, 8, 200), (50_000, 13, 200), (200_000, 64, 8192)])
def test_forced_variants_stay_valid(r, k, b, mode, num_sms, monkeypatch):
    """Either variant, forced through the row threshold, on cards of other
    sizes (an H100 PCIe has 114 SMs) and with few blocks resident."""
    monkeypatch.setattr(aggregate, "GLOBAL_MAX_ROWS", -1 if mode == aggregate.BLOCK else r)
    plan = launch_plan(r, k, b, num_sms)
    assert plan.mode == mode
    _check(plan, r, k, b, num_sms)
    few = lambda mode, threads, broker_slice: 7 * plan.tiles  # noqa: E731
    small = launch_plan(r, k, b, num_sms, resident=few)
    assert small.grid == min(7, plan.grid)
    _check(small, r, k, b, num_sms, resident=few)


def test_north_star_brokers_read_channels_once():
    """1M rows onto 2,600 brokers: one block holds the broker axis; 8,192
    brokers take two broker tiles, each loading only its own rows'
    channels (so channels are still read once)."""
    plan = launch_plan(1_000_000, 8, 2600, H100_SMS)
    assert (plan.mode, plan.tiles) == (aggregate.BLOCK, 1)
    plan = launch_plan(1_000_000, 8, 8192, H100_SMS)
    assert (plan.mode, plan.tiles) == (aggregate.BLOCK, 2)
    assert plan.tiles * plan.broker_slice >= 8192


def test_broker_axis_beyond_a_block_is_tiled():
    plan = launch_plan(200_000, 64, 8192, H100_SMS)
    assert plan.tiles > 1 and plan.broker_slice * aggregate.acc_stride(64) * 4 \
        <= aggregate.SMEM_PER_BLOCK
    plan = launch_plan(1_000_000, 8, 60_000, H100_SMS)
    assert plan.tiles == 10 and plan.tiles * plan.broker_slice >= 60_000


def test_threads_and_grid_follow_the_rows():
    """About one row per thread on one block per SM; small inputs go
    straight into out, on few blocks."""
    small = launch_plan(1613, 8, 37, H100_SMS)
    assert (small.mode, small.grid) == (aggregate.GLOBAL, 7)
    edge = aggregate.GLOBAL_MAX_ROWS
    assert launch_plan(edge, 8, 200, H100_SMS).mode == aggregate.GLOBAL
    assert launch_plan(edge + 1, 8, 200, H100_SMS).mode == aggregate.BLOCK
    main = launch_plan(48_723, 8, 200, H100_SMS)
    assert (main.mode, main.threads, main.grid) == (aggregate.BLOCK, 512, 96)
    big = launch_plan(1_000_000, 8, 2600, H100_SMS)
    assert (big.threads, big.grid) == (1024, H100_SMS)


def test_grid_follows_occupancy():
    plan = launch_plan(1_000_000, 8, 8192, H100_SMS,
                       resident=lambda mode, threads, sl: 40)
    assert plan.grid == 40 // plan.tiles
    plan = launch_plan(1_000_000, 8, 2600, 66)
    assert plan.grid <= 66


def test_channels_over_budget_raise():
    with pytest.raises(ValueError):
        launch_plan(10, aggregate.SMEM_PER_BLOCK // 4, 4, H100_SMS)
